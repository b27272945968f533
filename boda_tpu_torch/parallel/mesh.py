"""Device meshes for multi-device execution.

Counterpart of ``boda_tpu/parallel/mesh.py``. boda_tpu hands a
``jax.sharding.Mesh`` and ``PartitionSpec``s to XLA, which places the shards
and inserts the collectives. The port has no such compiler: a :class:`Mesh`
is the axis names, their sizes and an array of ``torch.device``, and the
engine (graph/executor.py) and the training step (parallel/train.py) place
and combine the shards themselves. The axes are boda_tpu's:

  * dp: data parallel over the img (batch) dim;
  * tp: tensor parallel over out_chan of conv/fc weights;
  * sp: spatial parallel over activation rows (y).

:func:`weight_shardings` and :func:`input_shardings` apply boda_tpu's rules
and return, for each weight or input, a spec: per dim, the mesh axis that
splits it, or None (the entries of boda_tpu's ``PartitionSpec``).

The devices of a mesh may repeat: an n-way mesh on one card (or on the CPU)
places several shards on the same device, and computes what the n-device
mesh computes.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch


class MeshError(ValueError):
    """Invalid mesh request (axis sizes vs available devices)."""


class Mesh:
    """Axis names and sizes over an array of ``torch.device`` of that shape."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise MeshError(f"mesh of {devices.ndim} dims needs as many axis names, "
                            f"got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def size(self, axis: str) -> int:
        """The axis's size; 1 for an axis the mesh does not have."""
        return self.shape.get(axis, 1)

    def device(self, **index: int) -> torch.device:
        """The device at the given axis indices (0 along the others)."""
        return self.devices[tuple(index.get(a, 0) for a in self.axis_names)]

    def __repr__(self) -> str:
        axes = ",".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh(({axes}), {[str(d) for d in self.devices.flat]})"


def cpu_device_count() -> int:
    """The logical CPU devices: ``--xla_force_host_platform_device_count`` in
    ``XLA_FLAGS`` (the knob that sizes boda_tpu's virtual devices, read here
    only as a count), else 1."""
    m = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    return int(m.group(1)) if m else 1


def local_devices(kind: str = "cuda") -> list[torch.device]:
    """The local devices of a kind: every card for ``cuda``, the logical
    CPU devices (:func:`cpu_device_count`) for ``cpu``."""
    if kind == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")] * cpu_device_count()
    raise MeshError(f"mesh: no devices of kind {kind!r} (cuda | cpu)")


def make_mesh(axis_sizes: dict[str, int], devices=None, kind: str = "cuda") -> Mesh:
    """A mesh of the given axis sizes over the first devices of ``devices``
    (default: :func:`local_devices` of ``kind``). A device may be listed more
    than once."""
    devices = list(devices) if devices is not None else local_devices(kind)
    n = 1
    for ax, s in axis_sizes.items():
        if not isinstance(s, int) or s < 1:
            raise MeshError(f"mesh axis {ax!r} size must be a positive int, "
                            f"got {s!r}")
        n *= s
    if n > len(devices):
        raise MeshError(f"mesh needs {n} devices, have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(arr.reshape(tuple(axis_sizes.values())), tuple(axis_sizes))


def weight_shardings(pipe, mesh: Mesh, tp_axis: str = "tp") -> dict[str, tuple]:
    """Per weight, its spec: out_chan split over tp where tp divides it and
    the weight has more than one dim; every other dim, and every other
    weight, whole (replicated)."""
    tp = mesh.size(tp_axis)
    out = {}
    for name, w in pipe.weights.items():
        spec = [None] * len(w.dims)
        if tp > 1 and "out_chan" in w.dims.names:
            i = w.dims.index("out_chan")
            if w.dims["out_chan"] % tp == 0 and len(w.dims) > 1:
                spec[i] = tp_axis
        out[name] = tuple(spec)
    return out


def input_shardings(in_dims: dict, mesh: Mesh, dp_axis: str = "dp",
                    sp_axis: Optional[str] = None) -> dict[str, tuple]:
    """Per input, its spec: img split over dp (and y over sp, if given)
    where the axis divides it."""
    out = {}
    for name, d in in_dims.items():
        spec = [None] * len(d)
        if dp_axis in mesh.axis_names and "img" in d.names and \
                d["img"] % mesh.shape[dp_axis] == 0:
            spec[d.index("img")] = dp_axis
        if sp_axis and sp_axis in mesh.axis_names and "y" in d.names and \
                d["y"] % mesh.shape[sp_axis] == 0:
            spec[d.index("y")] = sp_axis
        out[name] = tuple(spec)
    return out
