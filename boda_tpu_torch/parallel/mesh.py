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

Under tp a split tensor is a :class:`Shards`: one part per device of a tp
row, each an allocation of its own. :func:`shard_weights` and
:func:`gather_weights` are the counterparts of ``jax.device_put`` with a
weight's sharding and of ``np.asarray`` of a sharded array;
:func:`tp_call` runs one conv or fc over a tp row, for the engine and the
training step alike.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Optional

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


class Shards(list):
    """A tensor split into equal parts along ``axis``, one per device of a
    tp row, in the row's order."""

    def __init__(self, parts, axis: int):
        super().__init__(parts)
        self.axis = axis

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: the first part's)."""
        dev = device if device is not None else self[0].device
        return torch.cat([p.to(dev) for p in self], dim=self.axis)

    def map(self, fn: Callable, axis: int) -> "Shards":
        """``fn`` of each part, split along ``axis`` of the results."""
        return Shards([fn(p) for p in self], axis)


def own_copy(t: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy of ``t`` on ``dev`` in an allocation of its own
    (a narrowed view keeps its parent's offset, and with it loses the
    16-byte alignment the kernels' vector paths want)."""
    return t.to(dev, copy=True, memory_format=torch.contiguous_format)


def split_tensor(t: torch.Tensor, axis: int, devs: list) -> Shards:
    """``t`` cut into ``len(devs)`` equal parts along ``axis``, part j on
    devs[j]."""
    k = t.shape[axis] // len(devs)
    return Shards([own_copy(t.narrow(axis, j * k, k), d) for j, d in enumerate(devs)], axis)


def tp_row(mesh: Mesh, dp: int = 0) -> list:
    """The devices along tp of dp slice ``dp``; its first is the lead."""
    return [mesh.device(dp=dp, tp=j) for j in range(mesh.size("tp"))]


def train_row(mesh: Mesh, world: int = 1, rank: int = 0) -> list:
    """The tp row that training rank ``rank`` of ``world`` steps on: the
    training step splits the batch over dp, one rank per dp slice, and
    out_chan over tp."""
    other = [a for a in mesh.axis_names if a not in ("dp", "tp")]
    if other:
        raise MeshError(f"mesh axes {other}: the training step splits over dp and tp only")
    if mesh.size("dp") != world:
        raise MeshError(f"mesh dp={mesh.size('dp')} needs as many ranks in the process "
                        f"group, have {world}")
    rows = [tp_row(mesh, i) for i in range(world)]
    # the ranks bucket their gradients by device: their rows must repeat
    # devices alike
    if len({tuple(r.index(d) for d in r) for r in rows}) > 1:
        raise MeshError(f"{mesh}: the tp rows repeat devices differently")
    return rows[rank]


def shard_weights(weights: dict, pipe, mesh: Mesh, dp: int = 0) -> dict:
    """The weights on dp slice ``dp``'s tp row: each weight that
    :func:`weight_shardings` splits as :class:`Shards` over the row, every
    other whole on the row's lead. A weight given as Shards is gathered
    first; a dict of some weights (a momentum state) takes the same form."""
    row = tp_row(mesh, dp)
    spec = weight_shardings(pipe, mesh)
    out = {}
    for k, v in weights.items():
        t = v.gather(row[0]) if isinstance(v, Shards) else v
        s = spec.get(k, ())
        out[k] = split_tensor(t, s.index("tp"), row) if "tp" in s else t.to(row[0])
    return out


def gather_weights(weights: dict, device=None) -> dict:
    """The logical tensors: each :class:`Shards` gathered on ``device``
    (default: its first part's), every other tensor moved there."""
    return {k: v.gather(device) if isinstance(v, Shards)
            else (v.to(device) if device is not None else v) for k, v in weights.items()}


def tp_call(fn: Callable, vals: list, devs: list, out_dim: int = -1) -> tuple:
    """One conv or fc op over a tp row (boda_tpu: the GSPMD path,
    executor.py:251-273). ``vals``: the op's operands, its input first,
    its filters second as :class:`Shards`. Each device computes its
    out_chan slice: the input moved there, every Shards operand's part,
    every other operand whose last dim is out_chan (a bias, a residual,
    unfolded BN/Scale parameters) cut to the slice's channels in a tensor
    of its own; the slices are concatenated along ``out_dim`` (NHWC's
    channels by default, 1 for the logical layout's) on the input's device,
    where the next op runs. Autograd runs it backward: the concatenation cuts
    the cotangent per slice, each slice's input gradient comes back to the
    input's device and sums there, and each part's gradient stays on its
    device."""
    w = vals[1]
    k = w[0].shape[w.axis]
    full = k * len(devs)
    pieces = []
    for j, dev in enumerate(devs):
        args = [vals[0].to(dev)]
        for v in vals[1:]:
            if isinstance(v, Shards):
                args.append(v[j])
            elif v.dim() >= 1 and v.shape[-1] == full:
                args.append(own_copy(v.narrow(-1, j * k, k), dev))
            else:
                args.append(v.to(dev))
        pieces.append(fn(*args))
    lead = vals[0].device
    return tuple(torch.cat([p[i].to(lead) for p in pieces], dim=out_dim)
                 for i in range(len(pieces[0])))
