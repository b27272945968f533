"""Carry parameters from another build of the same net into a port pipe.

``weights_from_numpy(pipe, {name: ndarray})`` installs logical-layout
parameters (conv filters OIHW, fc weights (out, in), biases and BN/Scale
vectors), as ``boda_tpu`` holds them in ``pipe.weights[k].data``, so that
both packages compute with the same numbers whatever their zoos do. It takes
every weight of the pipe, no more, and raises on any name, shape or dtype
mismatch.
"""

from __future__ import annotations

import numpy as np

from ..graph.pipe import ConvPipe, PipeError
from .dims import NDA, np_dtype


def weights_from_numpy(pipe: ConvPipe, arrays: dict) -> None:
    want, have = set(pipe.weights), set(arrays)
    if want != have:
        raise PipeError(f"weights_from_numpy: missing {sorted(want - have)}, "
                        f"unknown {sorted(have - want)}")
    new = {}
    for name, a in arrays.items():
        d = pipe.weights[name].dims
        a = np.asarray(a)
        if tuple(a.shape) != d.shape:
            raise PipeError(f"weights_from_numpy: {name!r} has shape "
                            f"{tuple(a.shape)}, the pipe wants {d.shape}")
        if a.dtype != np_dtype(d.tn):
            raise PipeError(f"weights_from_numpy: {name!r} has dtype {a.dtype}, "
                            f"the pipe wants {np_dtype(d.tn)} ({d.tn})")
        new[name] = NDA(d, a.copy())
    pipe.weights.update(new)
