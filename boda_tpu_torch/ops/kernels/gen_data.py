"""Deterministic test-pattern generation on the device.

Counterpart of ``boda_tpu/ops/kernels/gen_data.py:gen_data_pattern``, with
bit-identical values: v[flat_i] = ((flat_i * stride + offset) mod mod - sub)
* mul, in int32 then float32 arithmetic, cast to the dims type at the end.
"""

from __future__ import annotations

import torch

from ...utils.dims import torch_dtype


def gen_data_pattern(dims_shape, tn: str, mod: int = 13, sub: float = 6.0,
                     mul: float = 0.1, stride: int = 7, offset: int = 0,
                     device="cpu") -> torch.Tensor:
    n = 1
    for s in dims_shape:
        n *= s
    flat = torch.arange(n, dtype=torch.int32, device=device)
    v = torch.remainder(flat * stride + offset, mod).to(torch.float32)
    # float32 scalars as tensors, so the arithmetic is f32 like jnp.float32
    v = (v - torch.tensor(sub, dtype=torch.float32, device=device)) * \
        torch.tensor(mul, dtype=torch.float32, device=device)
    return v.reshape(tuple(dims_shape)).to(torch_dtype(tn))
