"""Deterministic test-pattern generation on the device.

Counterpart of ``boda_tpu/ops/kernels/gen_data.py``, with bit-identical
values: v[flat_i] = ((flat_i * stride + offset) mod mod - sub) * mul, in
int32 then float32 arithmetic, cast to the dims type at the end. Every step
is an exact int32 op or one IEEE f32 op, so the card and the CPU give the
same bits. ``gen_data`` is the rtc generator: inputs for per-op profiling
and digest tests are made on the device, with no host RNG.

Op signature: (type=gen_data,out=(<dims>),mod=..,sub=..,mul=..,stride=..,offset=..)
"""

from __future__ import annotations

import torch

from ...rtc.compute import FuncInfo
from ...utils.dims import torch_dtype
from ..op_base import Op
from ..registry import GenCtx, kernel_gen
from ..tune import OpTune


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


@kernel_gen("gen_data")
def gen_gen_data(op: Op, tune: OpTune, ctx: GenCtx) -> FuncInfo:
    od = op.dims("out")
    mod = op.ival("mod", 13)
    sub = op.fval("sub", 6.0)
    mul = op.fval("mul", 0.1)
    stride = op.ival("stride", 7)
    offset = op.ival("offset", 0)

    def fn():
        return gen_data_pattern(od.shape, od.tn, mod, sub, mul, stride, offset,
                                device=ctx.device)

    return FuncInfo(name="", args=[("out", "out")], fn=fn,
                    flops=0.0, bytes_accessed=float(od.bytes_sz()),
                    info=f"gen_data mod={mod} stride={stride}", in_dims=[])
