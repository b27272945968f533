"""Flat elementwise relu/copy/neg and mul/add/sub/max: the port of K9.

Counterpart of ``boda_tpu/ops/kernels/elementwise.py:pallas_elementwise``.
The CUDA kernel is ``csrc/eltwise.cu``: a grid-stride loop over the flat
array with 16-byte accesses, no padding to the TPU's (rows, 128) blocks.
:func:`eltwise` launches it for CUDA tensors and runs :func:`eltwise_plain`
for CPU tensors; there is no other fallback. Both compute in f32 and round
once to the output dtype, and max/relu follow ``jnp.maximum`` (NaN wins, +0
for max(-0, +0)), so the kernel and the plain version agree bit for bit.

The rtc ``eltwise`` op (the reference's small CUCL kernels: the rtc_test
dot-product smoke kernel, ref test/nvrtc_test_dot.cu, and the relu/scale/
eltwise templates, ref test/rtc/) is :func:`gen_eltwise`.

Op signature: (type=eltwise,func=mul,a=(<dims>)[,b=(<dims>)],out=(<dims>)).
"""

from __future__ import annotations

import functools

import torch

from ...rtc.compute import FuncInfo
from ...utils.dims import torch_dtype
from ..op_base import Op
from ..registry import GenCtx, kernel_gen, tune_note
from ..tune import OpTune
from . import build


def _jnp_max(a, b):
    """``jnp.maximum`` on f32 tensors: NaN if either side is NaN (as
    torch.maximum), and at a tie the AND of the two bit patterns, which is
    +0 for max(-0, +0) and the value itself otherwise."""
    tie = (a.view(torch.int32) & b.view(torch.int32)).view(torch.float32)
    return torch.where(a == b, tie, torch.maximum(a, b))


_UNARY = {
    "relu": lambda x: _jnp_max(x, torch.zeros_like(x)),
    "copy": lambda x: x,
    "neg": torch.neg,
}
_BINARY = {
    "mul": torch.mul,
    "add": torch.add,
    "sub": torch.sub,
    "max": _jnp_max,
}
# the C side's func and dtype codes
FUNC_CODES = {"relu": 0, "copy": 1, "neg": 2, "mul": 3, "add": 4, "sub": 5, "max": 6}
ELT_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _nargs(func: str) -> int:
    if func in _BINARY:
        return 2
    if func in _UNARY:
        return 1
    raise ValueError(f"eltwise: unknown func {func!r}; have {sorted(FUNC_CODES)}")


def eltwise_plain(func: str, *xs, out_dtype=None):
    """The plain PyTorch version: f applied in f32, rounded once to
    ``out_dtype`` (default: the first input's dtype)."""
    if len(xs) != _nargs(func):
        raise ValueError(f"eltwise {func}: {len(xs)} inputs")
    f = _BINARY.get(func) or _UNARY[func]
    out_dtype = out_dtype or xs[0].dtype
    return f(*(x.float() for x in xs)).to(out_dtype, copy=True)


def eltwise(func: str, *xs, out_dtype=None):
    """f(a[, b]) elementwise over same-shape, same-dtype tensors (float32,
    bfloat16 or float16), output in ``out_dtype`` (must be the inputs')."""
    x0 = xs[0]
    if x0.device.type == "cpu":
        return eltwise_plain(func, *xs, out_dtype=out_dtype)
    if x0.device.type != "cuda":
        raise ValueError(f"eltwise: no kernel for device {x0.device}")
    if len(xs) != _nargs(func):
        raise ValueError(f"eltwise {func}: {len(xs)} inputs")
    dt = x0.dtype
    code = ELT_DTYPES.get(dt)
    if code is None:
        raise ValueError(f"eltwise: the kernel takes float32, bfloat16 or float16, "
                         f"got {dt}")
    if (out_dtype or dt) != dt:
        raise ValueError(f"eltwise: output dtype {out_dtype} differs from the "
                         f"inputs' {dt}")
    for i, x in enumerate(xs):
        if x.device != x0.device or x.dtype != dt or x.shape != x0.shape:
            raise ValueError(f"eltwise: input {i} is {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}, expected {dt} {tuple(x0.shape)} on {x0.device}")
        if not x.is_contiguous():
            raise ValueError(f"eltwise: input {i} must be contiguous")
    out = torch.empty(x0.shape, dtype=dt, device=x0.device)
    n = x0.numel()
    if n == 0:
        return out
    kb = build.load()
    with torch.cuda.device(x0.device):
        rc = kb.lib.boda_eltwise(x0.data_ptr(), xs[1].data_ptr() if len(xs) == 2 else None,
                                 out.data_ptr(), n, FUNC_CODES[func], code,
                                 build.stream_ptr(x0))
    build.check(rc, "boda_eltwise")
    eltwise.launches += 1
    return out


eltwise.launches = 0  # kernel launches (CPU plain-version calls do not count)


@kernel_gen("eltwise")
def gen_eltwise(op: Op, tune: OpTune, ctx: GenCtx) -> FuncInfo:
    func = op.sval("func", "mul")
    od = op.dims("out")
    dt = torch_dtype(od.tn)
    nargs = _nargs(func)
    byts = float(od.bytes_sz() * (nargs + 1))

    if ctx.use_ref:
        fn = functools.partial(eltwise_plain, func, out_dtype=dt)
        info = f"ref:plain {func}"
    else:
        fn = functools.partial(eltwise, func, out_dtype=dt)
        info = f"cuda:eltwise {func}" + tune_note(tune)

    args = [("a", "in")] + ([("b", "in")] if nargs == 2 else []) + [("out", "out")]
    in_dims = [op.dims("a")] + ([op.dims("b")] if nargs == 2 else [])
    return FuncInfo(name="", args=args, fn=fn, flops=float(od.num_elems()),
                    bytes_accessed=byts, info=info, in_dims=in_dims)
