"""Flat elementwise relu/copy/neg and mul/add/sub/max: the port of K9.

Counterpart of ``boda_tpu/ops/kernels/elementwise.py:pallas_elementwise``.
The CUDA kernel is ``csrc/eltwise.cu``, with no padding to the TPU's (rows,
128) blocks. Its path is chosen before the launch by :func:`plan`: ``ring``
where every operand starts on a 16-byte boundary (a persistent grid, the
array's chunks dealt to the blocks in turn, each streamed through shared
memory by bulk copies), ``scalar`` for a view off alignment (a grid-stride
loop). The plan is worked out here and passed to the kernel, which only
checks that it can run it. :func:`eltwise` launches it for CUDA tensors
and runs :func:`eltwise_plain` for CPU tensors; there is no other
fallback. Each launch adds one to
``eltwise.launches`` and to ``eltwise.paths`` under its path, and keeps its
:class:`EltPlan` in ``eltwise.last_plan``. Both compute in f32 and round
once to the output dtype, and max/relu follow ``jnp.maximum`` (NaN wins, +0
for max(-0, +0)), so the kernel and the plain version agree bit for bit.

The rtc ``eltwise`` op (the reference's small CUCL kernels: the rtc_test
dot-product smoke kernel, ref test/nvrtc_test_dot.cu, and the relu/scale/
eltwise templates, ref test/rtc/) is :func:`gen_eltwise`.

Op signature: (type=eltwise,func=mul,a=(<dims>)[,b=(<dims>)],out=(<dims>)).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ...rtc.compute import FuncInfo
from ...utils.dims import torch_dtype
from ..op_base import Op
from ..registry import GenCtx, kernel_gen, tune_note
from ..tune import OpTune
from . import build
from .common import aligned16, cdiv, kernel_entry, sm_count


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


PATHS = ("ring", "scalar")  # the C side's path codes, in order
SMS = 132           # an H100 SXM's SMs: the plan's default, the card's own at a launch
RING_PER_SM = 2     # ring blocks per SM
RING_STAGE_BYTES = 16384  # one stage of one operand
RING_STAGES = 3
_BAR_BYTES = 128    # the ring's mbarriers, ahead of its stages
_SCALAR_BLOCKS_PER_SM = 32


class EltPlan(NamedTuple):
    path: str         # "ring" | "scalar"
    blocks: int       # the grid
    stage_bytes: int  # ring: bytes of one operand's stage (a multiple of 16)
    stages: int       # ring: stages in the ring
    smem: int         # ring: dynamic shared memory of a block, bytes


def ring_smem(nin: int) -> int:
    return _BAR_BYTES + RING_STAGES * RING_STAGE_BYTES * nin


@functools.lru_cache(maxsize=256)  # a pure function of its arguments
def plan(n: int, dtype: torch.dtype, aligned: bool, nin: int = 2, sms: int = SMS) -> EltPlan:
    """The launch for n elements of ``dtype`` with ``nin`` inputs
    (``aligned``: every operand starts on a 16-byte boundary) on a card of
    ``sms`` SMs. ``ring``: RING_PER_SM blocks per SM, no more than there
    are stages of work (csrc/eltwise.cu deals the array's chunks of one
    stage to them in turn); ``scalar`` for misaligned operands or fewer
    than 16 bytes."""
    units = n * dtype.itemsize // 16
    if not aligned or units == 0:
        return EltPlan("scalar", max(1, min(cdiv(n, 256), sms * _SCALAR_BLOCKS_PER_SM)),
                       0, 0, 0)
    blocks = max(1, min(sms * RING_PER_SM, cdiv(units, RING_STAGE_BYTES // 16)))
    return EltPlan("ring", blocks, RING_STAGE_BYTES, RING_STAGES, ring_smem(nin))


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


@kernel_entry("K9", lambda: eltwise.last_plan)
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
    nin = len(xs)
    p = plan(n, dt, aligned16(*xs, out), nin, sm_count(x0.device))
    kb = build.load()
    with torch.cuda.device(x0.device):
        rc = kb.lib.boda_eltwise(x0.data_ptr(), xs[1].data_ptr() if nin == 2 else None,
                                 out.data_ptr(), n, FUNC_CODES[func], code,
                                 PATHS.index(p.path), p.blocks, p.stage_bytes, p.stages,
                                 build.stream_ptr(x0))
    build.check(rc, f"boda_eltwise ({p.path})")
    eltwise.launches += 1
    eltwise.paths[p.path] += 1
    eltwise.last_plan = p
    return out


# kernel launches, in all and per path (CPU plain-version calls do not count)
eltwise.launches = 0
eltwise.paths = dict.fromkeys(PATHS, 0)
eltwise.last_plan = None  # the plan of the latest launch


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
