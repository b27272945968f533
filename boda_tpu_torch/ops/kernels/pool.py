"""NHWC max/avg pooling with caffe ceil-mode windows: the port of K8.

Counterpart of ``boda_tpu/ops/kernels/pool.py:pallas_pool``. The CUDA
kernel is ``csrc/pool.cu``, every window clipped to the image instead of
padded. Its route is chosen by shape before the launch (:func:`route`) and
its plan worked out here (:func:`plan`): ``rows`` for a small window at
stride > 1 (pool1: output rows from a ring of input rows staged by bulk
copies, the window reduced separably), ``window`` for a large window over
a few outputs (pool5: the window's pixels split across threads),
``thread`` for the rest (one thread per output pixel and 8 channels).
boda_tpu's ``pool_plan`` (its VMEM budget, the y-blocked plan and the
``None`` that sends a plane to ``reduce_window``) is Mosaic's limit, not
the card's: the kernel takes every shape and there is no fallback.
:func:`pool2d` launches the kernel for CUDA tensors and runs
:func:`pool2d_plain` for CPU tensors. Each launch adds one to
``pool2d.launches`` and to ``pool2d.paths`` under its route, and keeps its
:class:`PoolPlan` in ``pool2d.last_plan``.

Geometry arguments are boda_tpu's: ``k``, ``s``, ``pad_y``/``pad_x`` as
(top, bottom) and (left, right) pads of the ceil-mode windows, and the
output size ``oy``, ``ox``. Avg sums in f32 and multiplies by the inverse
of the window's count of non-padding pixels (caffe's ``avg_pool_sz``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .common import aligned16, cdiv, check_operand, kernel_dtype, kernel_entry, sm_count

ROUTES = ("thread", "rows", "window")  # the C side's route codes, in order
SMS = 132             # an H100 SXM's SMs: the plan's default, the card's own at a launch
SM_SMEM = 233472      # shared memory of one SM, bytes; each block reserves 1 KB of it
BLOCK_SMEM = 232448   # the most one block may use
_BAR_BYTES = 128      # the rows route's mbarriers, ahead of its stages
_THREADS = 256
_MAX_SLOTS = 16       # rows: the C side's limit (its mbarriers)
_ROWS_SLOTS = 8       # rows: input rows in the ring, at most, by choice
_LANES = 32           # window: lanes of 8 channels per block, at most


class PoolPlan(NamedTuple):
    route: str   # "thread" | "rows" | "window"
    blocks: int  # the grid
    slots: int   # rows: input rows in the ring
    lanes: int   # window: lanes of 8 channels per block
    slices: int  # window: slices of the window's pixels
    smem: int    # rows: dynamic shared memory of a block, bytes


def route(w: int, c: int, k, s, oy: int, ox: int, avg: bool, dtype,
          aligned: bool = True) -> str:
    """The kernel of one launch, by shape (``aligned``: x and out start on a
    16-byte boundary): bf16 with C % 8 == 0 and aligned operands takes
    ``window`` for a window of 16 pixels or more over at most 4 outputs per
    image, ``rows`` for a smaller window at stride > 1 (C <= 2048: a thread
    per 8 channels) whose ring of two input rows fits a block's shared
    memory beside the horizontal results of this ``avg``; everything else
    ``thread``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    if dtype != torch.bfloat16 or c % 8 or not aligned:
        return "thread"
    if k[0] * k[1] >= 16 and oy * ox <= 4:
        return "window"
    if k[0] * k[1] < 16 and max(s) > 1 and c <= 8 * _THREADS and \
            rows_smem(w, c, k, ox, avg, 2) <= BLOCK_SMEM:
        return "rows"
    return "thread"


def rows_smem(w: int, c: int, k, ox: int, avg: bool, slots: int) -> int:
    """The rows route's shared memory: a ring of ``slots`` input rows in
    bf16, and kh + 1 rows of horizontal results (8 bf16 or, for avg, 8 f32
    per 8 channels and output column)."""
    return _BAR_BYTES + slots * w * c * 2 + (k[0] + 1) * ox * (c // 8) * (32 if avg else 16)


def rows_plan(n: int, w: int, c: int, k, oy: int, ox: int, avg: bool, slots: int,
              sms: int = SMS) -> PoolPlan:
    """The rows route with a ring of ``slots`` input rows: a persistent grid
    of as many blocks as fit the card's SMs (at most one per output row),
    each an equal share of the output rows. Raises if a block does not
    fit."""
    smem = rows_smem(w, c, k, ox, avg, slots)
    if smem > BLOCK_SMEM or not 1 <= slots <= _MAX_SLOTS:
        raise ValueError(f"pool rows: {slots} slots, {smem} bytes")
    per_sm = min(SM_SMEM // (smem + 1024), 2048 // _THREADS)
    return PoolPlan("rows", min(n * oy, sms * per_sm), slots, 0, 0, smem)


@functools.lru_cache(maxsize=256)  # a pure function of its arguments
def plan(n: int, h: int, w: int, c: int, k, s, oy: int, ox: int, avg: bool, dtype,
         aligned: bool = True, sms: int = SMS) -> PoolPlan:
    """The launch of one pool on a card of ``sms`` SMs. ``rows``: the most
    blocks per SM (3, else 2, else 1) at which a ring of at least two input
    rows fits, with the most rows (up to 8) that fit beside them: blocks per
    SM moved pool1's time more than rows in flight did
    (scripts/torch_pool_eltwise.py --sweep); ``window``: 32 lanes of 8
    channels (fewer when C < 256) and the rest of 256 threads as slices of
    the window; ``thread``: one thread per output pixel and 8 channels (1
    for f32 or C % 8 != 0)."""
    r = route(w, c, k, s, oy, ox, avg, dtype, aligned)
    if r == "rows":  # route() saw a ring of two rows fit at one block per SM
        slots = next(sl for per_sm in (3, 2, 1) for sl in range(_ROWS_SLOTS, 1, -1)
                     if rows_smem(w, c, k, ox, avg, sl) + 1024 <= SM_SMEM // per_sm)
        return rows_plan(n, w, c, k, oy, ox, avg, slots, sms)
    if r == "window":
        lanes = min(_LANES, c // 8)
        slices = min(_THREADS // lanes, k[0] * k[1])
        return PoolPlan("window", n * oy * ox * cdiv(c // 8, lanes), 0, lanes, slices, 0)
    cpt = 8 if dtype == torch.bfloat16 and c % 8 == 0 and aligned else 1
    return PoolPlan("thread", cdiv(n * oy * ox * (c // cpt), _THREADS), 0, 0, 0, 0)


def avg_divisor(iy, ix, k, s, p, oy, ox) -> np.ndarray:
    """(oy, ox) f32 per-window non-padding pixel counts (ref
    test/rtc/pool.cucl avg_pool_sz semantics)."""
    def divisor(o, in_sz, kk, ss, pp):
        st = o * ss - pp
        en = min(st + kk, in_sz)
        return en - max(st, 0)
    dy = np.array([divisor(o, iy, k[0], s[0], p[0]) for o in range(oy)],
                  np.float32)
    dx = np.array([divisor(o, ix, k[1], s[1], p[1]) for o in range(ox)],
                  np.float32)
    return dy[:, None] * dx[None, :]


_DIVISORS: dict = {}  # (device, geometry, inverse) -> f32 (oy, ox) tensor


def _divisor(device, iy, ix, k, s, p, oy, ox, inverse: bool) -> torch.Tensor:
    """The avg divisor (or its inverse) on ``device``, made once per geometry
    and device. It is made outside inference_mode, so that it can enter a
    later autograd graph (the pool's backward), and never inside a CUDA-graph
    capture, which cannot copy a host value to the card: an engine's eager
    warm-up makes it, and the capture finds it here."""
    key = (device, iy, ix, k, s, p, oy, ox, inverse)
    t = _DIVISORS.get(key)
    if t is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"pool: avg divisor {key} is not on the card yet; run "
                               "one eager call before capturing a CUDA graph")
        d = avg_divisor(iy, ix, k, s, p, oy, ox)
        with torch.inference_mode(False):
            t = torch.from_numpy(1.0 / d if inverse else d).to(device)
        _DIVISORS[key] = t
    return t


def _nchw_pad(pad_y, pad_x):
    return (pad_x[0], pad_x[1], pad_y[0], pad_y[1])


def pool2d_lib(x, k, s, pad_y, pad_x, oy, ox, avg: bool):
    """The library pool on NHWC x (:func:`pool2d_lib_nchw` on its NCHW
    view): the engine's pooling without ``pool_pallas``, and the function
    whose autograd is the kernel's backward."""
    return pool2d_lib_nchw(x.permute(0, 3, 1, 2), k, s, pad_y, pad_x, oy, ox, avg) \
        .permute(0, 2, 3, 1).contiguous()


def pool2d_lib_nchw(x, k, s, pad_y, pad_x, oy, ox, avg: bool):
    """The library pool (``F.max_pool2d``, ``F.avg_pool2d``) on NCHW x, with
    Caffe's ceil-mode windows as the bottom/right pad of ``pool_geom``: max
    over the -inf-padded window; avg as an f32 window sum divided by the
    non-padding divisor. Output NCHW in x's dtype."""
    if avg:
        xp = F.pad(x.float(), _nchw_pad(pad_y, pad_x))
        sums = F.avg_pool2d(xp, k, s, divisor_override=1)
        p = (pad_y[0], pad_x[0])
        return (sums / _divisor(x.device, x.shape[2], x.shape[3], k, s, p, oy, ox, False)) \
            .to(x.dtype)
    xp = F.pad(x, _nchw_pad(pad_y, pad_x), value=float("-inf"))
    return F.max_pool2d(xp, k, s)


def pool2d_plain(x, k, s, pad_y, pad_x, oy, ox, avg: bool):
    """The plain PyTorch version, the reference kernel's math in f32: max
    over the -inf-padded window; avg as an f32 window sum times the inverse
    divisor. Output in x's dtype."""
    p = (pad_y[0], pad_x[0])
    xp = F.pad(x.permute(0, 3, 1, 2).float(), _nchw_pad(pad_y, pad_x),
               value=0.0 if avg else float("-inf"))
    if avg:
        inv = _divisor(x.device, x.shape[1], x.shape[2], k, s, p, oy, ox, True)
        out = F.avg_pool2d(xp, k, s, divisor_override=1) * inv
    else:
        out = F.max_pool2d(xp, k, s)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


@kernel_entry("K8", lambda: pool2d.last_plan)
def pool2d(x, k, s, pad_y, pad_x, oy, ox, avg: bool):
    """x (N,H,W,C) -> (N,oy,ox,C): max or avg pool, caffe ceil-mode
    windows clipped to the image."""
    if x.device.type == "cpu":
        return pool2d_plain(x, k, s, pad_y, pad_x, oy, ox, avg)
    if x.device.type != "cuda":
        raise ValueError(f"pool2d: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"pool2d: bad shape x {tuple(x.shape)}")
    n, h, w, c = x.shape
    if oy <= 0 or ox <= 0:
        raise ValueError(f"pool2d: empty output {oy}x{ox}")
    dt = kernel_dtype(x)
    check_operand("x", x, x.device, x.dtype, (n, h, w, c))
    out = torch.empty((n, oy, ox, c), dtype=x.dtype, device=x.device)
    p = plan(n, h, w, c, tuple(k), tuple(s), oy, ox, bool(avg), x.dtype, aligned16(x, out),
             sm_count(x.device))
    params = {"thread": (0, 0), "rows": (p.blocks, p.slots),
              "window": (p.lanes, p.slices)}[p.route]
    kb = build.load()
    with torch.cuda.device(x.device):
        rc = kb.lib.boda_pool2d(x.data_ptr(), out.data_ptr(), n, h, w, c, oy, ox,
                                k[0], k[1], s[0], s[1], pad_y[0], pad_x[0],
                                int(bool(avg)), dt, ROUTES.index(p.route), *params,
                                build.stream_ptr(x))
    build.check(rc, f"boda_pool2d ({p.route})")
    pool2d.launches += 1
    pool2d.paths[p.route] += 1
    pool2d.last_plan = p
    return out


# kernel launches, in all and per route (CPU plain-version calls do not count)
pool2d.launches = 0
pool2d.paths = dict.fromkeys(ROUTES, 0)
pool2d.last_plan = None  # the plan of the latest launch


class Pool2d(torch.autograd.Function):
    """:func:`pool2d` with a backward: the autograd of :func:`pool2d_lib`,
    the counterpart of boda_tpu's custom VJP through ``reduce_window``
    (pool.py:237-249)."""

    @staticmethod
    def forward(ctx, x, k, s, pad_y, pad_x, oy, ox, avg):
        ctx.save_for_backward(x)
        ctx.geom = (k, s, pad_y, pad_x, oy, ox, avg)
        return pool2d(x, k, s, pad_y, pad_x, oy, ox, avg)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_()
            y = pool2d_lib(xd, *ctx.geom)
            (gx,) = torch.autograd.grad(y, xd, g.to(y.dtype))
        return (gx,) + (None,) * 7
