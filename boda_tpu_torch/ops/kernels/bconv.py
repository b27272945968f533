"""Backward convolution: the port of K5 and the backward-conv route.

Counterparts of ``boda_tpu/ops/kernels/bconv.py``, stride 1, groups 1:

  * :func:`matmul_atb` — ``pallas_matmul_atb`` (K5): a[K,M]^T . b[K,N] -> [M,N]
    f32, contracting the leading axis without materialising a^T. The CUDA
    kernel is ``csrc/atb.cu``: for bf16 with 16-byte rows the GEMM core's
    wgmma path (``csrc/gemm.cuh``, A stored M-major), for an even N % 8 != 0
    on b's rows padded to 16 bytes (:func:`~.common.copy_rows`'s view, as the
    training step's fc writes dY) its ``wgmma_edge`` route, else a WMMA or an
    FMA loop; split-K, a deterministic second pass sums the splits.
  * :func:`conv2d_bck_filts` — ``pallas_conv2d_bck_filts``: the weight
    gradient dW (KH,KW,C,OC) f32. boda_tpu runs one K5 per filter tap on a
    copied tap slice of the padded input; here one launch of the same kernel
    covers every tap, gathering each tap's rows from the unpadded NHWC input.
  * :func:`conv2d_bck_in` — ``pallas_conv2d_bck_in``: the input gradient, the
    forward conv kernel (``csrc/conv.cu``, K3's port) on the flipped,
    io-transposed filters with pad k-1-p.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(``*_plain``) for CPU tensors; there is no other fallback. A launch of the
K5 kernel, from either wrapper, adds one to ``matmul_atb.launches`` and to
``matmul_atb.paths`` under the path of its plan (:func:`plan_atb`), and
keeps the plan in ``matmul_atb.last_plan``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .common import (PATH_CODES, WGMMA_CHUNK, aligned16, cdiv, check_operand, check_rows,
                     kernel_dtype, kernel_entry, plan_cost, sm_count)
from .conv import conv2d, conv2d_nhwc

# split-K plan of the WMMA and FMA paths: about this many blocks per SM
# across the grid, and no split shorter than this many K tiles (each split
# pays one partial-tile store and one read in the reduction pass)
_BLOCKS_PER_SM = 4
_MIN_K_TILES = 8
# those paths' tiles (csrc/atb.cu): (BM, BN, BK)
_TILES = {torch.bfloat16: (128, 128, 32), torch.float32: (64, 64, 16)}
# the wgmma path's most K splits: res2's 64x64 outputs need ~100 to fill
# 132 SMs
_MAX_SPLIT = 256


class AtbPlan(NamedTuple):
    path: str   # "wgmma" | "wgmma_edge" | "mma" | "fma"
    bm: int     # output tile rows
    bn: int     # output tile columns
    split: int  # K splits (1: none)
    chunk: int  # K per split, a multiple of the path's K step; the last may be shorter
    ctas: int   # thread blocks of the main kernel (wgmma: persistent, at most one per SM)


def atb_plan(M: int, N: int, K: int, taps: int, dtype, sms: int) -> tuple[int, int]:
    """(splits, chunk) of the WMMA (bf16) and FMA (f32) paths: the K range is
    cut into ``splits`` pieces of ``chunk`` rows (a multiple of the K tile,
    none empty), enough that the grid of output tiles x taps x splits gives
    every one of ``sms`` SMs several blocks."""
    bm, bn, bk = _TILES[dtype]
    tiles = cdiv(M, bm) * cdiv(N, bn) * taps
    k_tiles = cdiv(K, bk)
    want = cdiv(_BLOCKS_PER_SM * sms, tiles)
    splits = max(1, min(want, k_tiles // _MIN_K_TILES, 65535 // taps))
    per = cdiv(k_tiles, splits)
    return cdiv(k_tiles, per), per * bk


@functools.lru_cache(maxsize=4096)  # a pure function, called once per launch
def plan_atb(M: int, N: int, K: int, taps: int, sms: int, dtype, aligned: bool = True,
             gather: bool = False, ldb: int | None = None) -> AtbPlan:
    """The plan of one K5 launch, out[taps][M][N] = sum over K; ``gather``:
    A is gathered from the NHWC input (the weight gradient), ``aligned``:
    both operands start on a 16-byte boundary, ``ldb``: B's row stride in
    elements (None: N, a dense B). Chosen by shape, before the launch:

    * bf16 with M % 8 == 0 and N % 8 == 0, aligned -> the GEMM core's wgmma
      path. Its tile (64 or 128 rows; 64, 128 or 256 columns, no wider than
      N needs) and its K split (chunks of 64-deep steps, up to
      :data:`_MAX_SPLIT` splits, the last one possibly shorter) are those
      that common.py:plan_cost, the core's cost model as fitted to the
      forward (with the taps and the f32 output), ranks first among the
      plans whose work items give at least 2/3 of the SMs one each (or,
      where none does, among those with the most items): plan_gemm's rule.
    * the dense form in bf16 with M % 8 == 0, N % 8 != 0 and N even on B
      rows padded to 16 bytes (ldb % 8 == 0: fc1000's (tp=2) wgrad, N = 500
      at ldb = 504), aligned -> ``wgmma_edge``: the same ring, the f32
      output stored in pairs masked at the N edge; tiles of 64 or 128 rows
      and columns, ranked as above.
    * other bf16 (M % 8 != 0, odd N, a dense B with N % 8 != 0, the gather
      with N % 8 != 0) -> the WMMA loop (128x128), f32 -> FMA (64x64), split
      by :func:`atb_plan`."""
    if dtype not in _TILES:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    edge = N % 8 != 0 and N % 2 == 0 and (N if ldb is None else ldb) % 8 == 0 and not gather
    if not (dtype == torch.bfloat16 and M % 8 == 0 and (N % 8 == 0 or edge) and aligned):
        bm, bn, _ = _TILES[dtype]
        splits, chunk = atb_plan(M, N, K, taps, dtype, sms)
        return AtbPlan("fma" if dtype == torch.float32 else "mma", bm, bn, splits, chunk,
                       cdiv(M, bm) * cdiv(N, bn) * taps * splits)
    chunks = cdiv(K, WGMMA_CHUNK)
    cands = []
    for bm in (128, 64):
        for bn in (128, 64) if edge else (256, 128, 64):
            if bn > max(64, cdiv(N, 64) * 64):
                continue
            splits = {cdiv(chunks, cdiv(chunks, s)) for s in range(1, min(_MAX_SPLIT, chunks) + 1)}
            for split in splits:
                per = cdiv(chunks, split)
                items = cdiv(M, bm) * cdiv(N, bn) * taps * split
                cost = plan_cost(M, N, K, sms, bm, bn, split, gather, taps, 4)
                cands.append((min(items, -(-2 * sms // 3)), -cost, bm, bn, split, per, items))
    busy = max(c[0] for c in cands)
    _, _, bm, bn, split, per, items = max(c for c in cands if c[0] == busy)
    return AtbPlan("wgmma_edge" if edge else "wgmma", bm, bn, split, per * WGMMA_CHUNK,
                   min(items, sms))


def atb_workspace(plan: AtbPlan, taps: int, M: int, N: int, dev) -> torch.Tensor | None:
    """The f32 partial sums of a split launch, splits x taps x M x N (the
    kernel allocates nothing)."""
    if plan.split == 1:
        return None
    return torch.empty((plan.split * taps * M * N,), dtype=torch.float32, device=dev)


def _launch_atb(a, b, M: int, N: int, K: int, geom=None, ldb: int | None = None
                ) -> torch.Tensor:
    """One launch of csrc/atb.cu: dense (geom None) -> (M,N), or the wgrad
    gather (geom = (H, W, OH, OW, KH, KW, py, px)) -> (KH,KW,M,N); f32.
    ``ldb``: b's row stride (None: N)."""
    taps = 1 if geom is None else geom[4] * geom[5]
    plan = plan_atb(M, N, K, taps, sm_count(a.device), a.dtype, aligned16(a, b),
                    geom is not None, ldb)
    out_shape = (M, N) if geom is None else (geom[4], geom[5], M, N)
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    ws = atb_workspace(plan, taps, M, N, a.device)
    g = geom if geom is not None else (0, 0, 0, 0, 1, 1, 0, 0)
    kb = build.load()
    with torch.cuda.device(a.device):
        rc = kb.lib.boda_atb(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             None if ws is None else ws.data_ptr(), M, N, K,
                             plan.split, plan.chunk, int(geom is not None), *g,
                             kernel_dtype(a), PATH_CODES[plan.path], plan.bm, plan.bn,
                             N if ldb is None else ldb, build.stream_ptr(a))
    if rc:
        build.check(rc, f"boda_atb {plan}")
    matmul_atb.launches += 1
    matmul_atb.paths[plan.path] += 1
    matmul_atb.last_plan = plan
    return out


def matmul_atb_plain(a, b, out_dtype=torch.float32):
    """The plain PyTorch version: f32 ``a.t() @ b``."""
    return (a.float().t() @ b.float()).to(out_dtype)


@kernel_entry("K5", lambda: matmul_atb.last_plan)
def matmul_atb(a, b, out_dtype=torch.float32):
    """a[K,M]^T @ b[K,N] -> [M,N], f32 accumulate (then ``out_dtype``);
    a and b float32 or bfloat16, row-major; b's rows may lie further apart
    than N (:func:`~.common.check_rows`)."""
    if a.device.type == "cpu":
        return matmul_atb_plain(a, b, out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"matmul_atb: no kernel for device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"matmul_atb: bad shapes {tuple(a.shape)}, {tuple(b.shape)}")
    K, M = a.shape
    N = b.shape[1]
    kernel_dtype(a)
    check_operand("a", a, a.device, a.dtype, (K, M))
    ldb = check_rows("b", b, a.device, a.dtype, (K, N))
    out = _launch_atb(a, b, M, N, K, ldb=ldb)
    return out if out_dtype == torch.float32 else out.to(out_dtype)


# K5 kernel launches, in all and per path of the plan (CPU plain-version
# calls do not count); a split launch (two kernels) counts once
matmul_atb.launches = 0
matmul_atb.paths = dict.fromkeys(PATH_CODES, 0)
matmul_atb.last_plan = None  # the plan of the latest launch


def _filt_size(x, dy, pad) -> tuple[int, int]:
    return (x.shape[1] + 2 * pad[0] - dy.shape[1] + 1,
            x.shape[2] + 2 * pad[1] - dy.shape[2] + 1)


def conv2d_bck_filts_plain(x, dy, *, pad):
    """The plain version, as boda_tpu computes it: pad x, then one
    :func:`matmul_atb_plain` per filter tap on the tap's (N*OH*OW, C) slice."""
    n, _, _, c = x.shape
    _, oh, ow, oc = dy.shape
    kh, kw = _filt_size(x, dy, pad)
    xp = F.pad(x, (0, 0, pad[1], pad[1], pad[0], pad[0]))
    m = n * oh * ow
    dyf = dy.reshape(m, oc)
    return torch.stack([torch.stack([
        matmul_atb_plain(xp[:, ky:ky + oh, kx:kx + ow, :].reshape(m, c), dyf)
        for kx in range(kw)]) for ky in range(kh)])


@kernel_entry("K5", lambda: matmul_atb.last_plan)
def conv2d_bck_filts(x, dy, *, pad):
    """dW (KH,KW,C,OC) f32 from x (N,IH,IW,C) and dY (N,OH,OW,OC); stride 1.
    A 1x1 filter without padding is the dense form, x as [N*H*W, C] against
    dY as [N*H*W, OC]: on the wgmma path its A then comes by TMA, not by the
    gather."""
    if x.device.type == "cpu":
        return conv2d_bck_filts_plain(x, dy, pad=pad)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_bck_filts: no kernel for device {x.device}")
    if x.dim() != 4 or dy.dim() != 4 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"conv2d_bck_filts: bad shapes x {tuple(x.shape)} "
                         f"dy {tuple(dy.shape)}")
    n, h, w, c = x.shape
    _, oh, ow, oc = dy.shape
    kh, kw = _filt_size(x, dy, pad)
    if kh <= 0 or kw <= 0:
        raise ValueError(f"conv2d_bck_filts: empty filter {kh}x{kw}")
    kernel_dtype(x)
    check_operand("x", x, x.device, x.dtype, (n, h, w, c))
    check_operand("dy", dy, x.device, x.dtype, (n, oh, ow, oc))
    if (kh, kw) == (1, 1) and tuple(pad) == (0, 0):  # x is A as it lies
        return _launch_atb(x.view(n * h * w, c), dy.view(n * oh * ow, oc), c, oc,
                           n * oh * ow).view(1, 1, c, oc)
    return _launch_atb(x, dy, c, oc, n * oh * ow,
                       geom=(h, w, oh, ow, kh, kw, pad[0], pad[1]))


def conv2d_bck_in_plain(dy, w, *, pad):
    """A plain version independent of the flip: f32 ``F.conv_transpose2d``
    (the adjoint of the stride-1 conv), output NHWC in dy's dtype. (On the
    card, turn TF32 off first.)"""
    dx = F.conv_transpose2d(dy.float().permute(0, 3, 1, 2),
                            w.float().permute(3, 2, 0, 1), padding=tuple(pad))
    return dx.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


@kernel_entry("K3", lambda: conv2d.last_plan)
def conv2d_bck_in(dy, w, *, pad):
    """dX (N,IH,IW,C) from dY (N,OH,OW,OC) and w (KH,KW,C,OC); stride 1:
    the forward conv of dY with rot180(w) io-transposed, pad k-1-p, zero
    bias, through :func:`conv2d_nhwc` (the conv kernel on CUDA tensors, its
    plain version on CPU ones)."""
    kh, kw, c, _ = w.shape
    wt = w.flip(0, 1).permute(0, 1, 3, 2).contiguous()  # (kh,kw,oc,c)
    zb = torch.zeros((c,), dtype=dy.dtype, device=dy.device)
    return conv2d_nhwc(dy, wt, zb, stride=(1, 1),
                       pad=(kh - 1 - pad[0], kw - 1 - pad[1]))
