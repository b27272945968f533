"""Backward convolution: the port of K5 and the backward-conv route.

Counterparts of ``boda_tpu/ops/kernels/bconv.py``, stride 1, groups 1:

  * :func:`matmul_atb` — ``pallas_matmul_atb`` (K5): a[K,M]^T . b[K,N] -> [M,N]
    f32, contracting the leading axis without materialising a^T. The CUDA
    kernel is ``csrc/atb.cu`` (split-K over blocks, a deterministic second
    pass sums the splits).
  * :func:`conv2d_bck_filts` — ``pallas_conv2d_bck_filts``: the weight
    gradient dW (KH,KW,C,OC) f32. boda_tpu runs one K5 per filter tap on a
    copied tap slice of the padded input; here one launch of the same kernel
    covers every tap, gathering each tap's rows from the unpadded NHWC input.
  * :func:`conv2d_bck_in` — ``pallas_conv2d_bck_in``: the input gradient, the
    forward conv kernel (``csrc/conv.cu``, K3's port) on the flipped,
    io-transposed filters with pad k-1-p.

Each wrapper launches its kernel for CUDA tensors and runs its plain version
(``*_plain``) for CPU tensors; there is no other fallback. A launch of the
K5 kernel, from either wrapper, adds one to ``matmul_atb.launches``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .common import cdiv, check_operand, kernel_dtype, sm_count
from .conv import conv2d_nhwc

# split-K plan: about this many blocks per SM across the grid, and no split
# shorter than this many K tiles (each split pays one partial-tile store and
# one read in the reduction pass)
_BLOCKS_PER_SM = 4
_MIN_K_TILES = 8
# the kernel's tiles (csrc/atb.cu): (BM, BN, BK)
_TILES = {torch.bfloat16: (128, 128, 32), torch.float32: (64, 64, 16)}


def atb_plan(M: int, N: int, K: int, taps: int, dtype, sms: int) -> tuple[int, int]:
    """(splits, chunk): the K range is cut into ``splits`` pieces of ``chunk``
    rows (a multiple of the K tile, none empty), enough that the grid of
    output tiles x taps x splits gives every one of ``sms`` SMs several
    blocks."""
    bm, bn, bk = _TILES[dtype]
    tiles = cdiv(M, bm) * cdiv(N, bn) * taps
    k_tiles = cdiv(K, bk)
    want = cdiv(_BLOCKS_PER_SM * sms, tiles)
    splits = max(1, min(want, k_tiles // _MIN_K_TILES, 65535 // taps))
    per = cdiv(k_tiles, splits)
    return cdiv(k_tiles, per), per * bk


def _launch_atb(a, b, M: int, N: int, K: int, geom=None) -> torch.Tensor:
    """One launch of csrc/atb.cu: dense (geom None) -> (M,N), or the wgrad
    gather (geom = (H, W, OH, OW, KH, KW, py, px)) -> (KH,KW,M,N); f32."""
    taps = 1 if geom is None else geom[4] * geom[5]
    splits, chunk = atb_plan(M, N, K, taps, a.dtype, sm_count(a.device))
    out_shape = (M, N) if geom is None else (geom[4], geom[5], M, N)
    out = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    ws = torch.empty((taps * splits * M * N,), dtype=torch.float32,
                     device=a.device) if splits > 1 else None
    g = geom if geom is not None else (0, 0, 0, 0, 1, 1, 0, 0)
    kb = build.load()
    with torch.cuda.device(a.device):
        rc = kb.lib.boda_atb(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                             None if ws is None else ws.data_ptr(), M, N, K,
                             splits, chunk, int(geom is not None), *g,
                             kernel_dtype(a), build.stream_ptr(a))
    build.check(rc, "boda_atb")
    matmul_atb.launches += 1
    return out


def matmul_atb_plain(a, b, out_dtype=torch.float32):
    """The plain PyTorch version: f32 ``a.t() @ b``."""
    return (a.float().t() @ b.float()).to(out_dtype)


def matmul_atb(a, b, out_dtype=torch.float32):
    """a[K,M]^T @ b[K,N] -> [M,N], f32 accumulate (then ``out_dtype``);
    a and b float32 or bfloat16, row-major."""
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
    check_operand("b", b, a.device, a.dtype, (K, N))
    out = _launch_atb(a, b, M, N, K)
    return out if out_dtype == torch.float32 else out.to(out_dtype)


matmul_atb.launches = 0  # K5 kernel launches (CPU plain-version calls do not count)


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


def conv2d_bck_filts(x, dy, *, pad):
    """dW (KH,KW,C,OC) f32 from x (N,IH,IW,C) and dY (N,OH,OW,OC); stride 1."""
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
    return _launch_atb(x, dy, c, oc, n * oh * ow,
                       geom=(h, w, oh, ow, kh, kw, pad[0], pad[1]))


def conv2d_bck_in_plain(dy, w, *, pad):
    """A plain version independent of the flip: f32 ``F.conv_transpose2d``
    (the adjoint of the stride-1 conv), output NHWC in dy's dtype. (On the
    card, turn TF32 off first.)"""
    dx = F.conv_transpose2d(dy.float().permute(0, 3, 1, 2),
                            w.float().permute(3, 2, 0, 1), padding=tuple(pad))
    return dx.permute(0, 2, 3, 1).to(dy.dtype).contiguous()


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
