"""The fused stem: dx-folded stride-1 conv + bias/ReLU + 3x3 s2 max pool in
one kernel: the port of K7.

Counterpart of ``boda_tpu/ops/kernels/stem.py``: the two host folds
(:func:`host_stem_dxfold`, :func:`fold_stem_weights_dx`, numpy, run by a
loader at decode time as boda_tpu's are) and the kernel,
``pallas_stem_fused`` -> :func:`stem_fused`, whose CUDA source is
``csrc/stem.cu``. :func:`stem_fused` launches it for CUDA tensors and runs
:func:`stem_fused_plain` for CPU tensors; there is no other fallback. Its
route and band split are worked out here (:func:`plan`) and nowhere else:
``mma`` for bf16 on the tensor cores (input rows staged by bulk copy, each
conv row computed once per band), ``fma`` for f32 and the shapes off that
path. Each launch adds one to ``stem_fused.launches`` and to
``stem_fused.paths`` under its route, and keeps its :class:`StemPlan` in
``stem_fused.last_plan``.

The input is the ResNet/GoogLeNet stem (7x7 s2 on C=3) after the host's
space-to-depth fold (``graph/lowering_nhwc.host_stem_s2d``) and the dx
fold, which gathers the KW column taps into the channel dim:
x6 (N, XS_H, OW, CP) with CP = KW*CIN rounded up to 16, w2 (KH*CP, OC), K
ordered ky*CP + kx*CIN + c. No engine routes to it, exactly as in boda_tpu,
where it is a measured null result on the TPU (tests/test_stem_fused.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .common import aligned16, cdiv, check_operand, kernel_dtype, kernel_entry, sm_count

ROUTES = ("fma", "mma")  # the C side's route codes, in order
SMS = 132                # an H100 SXM's SMs: the plan's default, the card's own at a launch
SM_SMEM = 233472         # shared memory of one SM, bytes; each block reserves 1 KB of it
BLOCK_SMEM = 232448      # the most one block may use
_BAR_BYTES = 128         # mma: the ring's mbarriers, ahead of its slots
_MAX_SLOTS = 16          # mma: the C side's limit (its mbarriers)
_MAX_STRIPS = 8          # mma: one warp per 16 conv pixels, at most 8 warps
_PAIR_OC = 64            # mma: up to this OC two blocks share an SM (csrc/stem.cu)
_FMA_MAX_BAND = 2        # fma: pooled rows per block, at most


class StemPlan(NamedTuple):
    route: str  # "mma" | "fma"
    band: int   # pooled rows per block
    bands: int  # blocks per image: the grid is bands x N
    slots: int  # mma: input rows in the ring (0 on fma)
    smem: int   # dynamic shared memory of a block, bytes


def stem_dxfold_cp(kw: int, cin: int) -> int:
    """Packed channel width per kx tap group: kw*cin rounded up to 16."""
    return -(-(kw * cin) // 16) * 16


def host_stem_dxfold(xsd: np.ndarray, kw: int, ow: int,
                     cp: int | None = None) -> np.ndarray:
    """(N, XS_H, XS_W, CIN) s2d-folded batch -> (N, XS_H, OW, CP) dx-folded:
    out[n, y, ox, kx*CIN + c] = xsd[n, y, ox+kx, c]; channels >= KW*CIN zero."""
    n, h, w, cin = xsd.shape
    assert w >= ow + kw - 1, (w, ow, kw)
    cp = cp or stem_dxfold_cp(kw, cin)
    out = np.zeros((n, h, ow, cp), xsd.dtype)
    for kx in range(kw):
        out[:, :, :, kx * cin:(kx + 1) * cin] = xsd[:, :, kx:kx + ow, :]
    return out


def fold_stem_weights_dx(wf: np.ndarray, cp: int | None = None) -> np.ndarray:
    """s2d-folded stem weights (KH, KW, CIN, OC) -> (KH*CP, OC) in the
    kernel's K order: K = ky*CP + kx*CIN + c."""
    kh, kw, cin, oc = wf.shape
    cp = cp or stem_dxfold_cp(kw, cin)
    w2 = np.zeros((kh, cp, oc), np.asarray(wf).dtype)
    for kx in range(kw):
        w2[:, kx * cin:(kx + 1) * cin, :] = wf[:, kx]
    return w2.reshape(kh * cp, oc)


def _check_geom(x6, w2, kh: int, poh: int, pow_: int) -> int:
    n, xs_h, ow, cp = x6.shape
    if w2.shape[0] != kh * cp:
        raise ValueError(f"stem: w2 {tuple(w2.shape)} is not ({kh}*{cp}, OC)")
    ncv = xs_h - kh + 1
    # the last pooled row's and column's windows must start inside the conv
    if ncv < 2 * poh - 1 or 2 * pow_ > ow + 1:
        raise ValueError(f"stem: {ncv}x{ow} conv rows/cols cannot pool to "
                         f"{poh}x{pow_}")
    return ncv


def mma_smem(ow: int, cp: int, kh: int, oc: int, slots: int) -> int:
    """The mma route's shared memory (csrc/stem.cu:mma_smem): the ring's
    mbarriers, ``slots`` input rows of OW*CP bf16, w2 at a pitch of OC+8
    bf16, the horizontal maxes of one conv row (OW/2, OC) f32, and the
    strips' first pixels for 2 steps x 2 conv rows (OW/16, OC) f32."""
    return (_BAR_BYTES + slots * ow * cp * 2 + kh * cp * (oc + 8) * 2 + (ow // 2) * oc * 4
            + 4 * (ow // 16) * oc * 4)


def fma_smem(ow: int, cp: int, kh: int, oc: int, band: int) -> int:
    """The fma route's shared memory (csrc/stem.cu:fma_smem): w2 in f32 and
    the band's 2*band+1 conv rows in f32."""
    return cdiv(kh * cp * oc, 32) * 32 * 4 + (2 * band + 1) * ow * oc * 4


def plan(n: int, xs_h: int, ow: int, cp: int, kh: int, oc: int, poh: int, pow_: int,
         dtype, aligned: bool = True, sms: int = SMS) -> StemPlan:
    """The plan of one launch (``aligned``: x6 and w2 start on a 16-byte
    boundary). A pure function of its arguments.

    * bf16 with OW, CP and OC multiples of 16, OW <= 128, OC <= 128 and
      aligned operands -> mma: two blocks per SM up to OC = 64 where their
      shared memory fits, else one; the pooled rows of each image cut into
      equal bands so that the N x bands blocks come to about one wave (8
      bands of 7 at the ResNet-50 b32 stem: 256 blocks on 132 SMs x 2); a
      ring of KH + 1 input rows, the rows one step reads (the next step's
      go in flight at the step's barrier; deeper rings measured no faster
      at the stem, and past KH + 2 two blocks no longer share an SM).
    * every other shape and float32 -> fma: bands of at most 2 pooled rows,
      the most whose conv rows fit shared memory.
    Raises if neither fits."""
    if (dtype == torch.bfloat16 and aligned and ow % 16 == 0 and ow // 16 <= _MAX_STRIPS
            and cp % 16 == 0 and oc % 16 == 0 and oc <= 128):
        for per_sm in ((2, 1) if oc <= _PAIR_OC else (1,)):
            limit = min(BLOCK_SMEM, SM_SMEM // per_sm - 1024)
            slots = kh + 1
            smem = mma_smem(ow, cp, kh, oc, slots)
            if slots <= _MAX_SLOTS and smem <= limit:
                band = cdiv(poh, max(1, min(poh, per_sm * sms // n)))
                return StemPlan("mma", band, cdiv(poh, band), slots, smem)
    for band in range(_FMA_MAX_BAND, 0, -1):
        smem = fma_smem(ow, cp, kh, oc, band)
        if smem <= BLOCK_SMEM:
            return StemPlan("fma", band, cdiv(poh, band), 0, smem)
    raise ValueError(f"stem: no plan fits a block's shared memory (OW {ow}, CP {cp}, "
                     f"KH {kh}, OC {oc})")


def stem_fused_plain(x6, w2, bias, *, kh: int, poh: int, pow_: int,
                     relu: bool = True):
    """The plain PyTorch version: the f32 deep-K product of the KH row taps,
    + bias, ReLU, then the 3x3 s2 max pool as a reduce_window over -inf
    padding at the bottom and right (boda_tpu's definition,
    tests/test_stem_fused.py:29-33). Output in x6's dtype."""
    ncv = _check_geom(x6, w2, kh, poh, pow_)
    n, _, ow, cp = x6.shape
    g = torch.cat([x6[:, ky:ky + ncv] for ky in range(kh)], dim=-1).float()
    acc = g @ w2.float() + bias.float()                  # (N, NCV, OW, OC)
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    pad_y = max(0, 2 * (poh - 1) + 3 - ncv)
    pad_x = max(0, 2 * (pow_ - 1) + 3 - ow)
    a = F.pad(acc.permute(0, 3, 1, 2), (0, pad_x, 0, pad_y), value=float("-inf"))
    out = F.max_pool2d(a, 3, 2)[:, :, :poh, :pow_]
    return out.permute(0, 2, 3, 1).to(x6.dtype).contiguous()


@kernel_entry("K7", lambda: stem_fused.last_plan)
def stem_fused(x6, w2, bias, *, kh: int, poh: int, pow_: int, relu: bool = True):
    """x6 (N, XS_H, OW, CP), w2 (KH*CP, OC), bias (OC,) -> (N, POH, POW, OC):
    the stride-1 conv's NCV = XS_H - KH + 1 rows, bias, ReLU, and the 3x3 s2
    max pool with right-clipped windows, in x6's dtype (float32 or bfloat16)."""
    if x6.device.type == "cpu":
        return stem_fused_plain(x6, w2, bias, kh=kh, poh=poh, pow_=pow_, relu=relu)
    if x6.device.type != "cuda":
        raise ValueError(f"stem_fused: no kernel for device {x6.device}")
    if x6.dim() != 4 or w2.dim() != 2:
        raise ValueError(f"stem_fused: bad shapes x6 {tuple(x6.shape)} w2 {tuple(w2.shape)}")
    _check_geom(x6, w2, kh, poh, pow_)
    n, xs_h, ow, cp = x6.shape
    oc = w2.shape[1]
    dt = kernel_dtype(x6)
    check_operand("x6", x6, x6.device, x6.dtype, (n, xs_h, ow, cp))
    check_operand("w2", w2, x6.device, x6.dtype, (kh * cp, oc))
    if bias.shape != (oc,) or bias.device != x6.device:
        raise ValueError(f"stem_fused: bias {tuple(bias.shape)} on {bias.device}, "
                         f"expected ({oc},) on {x6.device}")
    b32 = bias.float().contiguous()  # the epilogue adds bias in f32
    p = plan(n, xs_h, ow, cp, kh, oc, poh, pow_, x6.dtype, aligned16(x6, w2),
             sm_count(x6.device))
    out = torch.empty((n, poh, pow_, oc), dtype=x6.dtype, device=x6.device)
    kb = build.load()
    with torch.cuda.device(x6.device):
        rc = kb.lib.boda_stem(x6.data_ptr(), w2.data_ptr(), b32.data_ptr(), out.data_ptr(),
                              n, xs_h, ow, cp, kh, oc, poh, pow_, int(relu), dt,
                              ROUTES.index(p.route), p.band, p.bands, p.slots,
                              build.stream_ptr(x6))
    build.check(rc, f"boda_stem {p}")
    stem_fused.launches += 1
    stem_fused.paths[p.route] += 1
    stem_fused.last_plan = p
    return out


# kernel launches, in all and per route (CPU plain-version calls do not count)
stem_fused.launches = 0
stem_fused.paths = dict.fromkeys(ROUTES, 0)
stem_fused.last_plan = None  # the plan of the latest launch
