"""The fused stem: dx-folded stride-1 conv + bias/ReLU + 3x3 s2 max pool in
one kernel: the port of K7.

Counterpart of ``boda_tpu/ops/kernels/stem.py``: the two host folds
(:func:`host_stem_dxfold`, :func:`fold_stem_weights_dx`, numpy, run by a
loader at decode time as boda_tpu's are) and the kernel,
``pallas_stem_fused`` -> :func:`stem_fused`, whose CUDA source is
``csrc/stem.cu``. :func:`stem_fused` launches it for CUDA tensors and runs
:func:`stem_fused_plain` for CPU tensors; there is no other fallback.

The input is the ResNet/GoogLeNet stem (7x7 s2 on C=3) after the host's
space-to-depth fold (``graph/lowering_nhwc.host_stem_s2d``) and the dx
fold, which gathers the KW column taps into the channel dim:
x6 (N, XS_H, OW, CP) with CP = KW*CIN rounded up to 16, w2 (KH*CP, OC), K
ordered ky*CP + kx*CIN + c. No engine routes to it, exactly as in boda_tpu,
where it is a measured null result on the TPU (tests/test_stem_fused.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .common import check_operand, kernel_dtype


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
    out = torch.empty((n, poh, pow_, oc), dtype=x6.dtype, device=x6.device)
    kb = build.load()
    with torch.cuda.device(x6.device):
        rc = kb.lib.boda_stem(x6.data_ptr(), w2.data_ptr(), b32.data_ptr(), out.data_ptr(),
                              n, xs_h, ow, cp, kh, oc, poh, pow_, int(relu), dt,
                              build.stream_ptr(x6))
    build.check(rc, "boda_stem")
    stem_fused.launches += 1
    return out


stem_fused.launches = 0  # kernel launches (CPU plain-version calls do not count)
