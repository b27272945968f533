"""int8 conv/fc compute on the library's int8 GEMM.

Counterpart of the int8 branches of ``boda_tpu/graph/lowering_nhwc.py``
(:123-189 the conv, :420-454 the fc), which boda_tpu leaves to XLA
(``lax.conv_general_dilated`` and ``jnp.dot`` with an int32 accumulator).
Here every product is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card):
a 1x1 conv (subsampled when strided) and the fc directly, a k x k conv on
its int8 patches gathered into a matrix (PyTorch has no int8 convolution on
CUDA). The quantizers keep boda_tpu's order of operations: a divide (by a
tensor, never a multiply by the reciprocal, which CUDA's divide by a host
scalar would be), a round half to even, a clip where boda_tpu clips.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

# cuBLASLt's int8 GEMM, as torch._int_mm checks it on the card: more than 16
# rows, K and N multiples of 8. Zero padding changes no sum.
MM_MIN_ROWS = 17
MM_ALIGN = 8


def const(v: float, device) -> torch.Tensor:
    """A 0-dim f32 tensor of ``v`` on ``device``, made by a fill kernel (no
    copy from the host, so a CUDA-graph capture may make it too)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int8_mm(a: torch.Tensor, b: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """The int32 product of int8 ``a`` (M, K) and ``b`` (K', N') by
    ``torch._int_mm``, (M, n): ``a`` zero-padded to ``b``'s K' (a multiple of
    8) and to 17 rows where it has fewer, ``b`` to K' and N' multiples of 8
    (``quant_weight`` pads it once), the result cut back to M rows and ``n``
    columns (default all of ``b``'s)."""
    m, k = a.shape
    n = b.shape[1] if n is None else n
    kp = _round_up(max(k, b.shape[0]), MM_ALIGN)
    np_ = _round_up(b.shape[1], MM_ALIGN)
    if b.shape != (kp, np_):
        b = F.pad(b, (0, np_ - b.shape[1], 0, kp - b.shape[0]))
    mp = max(m, MM_MIN_ROWS)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    out = torch._int_mm(a.contiguous(), b.contiguous())
    return out if out.shape == (m, n) else out[:m, :n]


def weight_cache() -> WeakIdKeyDictionary:
    """A lowering's weight -> quantized form map for :func:`quant_weight`:
    each weight is quantized on the first forward that reads it and again
    after any in-place change to it (the entry is keyed by the tensor and
    its ``_version``, which every in-place op bumps), and its entry dies
    with it."""
    return WeakIdKeyDictionary()


def quant_weight(w: torch.Tensor, reduce_dims: tuple[int, ...],
                 cache: WeakIdKeyDictionary | None = None):
    """Symmetric int8 weights with a scale per output channel, the last axis
    of ``w`` (HWIO conv filters, the fc's (in, out) matrix): ws =
    max(max|w|, 1e-12) / 127 over ``reduce_dims``, wq = round(w / ws), from
    ``w`` as the lowering receives it (BN/Scale-folded, in the compute
    dtype). Returns (wq as a (K', N') GEMM operand, K' and N' padded to
    multiples of 8; ws (N,) f32), kept in ``cache`` when one is given."""
    hit = cache.get(w) if cache is not None else None
    if hit is not None and hit[0] == w._version:
        return hit[1]
    wf = w.float()
    ws = torch.clamp_min(wf.abs().amax(dim=reduce_dims), 1e-12) / const(127.0, w.device)
    wq = torch.round(wf / ws).to(torch.int8).reshape(-1, wf.shape[-1])
    k, n = wq.shape
    wq = F.pad(wq, (0, _round_up(n, MM_ALIGN) - n, 0, _round_up(k, MM_ALIGN) - k))
    out = (wq.contiguous(), ws)
    if cache is not None:
        cache[w] = (w._version, out)
    return out


def quant_act(x: torch.Tensor, xs: torch.Tensor | None, c127: torch.Tensor):
    """Per-tensor symmetric int8 of ``x`` -> (xq, xs). Static (``xs`` given:
    max(amax, 1e-12) / 127 from the calibration, a 0-dim device tensor):
    round(x / xs) clipped to +-127, so values past the calibrated range
    saturate. Dynamic (``xs`` None): xs = max(max|x|, 1e-12) / 127 on the
    device, round(x / xs) with no clip."""
    xf = x.float()
    if xs is not None:
        return torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8), xs
    xs = torch.clamp_min(xf.abs().amax(), 1e-12) / c127
    return torch.round(xf / xs).to(torch.int8), xs


def patches(xq: torch.Tensor, k, s, p) -> tuple[torch.Tensor, tuple[int, int, int]]:
    """The (n*oh*ow, kh*kw*c) matrix of an NHWC tensor's conv patches, zero
    padded, taps in HWIO order (kh, kw, c), and (n, oh, ow)."""
    n, h, w, c = xq.shape
    xp = F.pad(xq, (0, 0, p[1], p[1], p[0], p[0]))
    cols = xp.unfold(1, k[0], s[0]).unfold(2, k[1], s[1])  # (n, oh, ow, c, kh, kw)
    oh, ow = cols.shape[1], cols.shape[2]
    return cols.permute(0, 1, 2, 4, 5, 3).reshape(n * oh * ow, k[0] * k[1] * c), (n, oh, ow)
