"""NHWC max/avg pooling with caffe ceil-mode windows: the port of K8.

Counterpart of ``boda_tpu/ops/kernels/pool.py:pallas_pool``. The CUDA
kernel is ``csrc/pool.cu``: one thread per output pixel and group of 8
channels, the window clipped to the image instead of padded. boda_tpu's
``pool_plan`` (its VMEM budget, the y-blocked plan and the ``None`` that
sends a plane to ``reduce_window``) is Mosaic's limit, not the card's: the
kernel takes every shape and there is no fallback. :func:`pool2d` launches
the kernel for CUDA tensors and runs :func:`pool2d_plain` for CPU tensors.

Geometry arguments are boda_tpu's: ``k``, ``s``, ``pad_y``/``pad_x`` as
(top, bottom) and (left, right) pads of the ceil-mode windows, and the
output size ``oy``, ``ox``. Avg sums in f32 and multiplies by the inverse
of the window's count of non-padding pixels (caffe's ``avg_pool_sz``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from . import build
from .common import check_operand, kernel_dtype


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


@functools.lru_cache(maxsize=None)
def _divisor(iy, ix, k, s, p, oy, ox, inverse: bool) -> np.ndarray:
    # numpy, not a tensor: one made under inference_mode could not enter a
    # later autograd graph (the pool's backward)
    d = avg_divisor(iy, ix, k, s, p, oy, ox)
    return 1.0 / d if inverse else d


def _nchw_pad(pad_y, pad_x):
    return (pad_x[0], pad_x[1], pad_y[0], pad_y[1])


def pool2d_lib(x, k, s, pad_y, pad_x, oy, ox, avg: bool):
    """The library pool (``F.max_pool2d``, ``F.avg_pool2d`` on the NCHW view
    of x): the engine's pooling without ``pool_pallas``, and the function
    whose autograd is the kernel's backward. Avg divides by the divisor."""
    p = (pad_y[0], pad_x[0])
    if avg:
        xp = F.pad(x.permute(0, 3, 1, 2).float(), _nchw_pad(pad_y, pad_x))
        sums = F.avg_pool2d(xp, k, s, divisor_override=1)
        div = _divisor(x.shape[1], x.shape[2], k, s, p, oy, ox, False)
        out = sums / torch.from_numpy(div).to(sums.device)
        return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()
    xp = F.pad(x.permute(0, 3, 1, 2), _nchw_pad(pad_y, pad_x), value=float("-inf"))
    return F.max_pool2d(xp, k, s).permute(0, 2, 3, 1).contiguous()


def pool2d_plain(x, k, s, pad_y, pad_x, oy, ox, avg: bool):
    """The plain PyTorch version, the reference kernel's math in f32: max
    over the -inf-padded window; avg as an f32 window sum times the inverse
    divisor. Output in x's dtype."""
    p = (pad_y[0], pad_x[0])
    xp = F.pad(x.permute(0, 3, 1, 2).float(), _nchw_pad(pad_y, pad_x),
               value=0.0 if avg else float("-inf"))
    if avg:
        inv = _divisor(x.shape[1], x.shape[2], k, s, p, oy, ox, True)
        out = F.avg_pool2d(xp, k, s, divisor_override=1) * torch.from_numpy(inv).to(xp.device)
    else:
        out = F.max_pool2d(xp, k, s)
    return out.permute(0, 2, 3, 1).to(x.dtype).contiguous()


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
    kb = build.load()
    with torch.cuda.device(x.device):
        rc = kb.lib.boda_pool2d(x.data_ptr(), out.data_ptr(), n, h, w, c, oy, ox,
                                k[0], k[1], s[0], s[1], pad_y[0], pad_x[0],
                                int(bool(avg)), dt, build.stream_ptr(x))
    build.check(rc, "boda_pool2d")
    pool2d.launches += 1
    return out


pool2d.launches = 0  # kernel launches (CPU plain-version calls do not count)


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
