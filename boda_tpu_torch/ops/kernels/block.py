"""The fused residual bottleneck, 1x1 -> 3x3 -> 1x1 + skip in one kernel:
the port of K6.

Counterpart of ``boda_tpu/ops/kernels/block.py:pallas_bottleneck``:

  h1 = relu(x @ w1 + b1)                 rounded to x's dtype
  h2 = relu(conv3x3_pad1(h1) @ w2 + b2)  rounded to x's dtype
  y  = relu(x + h2 @ w3 + b3)            the residual added in f32

with f32 accumulation, NHWC. The CUDA kernel is ``csrc/block.cu``: one block
per image and spatial tile, h1 (with its one-pixel halo) and h2 held in
shared memory, so only x is read and y written. :func:`bottleneck` launches
it for CUDA tensors and runs :func:`bottleneck_plain` for CPU tensors;
there is no other fallback.

:func:`block_fuse_ok` keeps boda_tpu's structural conditions only (stride 1,
3x3, pad 1, groups 1, dilation 1). Its VMEM budget and its ``c % 128`` /
``cc % 8`` lane gates are Mosaic's, not Hopper's: the kernel tiles the
plane to fit shared memory and masks ragged channel counts, as the port's
conv dropped the same gates.

Layouts: x (N,H,W,C); w1 (C,K), b1 (K); w2 (3,3,K,K) HWIO, b2 (K); w3 (K,C),
b3 (C); output (N,H,W,C).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build
from .common import KERNEL_DTYPES, check_operand, kernel_dtype


def block_fuse_ok(xd, k: int, cc: int, s, p, groups: int, dil=(1, 1)) -> bool:
    """Can :func:`bottleneck` run this block (x dims, 3x3 width k, mid
    channels cc)? Every structurally valid block: the kernel has no size
    limit."""
    return tuple(s) == (1, 1) and tuple(p) == (1, 1) and k == 3 and \
        groups == 1 and tuple(dil) == (1, 1)


def bottleneck_plain(x, w1, b1, w2, b2, w3, b3):
    """The plain PyTorch version: three f32 products, rounded to x's dtype
    where boda_tpu's kernel rounds (h1, h2) and the residual added in f32."""
    dt = x.dtype
    xf = x.float()
    h1 = torch.clamp_min(xf @ w1.float() + b1.float(), 0.0).to(dt)
    acc = F.conv2d(h1.float().permute(0, 3, 1, 2), w2.float().permute(3, 2, 0, 1),
                   padding=1).permute(0, 2, 3, 1)
    h2 = torch.clamp_min(acc + b2.float(), 0.0).to(dt)
    y = torch.clamp_min(h2.float() @ w3.float() + b3.float() + xf, 0.0)
    return y.to(dt).contiguous()


def bottleneck(x, w1, b1, w2, b2, w3, b3):
    """x (N,H,W,C) -> relu(x + conv1x1(relu(conv3x3(relu(conv1x1(x))))))."""
    if x.device.type == "cpu":
        return bottleneck_plain(x, w1, b1, w2, b2, w3, b3)
    if x.device.type != "cuda":
        raise ValueError(f"bottleneck: no kernel for device {x.device}")
    if x.dim() != 4 or w1.dim() != 2 or w1.shape[0] != x.shape[3]:
        raise ValueError(f"bottleneck: bad shapes x {tuple(x.shape)} "
                         f"w1 {tuple(w1.shape)}")
    n, h, w, c = x.shape
    k = w1.shape[1]
    dt = kernel_dtype(x)
    for name, t, shape in (("x", x, (n, h, w, c)), ("w1", w1, (c, k)), ("b1", b1, (k,)),
                           ("w2", w2, (3, 3, k, k)), ("b2", b2, (k,)),
                           ("w3", w3, (k, c)), ("b3", b3, (c,))):
        check_operand(name, t, x.device, x.dtype, shape)
    out = torch.empty_like(x)
    kb = build.load()
    with torch.cuda.device(x.device):
        rc = kb.lib.boda_bottleneck(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                    w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                                    b3.data_ptr(), out.data_ptr(), n, h, w, c, k,
                                    dt, build.stream_ptr(x))
    build.check(rc, "boda_bottleneck")
    bottleneck.launches += 1
    return out


bottleneck.launches = 0  # kernel launches (CPU plain-version calls do not count)


def plan(n: int, h: int, w: int, c: int, k: int, dtype: torch.dtype) -> tuple[int, int]:
    """(tile side, cluster size) of the kernel's launch for n images of
    h x w, c channels and k mid channels, operands 16-byte aligned: one
    cluster of thread blocks per image and tile. (0, 1) if none fits."""
    cl = ctypes.c_int(1)
    t = build.load().lib.boda_bottleneck_plan(n, h, w, c, k, KERNEL_DTYPES[dtype], 4,
                                              ctypes.byref(cl))
    return t, cl.value
