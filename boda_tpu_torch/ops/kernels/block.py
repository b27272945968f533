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
there is no other fallback. Its product loop is chosen by shape before the
launch (:func:`route`): wgmma with the weights by TMA, the mma.sync loop, or
the f32 FMA loop. Each launch adds one to ``bottleneck.launches`` and to
``bottleneck.paths`` under its route, and keeps the :class:`BlockPlan` the
C side launched in ``bottleneck.last_plan``.

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
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import build
from .common import (KERNEL_DTYPES, PATH_CODES, aligned16, check_operand, kernel_dtype,
                     kernel_entry, sm_count)


class BlockPlan(NamedTuple):
    path: str     # "wgmma" | "mma" | "fma"
    tile: int     # the spatial tile's side T
    cluster: int  # thread blocks per tile (res5: 4)
    blocks: int   # thread blocks of the launch


def route(c: int, k: int, dtype, aligned: bool = True) -> str:
    """The product loop of one launch, by shape (``aligned``: every operand
    starts on a 16-byte boundary): bf16 with C and K multiples of 64 ->
    ``wgmma`` (64-deep weight chunks by TMA, a 3x3 chunk inside one tap);
    other bf16 -> ``mma`` (mma.sync, channels padded in shared memory); f32
    -> ``fma``."""
    if dtype == torch.float32:
        return "fma"
    if dtype != torch.bfloat16:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    return "wgmma" if c % 64 == 0 and k % 64 == 0 and aligned else "mma"


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


@kernel_entry("K6", lambda: bottleneck.last_plan)
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
    aligned = aligned16(x, w1, b1, w2, b2, w3, b3, out)
    path = route(c, k, x.dtype, aligned)
    kb = build.load()
    launched = (ctypes.c_int * 2)()  # the tile side and cluster the C side launched
    with torch.cuda.device(x.device):
        rc = kb.lib.boda_bottleneck(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                    w2.data_ptr(), b2.data_ptr(), w3.data_ptr(),
                                    b3.data_ptr(), out.data_ptr(), n, h, w, c, k,
                                    dt, PATH_CODES[path], launched, build.stream_ptr(x))
    build.check(rc, f"boda_bottleneck ({path})")
    bottleneck.launches += 1
    bottleneck.paths[path] += 1
    bottleneck.last_plan = _block_plan(path, n, h, w, launched[0], launched[1])
    return out


# kernel launches, in all and per route (CPU plain-version calls do not count)
bottleneck.launches = 0
bottleneck.paths = dict.fromkeys(PATH_CODES, 0)
bottleneck.last_plan = None  # the plan of the latest launch


def _block_plan(path: str, n: int, h: int, w: int, t: int, cl: int) -> BlockPlan:
    blocks = n * -(-h // t) * -(-w // t) * cl if t else 0
    return BlockPlan(path, t, cl, blocks)


def plan(n: int, h: int, w: int, c: int, k: int, dtype: torch.dtype,
         path: str | None = None, aligned: bool = True,
         dev: torch.device | None = None) -> BlockPlan:
    """The C side's plan for n images of h x w, c channels and k mid
    channels on ``path`` (default: :func:`route`'s; ``aligned``: every
    operand starts on a 16-byte boundary) on the card ``dev`` (default: the
    current one), as a launch there would make it: the tile side, the
    cluster of thread blocks per image and tile (more than one only on the
    wgmma route), the blocks. Tile 0 if none fits."""
    return _plan(n, h, w, c, k, dtype, path or route(c, k, dtype, aligned),
                 sm_count(dev if dev is not None else torch.device("cuda")))


@functools.lru_cache(maxsize=256)  # the C side's plan: a pure function of its arguments
def _plan(n: int, h: int, w: int, c: int, k: int, dtype: torch.dtype, path: str,
          sms: int) -> BlockPlan:
    cl = ctypes.c_int(1)
    t = build.load().lib.boda_bottleneck_plan(n, h, w, c, k, KERNEL_DTYPES[dtype],
                                              PATH_CODES[path], sms, ctypes.byref(cl))
    return _block_plan(path, n, h, w, t, cl.value)
