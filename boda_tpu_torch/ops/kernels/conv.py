"""Direct implicit-GEMM NHWC conv with a fused bias(+residual)(+ReLU) store:
the port of K2 and K3.

Counterparts of ``boda_tpu/ops/kernels/conv.py:pallas_conv2d_halo`` (K2) and
``pallas_conv2d_nhwc`` (K3). Both entry points keep their JAX signatures and
call one CUDA kernel, ``csrc/conv.cu``: the K2/K3 split exists only because
of Mosaic's DMA and layout limits (c % 128, no bf16 stride, VMEM budgets),
none of which binds on Hopper, so there are no block plans here either.
:func:`conv2d` launches the kernel for CUDA tensors and runs
:func:`conv2d_plain` for CPU tensors; there is no other fallback.

Layouts are the JAX package's: x (N,H,W,C), w HWIO (KH,KW,C,OC), bias (OC),
residual and output (N,OH,OW,OC).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import build
from .common import check_operand, epilogue, kernel_dtype, ptr


def out_size(h: int, w: int, kh: int, kw: int, stride, pad) -> tuple[int, int]:
    return ((h + 2 * pad[0] - kh) // stride[0] + 1,
            (w + 2 * pad[1] - kw) // stride[1] + 1)


def conv2d_plain(x, w, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False,
                 residual=None):
    """The plain PyTorch version: f32 ``F.conv2d`` on the NCHW views plus the
    epilogue, output NHWC in x's dtype. (On the card, turn TF32 off first:
    cuDNN convs run TF32 by default.)"""
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   stride=tuple(stride), padding=tuple(pad))
    return epilogue(acc.permute(0, 2, 3, 1), bias, residual, relu, x.dtype) \
        .contiguous()


def conv2d(x, w, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False,
           residual=None):
    """x (N,H,W,C) * w (KH,KW,C,OC) + bias (+residual) (+ReLU) ->
    (N,OH,OW,OC); any stride and padding, groups 1, dilation 1."""
    if x.device.type == "cpu":
        return conv2d_plain(x, w, bias, stride=stride, pad=pad, relu=relu,
                            residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: no kernel for device {x.device}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw, _, oc = w.shape
    oh, ow = out_size(h, wd, kh, kw, stride, pad)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv2d: empty output {oh}x{ow}")
    dt = kernel_dtype(x)
    check_operand("x", x, x.device, x.dtype, (n, h, wd, c))
    check_operand("w", w, x.device, x.dtype, (kh, kw, c, oc))
    check_operand("bias", bias, x.device, x.dtype, (oc,))
    if residual is not None:
        check_operand("residual", residual, x.device, x.dtype, (n, oh, ow, oc))
    out = torch.empty((n, oh, ow, oc), dtype=x.dtype, device=x.device)
    kb = build.load()
    with torch.cuda.device(x.device):
        rc = kb.lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                ptr(residual), out.data_ptr(), n, h, wd, c, oh,
                                ow, oc, kh, kw, stride[0], stride[1], pad[0],
                                pad[1], int(relu), dt, build.stream_ptr(x))
    build.check(rc, "boda_conv2d")
    conv2d.launches += 1
    return out


conv2d.launches = 0  # kernel launches (CPU plain-version calls do not count)


def conv2d_halo(x, wt, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False,
                residual=None):
    """Entry point of K2 (``pallas_conv2d_halo``): the direct conv with the
    residual epilogue."""
    return conv2d(x, wt, bias, stride=stride, pad=pad, relu=relu,
                  residual=residual)


def conv2d_nhwc(x, w, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False):
    """Entry point of K3 (``pallas_conv2d_nhwc``): the direct conv without a
    residual. Unlike K3 it takes any stride."""
    return conv2d(x, w, bias, stride=stride, pad=pad, relu=relu)
