"""Plain float32 building blocks of the references: NCHW tensors, OIHW
filters, (out, in) fully connected weights, Caffe's conventions. Nothing
here imports the program under test; every function is a direct statement
of the published layer.

``quant`` is the control's hook: None computes in float32; ``fp8``
computes in float8 where the program computes in bfloat16, the precision
below the configurations': every weight, every input of a convolution or
product and every layer's output rounded to e4m3 (one scale per tensor,
``out``), and in a backward pass the gradient of each convolution's and
product's output to e5m2 (one scale per tensor), the split that fp8
training uses. ``bf16`` rounds the same tensors to bfloat16, the
configurations' own precision: the witness that a gap of the program's is
bfloat16's rounding.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

IMAGENET_MEAN_BGR = (104.0, 117.0, 123.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per tensor, back in float32.
    The gradient passes straight through."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    q = (x.detach() * s).to(torch.float8_e4m3fn).float() / s
    return x + (q - x).detach()


class _GradE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to float8 e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        s = 57344.0 / g.abs().amax().clamp_min(1e-30)
        return (g * s).to(torch.float8_e5m2).float() / s


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in float32; the gradient passes through."""
    return x + (x.detach().to(torch.bfloat16).float() - x.detach())


class _GradBF16(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


QUANT = {None: lambda x: x, "fp8": fp8, "bf16": bf16}


def out(t, quant=None):
    """A layer's output as the control stores it (float32 without ``quant``)."""
    return QUANT[quant](t)


QUANT_GRAD = {None: lambda y: y, "fp8": _GradE5M2.apply, "bf16": _GradBF16.apply}


@contextlib.contextmanager
def float32_exact():
    """No TF32 in the library's float32 convolutions and products while the
    reference runs."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def preprocess(rgba_u8: torch.Tensor) -> torch.Tensor:
    """(n, y, x, 4) uint8 RGBA -> (n, 3, y, x) float32 BGR minus the ImageNet
    mean (Caffe's ``transform_param`` mean values)."""
    x = rgba_u8[..., :3].float()
    bgr = torch.stack([x[..., 2], x[..., 1], x[..., 0]], dim=1)
    mean = torch.tensor(IMAGENET_MEAN_BGR, device=x.device).reshape(1, 3, 1, 1)
    return bgr - mean


def conv(x, w, b, stride=1, pad=0, dilation=1, quant=None):
    q = QUANT[quant]
    return QUANT_GRAD[quant](F.conv2d(q(x), q(w), b, stride=stride, padding=pad,
                                      dilation=dilation))


def fc(x, w, b, quant=None):
    q = QUANT[quant]
    return QUANT_GRAD[quant](q(x.flatten(1)) @ q(w).t() + b)


def batchnorm_deploy(x, mean, var, sf, eps=1e-5):
    """Caffe BatchNorm with stored statistics: the stats divided by the
    scale factor (1 where it is 0)."""
    s = torch.where(sf[0] != 0, 1.0 / sf[0], torch.ones_like(sf[0]))
    return (x - (mean * s).reshape(1, -1, 1, 1)) * torch.rsqrt((var * s).reshape(1, -1, 1, 1) + eps)


def batchnorm_train(x, eps=1e-5):
    """Train-mode BatchNorm: the batch's mean over (n, y, x) and its biased
    variance; returns (normalized, mean, variance)."""
    m = x.mean(dim=(0, 2, 3))
    v = ((x - m.reshape(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    return (x - m.reshape(1, -1, 1, 1)) * torch.rsqrt(v.reshape(1, -1, 1, 1) + eps), m, v


def scale(x, gamma, beta):
    return x * gamma.reshape(1, -1, 1, 1) + beta.reshape(1, -1, 1, 1)


def maxpool_ceil(x, k, s, pad=0):
    """Caffe max pooling: ceil-mode output size, padding never wins."""
    return F.max_pool2d(x, k, s, padding=pad, ceil_mode=True)


def conv_out(h: int, k: int, s: int, p: int, d: int = 1) -> int:
    return (h + 2 * p - d * (k - 1) - 1) // s + 1


def pool_out_ceil(h: int, k: int, s: int, p: int = 0) -> int:
    return -(-(h + 2 * p - k) // s) + 1
