"""The training step's convs and fcs on the hand kernels: autograd Functions.

Under ``kernel_policy=gen`` the training step (parallel/train.py) runs every
groups-1, dilation-1 conv and every fc through these Functions, so that both
passes go through the ported kernels:

* forward: K1 (:func:`~.sgemm.matmul`) for 1x1 convs without padding (a
  strided one subsamples first) and for fcs; the direct conv (K2's entry,
  :func:`~.conv.conv2d_halo`) for the rest. Each with its bias and nothing
  else: ReLU, the residual add and BN stay separate autograd ops in training.
* backward, by the conv's shape:
  - 1x1, pad 0, any stride, and fcs: dgrad on K1 against the transposed
    weight (a strided 1x1 at the output grid, then zero-stuffed to the input
    grid, as graph/train_ops.py's ``conv1x1_explicit`` does), wgrad on K5
    (:func:`~.bconv.matmul_atb`) over (n, y, x);
  - stride 1 (the engine's ``_lower_bck_conv`` rule): dgrad on K3's entry
    (:func:`~.bconv.conv2d_bck_in`), wgrad on K5 over every tap
    (:func:`~.bconv.conv2d_bck_filts`);
  - strided k > 1 (ResNet-50's 7x7 stem, mini_resnet's strided 3x3s): the
    library's conv backward (``torch.nn.grad``), which the step names in its
    info log;
  - bias: a plain f32 sum.
  Every gradient is rounded to its operand's dtype, as ``jax.grad`` returns
  it. An fc's dY is written once into rows padded to 16 bytes where its
  width is off 8 (:func:`~.common.copy_rows`: fc1000's (tp=2) slices, 500
  wide, at a row stride of 504), so that its dgrad (A with K = 500) and its
  wgrad (B with N = 500) both read it by TMA on the wgmma ring.

Each kernel wrapper runs its plain version on CPU tensors, so on the CPU the
Functions compute with the plain versions; on the card they launch the
kernels and never the plain versions.
"""

from __future__ import annotations

import torch

from .bconv import conv2d_bck_filts, conv2d_bck_in, matmul_atb
from .common import copy_rows
from .conv import conv2d_halo
from .sgemm import matmul


def conv_route(k, s, p) -> str:
    """The backward route of a groups-1, dilation-1 conv: ``k1`` (1x1 without
    padding: K1 and K5 as GEMMs), ``direct`` (stride 1: K3 and K5's gather)
    or ``library`` (strided k > 1)."""
    if tuple(k) == (1, 1) and tuple(p) == (0, 0):
        return "k1"
    return "direct" if tuple(s) == (1, 1) else "library"


def zero_stuff(t, in_shape, s):
    """t (N, OY, OX, C) at rows and columns 0, s, 2s, ... of a zero tensor of
    ``in_shape``: the input-grid gradient of a strided subsample."""
    if tuple(t.shape) == tuple(in_shape):
        return t
    out = torch.zeros(in_shape, dtype=t.dtype, device=t.device)
    out[:, :t.shape[1] * s[0]:s[0], :t.shape[2] * s[1]:s[1], :] = t
    return out


def _bias_grad(dy, dtype):
    return dy.float().sum(dim=tuple(range(dy.dim() - 1))).to(dtype)


class GenConv(torch.autograd.Function):
    """x (N,H,W,C), w HWIO, b (OC,) -> (N,OH,OW,OC) in x's dtype."""

    @staticmethod
    def forward(ctx, x, w, b, stride, pad):
        kh, kw, c, oc = w.shape
        route = conv_route((kh, kw), stride, pad)
        if route == "k1":
            xs = x[:, ::stride[0], ::stride[1], :].contiguous() \
                if tuple(stride) != (1, 1) else x
            n, oy, ox, _ = xs.shape
            out = matmul(xs.reshape(-1, c), w.reshape(c, oc), b).reshape(n, oy, ox, oc)
        else:
            xs = x
            out = conv2d_halo(x, w, b, stride=stride, pad=pad)
        ctx.save_for_backward(xs, w)
        ctx.route, ctx.stride, ctx.pad, ctx.xshape = route, tuple(stride), tuple(pad), x.shape
        ctx.bdt = b.dtype
        return out

    @staticmethod
    def backward(ctx, dy):
        xs, w = ctx.saved_tensors
        dy = dy.to(xs.dtype).contiguous()
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = None
        c, oc = w.shape[2:]
        if ctx.route == "k1":
            n, oy, ox, _ = dy.shape
            dy2 = dy.view(-1, oc)
            if need_x:
                t = matmul(dy2, w.reshape(c, oc).t().contiguous()).view(n, oy, ox, c)
                dx = zero_stuff(t, ctx.xshape, ctx.stride)
            if need_w:
                dw = matmul_atb(xs.reshape(-1, c), dy2).view(1, 1, c, oc)
        elif ctx.route == "direct":
            if need_x:
                dx = conv2d_bck_in(dy, w, pad=ctx.pad)
            if need_w:
                dw = conv2d_bck_filts(xs, dy, pad=ctx.pad)
        else:  # the library's conv backward, on the NCHW views
            xn, dyn = xs.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1)
            if need_x:
                dx = torch.nn.grad.conv2d_input(tuple(xn.shape), w_oihw, dyn, ctx.stride,
                                                ctx.pad).permute(0, 2, 3, 1).contiguous()
            if need_w:
                dw = torch.nn.grad.conv2d_weight(xn, tuple(w_oihw.shape), dyn, ctx.stride,
                                                 ctx.pad).permute(2, 3, 1, 0)
        return (None if dx is None else dx.to(xs.dtype),
                None if dw is None else dw.to(w.dtype).contiguous(),
                _bias_grad(dy, ctx.bdt) if need_b else None, None, None)


class GenFc(torch.autograd.Function):
    """x (N, K) @ w (K, OUT) + b (OUT,) -> (N, OUT) in x's dtype."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bdt = b.dtype
        return matmul(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = copy_rows(dy, x.dtype)
        need_x, need_w, need_b = ctx.needs_input_grad
        dx = matmul(dy, w.t().contiguous()) if need_x else None
        dw = matmul_atb(x, dy).to(w.dtype) if need_w else None
        return dx, dw, _bias_grad(dy, ctx.bdt) if need_b else None


def gen_conv(x, w, b, *, stride=(1, 1), pad=(0, 0)):
    """The training conv on the hand kernels (see the module's docstring)."""
    return GenConv.apply(x, w, b, tuple(stride), tuple(pad))


def gen_fc(x, w, b):
    """The training fc on K1 forward and K1/K5 backward; x is (N, K)."""
    return GenFc.apply(x.contiguous(), w, b)
