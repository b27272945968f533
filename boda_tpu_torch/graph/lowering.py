"""Per-op lowering on the logical layout: graph ops -> PyTorch callables.

Counterpart of ``boda_tpu/graph/lowering.py``: ``LowerCtx``, the
``lower_rule``/``lower_op`` registry and its 25 rules (Convolution with f32
accumulation, groups and dilation, InnerProduct, Deconvolution, Pooling
with Caffe's ceil-mode windows, LRN, BatchNorm, Scale, ReLU, Sigmoid, TanH,
Dropout, Concat, Split, Eltwise, Reduce, Softmax, SoftmaxWithLoss,
Accuracy, Data, and the explicit backward ops Spreading, ZeroIfNonPos,
BckDropout, BckLRN, Bck and GradAccum), on the library's ops (cuDNN and
cuBLAS on the card) with activations NCHW and conv filters OIHW, as the
graph's dims name them. They are the ``xla`` engine's rules, the oracle
that shares no rule with the NHWC engine, and the NCHW route's fallback
(ops/cnn_variants.py). graph/ssd_ops.py adds the six SSD rules.

Each rule returns fn(*bot_tensors) -> tuple(top_tensors). A backward op
(Spreading, BckLRN, Bck) is the autograd of its forward rule, as boda_tpu's
is ``jax.vjp`` of it. The cores that the NHWC rules use are shared: the LRN
window (:func:`lrn_window`), the softmax, :func:`jax_maximum`, the Caffe
pool geometry with its non-padding avg divisor (``lowering_nhwc.pool_geom``,
``ops/kernels/pool.py:pool2d_lib_nchw``), the Eltwise sum/prod/max
(:func:`eltwise`) and Dropout's masks (``lowering_nhwc.dropout_mask`` and
its ``DROPOUT_MASK_HOOK``).

Also the precision names, :func:`lib_precision`, which applies a precision
to the library ops, and :func:`jax_maximum`, ``jnp.maximum`` with JAX's
gradient.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..utils.dims import stable_hash
from .pipe import ConvOp, ConvPipe, PipeError, _concat_axis_name

# boda_tpu's precision names, as torch's fp32_precision of the library's f32
# matmuls (cuBLAS) and convs (cuDNN): 'highest' = full f32 ("ieee"); 'high'
# and 'default' = TF32 (on a GPU, XLA's default f32 dot is TF32 as well).
# The hand kernels run full f32 for f32 operands and bf16 inputs with an f32
# accumulator for bf16 operands, whatever the precision.
PRECISIONS = {"default": "tf32", "high": "tf32", "highest": "ieee"}


@contextlib.contextmanager
def lib_precision(precision: str):
    """Run the library's f32 matmuls and convs at ``precision``, then restore
    the previous settings. Only the ``fp32_precision`` settings are touched:
    recent torch refuses a process that mixes them with the legacy
    ``allow_tf32`` flags. (cuDNN convs default to TF32, so without this an
    f32 lib conv at 'highest' would run TF32.)"""
    mm, cv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    old = (mm.fp32_precision, cv.fp32_precision)
    mm.fp32_precision = cv.fp32_precision = PRECISIONS[precision]
    try:
        yield
    finally:
        mm.fp32_precision, cv.fp32_precision = old


class _JaxMaximum(torch.autograd.Function):
    """max(a, b) whose gradient follows ``jnp.maximum`` (lax.max's
    ``_balanced_eq``): where a == b each side gets half the cotangent.
    torch.relu sends 0 there and torch.clamp_min 1, so a ReLU on exact
    zeros (a zero input, a dead channel) would differ from boda_tpu."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        ea, eb = (a == out).to(g.dtype), (b == out).to(g.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g * ea / (1 + eb)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = (g * eb / (1 + ea)).sum_to_size(b.shape)
        return ga, gb


def jax_maximum(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.maximum(a, b)``: torch.maximum's value, JAX's gradient when
    autograd records (a plain max otherwise). ``b`` may be a Python float:
    it becomes a 0-dim tensor on the host, which a CUDA kernel takes as a
    scalar argument, so no host value is copied to the card (a copy that a
    CUDA-graph capture refuses)."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _JaxMaximum.apply(a, b)
    return torch.maximum(a, b)


@dataclass(frozen=True)
class LowerCtx:
    precision: str = "highest"     # matmul/conv pass precision
    compute_tn: str = ""           # '' = keep input dtype; else cast for compute
    # static int8 calibration: node name -> activation amax (prof/calib.py);
    # None = dynamic quantization (a per-tensor amax per forward)
    act_amax: Optional[dict] = None
    # act_int8's signed storage scales (node -> float): an int8 conv fed a
    # stored int8 input dequantizes with the engine's own storage scale
    act_store_scale: Optional[dict] = None
    device: str = "cpu"            # where the lowerings' constants live
    det_drop_seed: int = 0         # deterministic dropout seed
    train: bool = False            # training mode (dropout active)

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise PipeError(f"unknown precision {self.precision!r}; "
                            f"have {sorted(PRECISIONS)}")


def _softmax(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    x32 = x.float()
    m = torch.amax(x32, dim=axis, keepdim=True)
    e = torch.exp(x32 - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


def lrn_inv_pow(scale: torch.Tensor, beta: float) -> torch.Tensor:
    """scale**(-beta) in boda_tpu's forms (lowering.py:271-285): beta = 0.75
    as rsqrt(s) * sqrt(rsqrt(s)) and beta = 0.5 as rsqrt(s), two root ops in
    place of the exp/log pow chain. Same math as pow; the forms are kept
    because they are the reference's rounding."""
    if beta == 0.75:
        t = torch.rsqrt(scale)
        return t * torch.sqrt(t)
    if beta == 0.5:
        return torch.rsqrt(scale)
    return torch.pow(scale, -beta)


def lrn_window(x: torch.Tensor, size: int, alpha: float, beta: float, kk: float,
               dim: int) -> torch.Tensor:
    """Caffe's across-channel LRN with the channels on ``dim`` (boda_tpu:
    lowering.py:247-268): the squares summed over a window of ``size``
    channels in f32 by shifted slices, x * (k + alpha / size * sum)^-beta in
    :func:`lrn_inv_pow`'s forms, cast back to x's dtype."""
    half = (size - 1) // 2
    x32 = x.float()
    c = x.shape[dim]
    pad = [0, 0] * (x.dim() - 1 - dim) + [half, size - 1 - half]
    sqp = F.pad(x32 * x32, pad)
    ssum = sqp.narrow(dim, 0, c)
    for i in range(1, size):
        ssum = ssum + sqp.narrow(dim, i, c)
    return (x32 * lrn_inv_pow(kk + (alpha / size) * ssum, beta)).to(x.dtype)


def eltwise(kind: str, coeffs, xs) -> torch.Tensor:
    """Caffe's Eltwise over ``xs``: sum (with coeffs, if any), prod or max
    (``jnp.maximum``), in input order."""
    if kind == "sum":
        return sum((c * x for c, x in zip(coeffs, xs)), start=0.0) \
            if coeffs else sum(xs[1:], start=xs[0])
    if kind == "prod":
        return functools.reduce(torch.mul, xs)
    if kind == "max":
        return functools.reduce(jax_maximum, xs)
    raise PipeError(f"eltwise: unknown op {kind!r}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    """t for an f32-accumulating library op: as it is in f32, else upcast
    (the products of bf16 values are exact in f32, so a conv or matmul on
    the upcast operands is boda_tpu's ``preferred_element_type=f32``)."""
    return t if t.dtype == torch.float32 else t.float()


def autograd_vjp(fwd: Callable, prim: list, rest: Callable, cts_of: Callable) -> list:
    """The vector-Jacobian product of a forward rule: ``fwd`` run under
    autograd on ``prim`` (detached copies that require grad) through
    ``rest(prim) -> args``; ``cts_of(outs)`` gives (out, cotangent) pairs,
    a cotangent None for an output with none. Returns each primal's
    gradient in its dtype, zeros where no output depends on it."""
    with torch.enable_grad():
        prim = [p.detach().requires_grad_() for p in prim]
        ys, cts = [], []
        for out, ct in cts_of(fwd(*rest(prim))):
            if ct is not None and out.requires_grad:
                ys.append(out)
                cts.append(ct.to(out.dtype))
        grads = torch.autograd.grad(ys, prim, cts, allow_unused=True) \
            if ys else [None] * len(prim)
    return [(torch.zeros_like(p) if g is None else g).to(p.dtype)
            for g, p in zip(grads, prim)]


# -- the logical-layout rules (boda_tpu: lowering.py:60-585) -------------------------

_LOWER: dict[str, Callable] = {}

# rules whose function runs autograd inside a forward: a graph that holds
# one runs under no_grad, not inference_mode
AUTOGRAD_RULES = ("Bck", "Spreading", "BckLRN")


def lower_rule(op_type: str):
    def deco(fn):
        _LOWER[op_type] = fn
        return fn
    return deco


def lower_op(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """Return fn(*bot_tensors) -> tuple(top_tensors)."""
    rule = _LOWER.get(op.type)
    if rule is None:
        raise PipeError(f"no lowering rule for op type {op.type!r} (op {op.name!r})")
    return rule(pipe, op, ctx)


def _chan(t: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over NCHW."""
    return t.reshape(1, -1, 1, 1)


@lower_rule("Convolution")
def _lower_conv(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """conv_f32acc (boda_tpu: lowering.py:78-135): the conv with an f32
    accumulator (bf16 operands upcast), + bias, ReLU if fused, cast to x's
    dtype; any stride, pad, dilation and groups."""
    s, p, dil = op.stride(), op.pad(), op.dilation()
    groups = int(op.p("groups", 1))
    relu = bool(op.p("fused_relu", False))

    def fn(x, w, b):
        out = F.conv2d(_f32(x), _f32(w), None, stride=s, padding=p, dilation=dil,
                       groups=groups) + _chan(b)
        if relu:
            out = jax_maximum(out, 0.0)
        return (out.to(x.dtype),)
    return fn


@lower_rule("InnerProduct")
def _lower_ip(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """y = x.flatten @ w.T + b with an f32 accumulator (w (out_chan,
    in_feats), Caffe's), ReLU if fused, cast to x's dtype."""
    relu = bool(op.p("fused_relu", False))

    def fn(x, w, b):
        out = torch.matmul(_f32(x.reshape(x.shape[0], -1)), _f32(w).t()) + b
        if relu:
            out = jax_maximum(out, 0.0)
        return (out.to(x.dtype),)
    return fn


@lower_rule("Deconvolution")
def _lower_deconv(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """Caffe's Deconvolution, the gradient of a conv by its input
    (boda_tpu: an input-dilated conv on the flipped kernel), as the
    library's transposed conv in f32 on the logical (out_chan, in_chan/g,
    kh, kw) filters turned to its (in_chan, out_chan/g, kh, kw), + bias,
    cast to x's dtype."""
    s, p = op.stride(), op.pad()
    g = int(op.p("groups", 1))

    def fn(x, w, b):
        o, ig, kh, kw = w.shape
        wt = w.reshape(g, o // g, ig, kh, kw).transpose(1, 2).reshape(g * ig, o // g, kh, kw)
        out = F.conv_transpose2d(_f32(x), _f32(wt), stride=s, padding=p, groups=g)
        return ((out + _chan(b)).to(x.dtype),)
    return fn


@lower_rule("Pooling")
def _lower_pool(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """Max or avg pooling with Caffe's ceil-mode windows as a bottom/right
    pad, the avg over the non-padding pixels only (boda_tpu: lowering.py:
    187-244)."""
    from ..ops.kernels.pool import pool2d_lib_nchw
    from .lowering_nhwc import pool_geom
    geom = pool_geom(pipe, op)
    return lambda x: (pool2d_lib_nchw(x, *geom),)


@lower_rule("LRN")
def _lower_lrn(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    size, alpha = int(op.p("local_size", 5)), float(op.p("alpha", 1e-4))
    beta, kk = float(op.p("beta", 0.75)), float(op.p("k", 1.0))
    return lambda x: (lrn_window(x, size, alpha, beta, kk, 1),)


@lower_rule("BatchNorm")
def _lower_bn(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    eps = float(op.p("eps", 1e-5))

    def fn(x, mean, var, scale_factor=None):
        sf = 1.0
        if scale_factor is not None:
            s0 = scale_factor[0]
            sf = torch.where(s0 != 0, 1.0 / s0, torch.ones_like(s0))
        return (((x - _chan(mean * sf)) * torch.rsqrt(_chan(var * sf) + eps)).to(x.dtype),)
    return fn


@lower_rule("Scale")
def _lower_scale(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    def fn(x, gamma, beta=None):
        out = x * _chan(gamma)
        if beta is not None:
            out = out + _chan(beta)
        return (out.to(x.dtype),)
    return fn


@lower_rule("ReLU")
def _lower_relu(pipe, op, ctx):
    return lambda x: (jax_maximum(x, 0.0).to(x.dtype),)


@lower_rule("Sigmoid")
def _lower_sigmoid(pipe, op, ctx):
    return lambda x: (torch.sigmoid(x),)


@lower_rule("TanH")
def _lower_tanh(pipe, op, ctx):
    return lambda x: (torch.tanh(x),)


def _dropout(name: str, ratio: float, ctx: LowerCtx) -> Callable:
    """x * mask / (1 - ratio) with the fixed mask of seed det_drop_seed +
    (stable_hash(name) & 0xFFFF), drawn once per shape and device by
    ``lowering_nhwc.dropout_mask``; identity in inference."""
    if not ctx.train:
        return lambda x: x
    from .lowering_nhwc import dropout_mask
    keep = 1.0 - ratio
    seed = ctx.det_drop_seed + (stable_hash(name) & 0xFFFF)
    masks: dict = {}

    def fn(x):
        key = (tuple(x.shape), x.device)
        if key not in masks:
            masks[key] = dropout_mask(name, seed, tuple(x.shape), keep).to(x.device)
        return (x * masks[key] / keep).to(x.dtype)
    return fn


@lower_rule("Dropout")
def _lower_dropout(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    drop = _dropout(op.name, float(op.p("dropout_ratio", 0.5)), ctx)
    return lambda x: (drop(x),)


@lower_rule("Concat")
def _lower_concat(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    d0 = pipe.must_dims(op.bots[0])
    axis = d0.index(_concat_axis_name(op, d0))
    return lambda *xs: (torch.cat(xs, dim=axis),)


@lower_rule("Split")
def _lower_split(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    n = len(op.tops)
    return lambda x: (x,) * n


@lower_rule("Eltwise")
def _lower_eltwise(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    kind, coeffs = op.p("eltwise_op", "sum"), op.p("coeffs", None)
    return lambda *xs: (eltwise(kind, coeffs, xs),)


@lower_rule("Reduce")
def _lower_reduce(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """N-ary elementwise sum in input order (ref Reduce_coi)."""
    return lambda *xs: (sum(xs[1:], start=xs[0]),)


@lower_rule("Softmax")
def _lower_softmax(pipe, op, ctx):
    axis = int(op.p("axis", 1))
    return lambda x: (_softmax(x, axis=axis).to(x.dtype),)


@lower_rule("SoftmaxWithLoss")
def _lower_sml(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    def fn(x, labels):
        prob = _softmax(x, axis=1)
        lab = torch.clamp(labels.reshape(labels.shape[0]).to(torch.int32),
                          0, x.shape[1] - 1).long()
        rows = torch.arange(prob.shape[0], device=prob.device)
        p = prob[rows, lab, 0, 0] if prob.dim() == 4 else prob[rows, lab]
        loss = -torch.log(jax_maximum(p, 1e-38))
        return (loss.to(x.dtype), prob.to(x.dtype))
    return fn


@lower_rule("Accuracy")
def _lower_accuracy(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """1.0 where the label is among the top_k scores (``lax.top_k``: the
    lower index first among equal scores, so a stable descending sort)."""
    top_k = int(op.p("top_k", 1))

    def fn(x, labels):
        xf = x.reshape(x.shape[0], -1)
        lab = labels.reshape(labels.shape[0]).to(torch.int64)
        idx = torch.sort(xf, dim=1, descending=True, stable=True)[1][:, :top_k]
        return ((idx == lab[:, None]).any(dim=1).to(torch.float32),)
    return fn


@lower_rule("Data")
def _lower_data(pipe, op, ctx):
    return lambda x: (x,)


# -- explicit backward ops (ref conv_util.cc:40-64) ------------------------------------

def _vjp_at_input(fwd: Callable) -> Callable:
    """The gradient of a one-input forward at x for the output gradient og."""
    def grad(x, og):
        return autograd_vjp(fwd, [x], lambda p: p,
                            lambda outs: [(outs[0], og)])[0].to(x.dtype)
    return grad


@lower_rule("Spreading")
def _lower_spreading(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """Pooling backward {out, out_grad_loss, in} -> in_grad_loss: the
    autograd of the Pooling rule at ``in``."""
    pool_op = ConvOp(name=op.name + "__fwd", type="Pooling", bots=[op.bots[2]],
                     tops=[op.bots[0]], params=dict(op.params))
    grad = _vjp_at_input(lower_op(pipe, pool_op, ctx))
    return lambda out, og, x: (grad(x, og),)


@lower_rule("ZeroIfNonPos")
def _lower_zinp(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """ReLU backward: out = in where cond > 0, else 0."""
    return lambda x, cond: (torch.where(cond > 0, x, torch.zeros((), dtype=x.dtype)),)


@lower_rule("BckDropout")
def _lower_bck_dropout(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """Dropout backward: the gradient through the forward's mask (an op
    named '<fwd>__bck' draws the forward's seed); the activation input is
    optional, as in the reference's add_bck_ops."""
    base = op.name[:-5] if op.name.endswith("__bck") else op.name
    drop = _dropout(base, float(op.p("dropout_ratio", 0.5)), ctx)
    return lambda g, _act=None: (drop(g),)


@lower_rule("BckLRN")
def _lower_bck_lrn(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """LRN backward {in, out, out_grad_loss} -> in_grad_loss: the autograd of
    the LRN rule at ``in``."""
    lrn_op = ConvOp(name=op.name + "__fwd", type="LRN", bots=[op.bots[0]],
                    tops=[op.bots[1]], params=dict(op.params))
    grad = _vjp_at_input(lower_op(pipe, lrn_op, ctx))
    return lambda x, out, og: (grad(x, og),)


def bck_cotangents(pipe: ConvPipe, op: ConvOp, fwd: ConvOp) -> Callable:
    """boda_tpu's cotangents of a Bck op: ones for the loss top of a
    SoftmaxWithLoss, the incoming gradients for the tops in
    ``top_has_grad``, in order, and none for the rest. Returns
    cts_of(outs, gs) -> [(out, cotangent or None)]."""
    top_has_grad = set(op.p("top_has_grad") or [])
    loss_node = op.p("loss_node")
    is_loss = fwd.type == "SoftmaxWithLoss"

    def cts_of(outs, gs):
        gs = iter(gs)
        res = []
        for t, out in zip(fwd.tops, outs):
            if is_loss and t == loss_node:
                res.append((out, torch.ones_like(out)))
            elif t in top_has_grad:
                res.append((out, next(gs)))
            else:
                res.append((out, None))
        return res
    return cts_of


@lower_rule("Bck")
def _lower_bck(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    """The backward of one forward op: the autograd of its forward rule
    (boda_tpu: ``jax.vjp`` of it, lowering.py:536-576), for each of its bots
    that wants a gradient (data and trainable weights)."""
    from .autodiff import _wants_grad
    fwd = pipe.ops[op.p("fwd_op")]
    fwd_fn = lower_op(pipe, fwd, ctx)
    n_fwd_bots = len(fwd.bots)
    grad_pos = [i for i, b in enumerate(fwd.bots) if _wants_grad(pipe, op, b)]
    cts = bck_cotangents(pipe, op, fwd)

    def fn(*args):
        full, gs = list(args[:n_fwd_bots]), args[n_fwd_bots:]

        def rest(prim):
            for pos, t in zip(grad_pos, prim):
                full[pos] = t
            return full
        return tuple(autograd_vjp(fwd_fn, [full[p] for p in grad_pos], rest,
                                  lambda outs: cts(outs, gs)))
    return fn


@lower_rule("GradAccum")
def _lower_gradaccum(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx) -> Callable:
    def fn(*parts):
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return (out,)
    return fn
