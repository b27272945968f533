"""NHWC lowering rules: graph ops -> PyTorch callables on channels-last data.

Counterpart of ``boda_tpu/graph/lowering_nhwc.py`` for the ops of the zoo's
ResNet, GoogLeNet, VGG, AlexNet, NiN, SqueezeNet and firenet builders and of
the Caffe nets the frontend reads.
Activations are physically (img, y, x, chan) contiguous tensors while node
Dims stay logically NCHW; library ops (pooling, the lib conv) see them
through ``permute(0, 3, 1, 2)``, a channels_last view of the same memory.

Each rule returns (fn, weight_preps): fn(*bot_tensors) -> tuple(top_tensors),
and weight_preps maps weight-node name -> :class:`Prep`: the one-time
transform applied at weight upload, its inverse (which turns a weight
*gradient* back to the logical layout, as boda_tpu's ``(prep, inv)`` does),
the axis of out_chan in the prepped weight (where the BN/Scale fold scales
it), and the layout's name.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.kernels.conv import conv2d_halo, conv2d_nhwc, space_to_depth_conv
from ..ops.kernels.pool import Pool2d, pool2d_lib
from ..ops.kernels.sgemm import matmul
from .lowering import LowerCtx, _softmax, jax_maximum, lrn_inv_pow
from .pipe import ConvOp, ConvPipe, PipeError, _concat_axis_name

_NHWC_RULES: dict[str, Callable] = {}


class Prep(NamedTuple):
    """A weight's upload-time layout: ``prep`` (logical -> device layout),
    ``inv`` (device layout -> logical, for its gradient), ``oc_axis``
    (out_chan's axis after prep) and ``layout`` (two lowerings that name the
    same layout take the same uploaded tensor)."""
    prep: Callable
    inv: Callable
    oc_axis: int
    layout: str


# conv filters, logical OIHW: HWIO for the hand kernels, OHWI (a
# channels_last OIHW view) for cuDNN
HWIO = Prep(lambda w: w.permute(2, 3, 1, 0).contiguous(),
            lambda g: g.permute(3, 2, 0, 1).contiguous(), 3, "HWIO")
OHWI = Prep(lambda w: w.permute(0, 2, 3, 1).contiguous(),
            lambda g: g.permute(0, 3, 1, 2).contiguous(), 0, "OHWI")


def nhwc_rule(op_type: str):
    def deco(fn):
        _NHWC_RULES[op_type] = fn
        return fn
    return deco


def lower_op_nhwc(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx, tune,
                  info_log: list[str]):
    """Returns (fn, weight_preps) or None if no NHWC rule exists."""
    rule = _NHWC_RULES.get(op.type)
    if rule is None:
        return None
    return rule(pipe, op, ctx, tune, info_log)


def _no_preps(fn):
    return fn, {}


def stem_s2d_geom(ind, od, s, p, k, dil, groups):
    """Geometry of the stem space-to-depth fold, or None when the conv does
    not qualify (boda_tpu: lowering_nhwc.py:58; shared by the Convolution
    rule's ``stem_s2d``, the engine's ``input_s2d`` and the host folds of
    K7's input). Conditions: square stride>1/kernel>1, no dilation or groups,
    starved in_chan (C*s*s <= 64), and non-negative right-pad (a negative
    right-pad means floor division discards input tail rows)."""
    sb, kk = s[0], k[0]
    m = -(-kk // sb)                        # taps per axis after the fold
    pad_r_y = sb * (od["y"] + m - 1) - ind["y"] - p[0]
    pad_r_x = sb * (od["x"] + m - 1) - ind["x"] - p[1]
    if not (groups == 1 and dil == (1, 1) and s[0] == s[1] > 1
            and k[0] == k[1] > 1 and ind["chan"] * s[0] * s[1] <= 64
            and pad_r_y >= 0 and pad_r_x >= 0):
        return None
    return {"sb": sb, "kk": kk, "m": m, "pad": (p[0], p[1]),
            "pad_r": (pad_r_y, pad_r_x), "xs_h": od["y"] + m - 1,
            "xs_w": od["x"] + m - 1, "cin": ind["chan"]}


def host_stem_s2d(x_nhwc, geom):
    """Numpy host-side fold of an NHWC batch into the stem's space-to-depth
    layout (N, xs_h, xs_w, sb*sb*C) (boda_tpu: lowering_nhwc.py:77), run
    once at load time by a data loader."""
    import numpy as np
    sb, cin = geom["sb"], geom["cin"]
    (p0, p1), (pry, prx) = geom["pad"], geom["pad_r"]
    xs_h, xs_w = geom["xs_h"], geom["xs_w"]
    xp = np.pad(x_nhwc, ((0, 0), (p0, pry), (p1, prx), (0, 0)))
    xsd = xp.reshape(x_nhwc.shape[0], xs_h, sb, xs_w, sb, cin)
    return np.ascontiguousarray(
        xsd.transpose(0, 1, 3, 2, 4, 5).reshape(
            x_nhwc.shape[0], xs_h, xs_w, sb * sb * cin))


# -- conv ------------------------------------------------------------------------

@nhwc_rule("Convolution")
def _nhwc_conv(pipe, op, ctx, tune, info_log):
    s, p = op.stride(), op.pad()
    k = op.kern_sz()
    dil = op.dilation()
    groups = int(op.p("groups", 1))
    relu = bool(op.p("fused_relu", False))
    fd = pipe.must_dims(op.bots[1])
    od = pipe.must_dims(op.tops[0])
    hwio = {op.bots[1]: HWIO}
    # boda_tpu's feasibility gates for its Pallas convs (c % 128, no bf16
    # stride, VMEM budgets: ops/kernels/conv.py:63,230,235) are Mosaic's, not
    # Hopper's, so they are dropped: the hand kernels take every groups-1,
    # dilation-1 conv at any stride and any channel count, the stem included.
    gen = groups == 1 and dil == (1, 1) and not tune.use_xla
    if gen and k == (1, 1) and p == (0, 0) and tune.use_k1conv:
        M = od["img"] * od["y"] * od["x"]
        info_log.append(f"{op.name}: nhwc-k1conv gemm M={M} K={fd['in_chan']} "
                        f"N={fd['out_chan']} s={s} prec={tune.precision}")

        def fn(x, w, b, residual=None):  # x NHWC, w HWIO
            if s != (1, 1):  # a strided 1x1 is a subsample, then the GEMM
                x = x[:, ::s[0], ::s[1], :].contiguous()
            n, y, xx, c = x.shape
            res2d = residual.reshape(n * y * xx, -1) \
                if residual is not None else None
            out = matmul(x.reshape(n * y * xx, c), w.reshape(c, -1), b,
                         relu=relu, residual=res2d)
            return (out.reshape(n, y, xx, -1),)
        fn.supports_residual = True
        return fn, hwio

    geom = stem_s2d_geom(pipe.must_dims(op.bots[0]), od, s, p, k, dil, groups) \
        if tune.stem_s2d == 1 else None
    if geom is not None:
        return _stem_s2d_conv(op, geom, tune, not gen, relu, info_log)

    if gen and tune.use_s2d and s != (1, 1) and k != (1, 1):
        # strided conv -> space-to-depth fold + the stride-1 direct conv
        # (boda_tpu: lowering_nhwc.py:341-360, without its Mosaic block-plan
        # gate); a strided 1x1 stays the GEMM's subsample above
        info_log.append(f"{op.name}: nhwc-s2d_conv s={s}")

        def fn(x, w, b):
            return (space_to_depth_conv(x, w, b, stride=s, pad=p, relu=relu),)
        return fn, hwio

    if gen:
        info_log.append(f"{op.name}: nhwc-direct_conv k={k} s={s} p={p} "
                        f"prec={tune.precision}")

        def fn(x, w, b, residual=None):
            return (conv2d_halo(x, w, b, stride=s, pad=p, relu=relu,
                                residual=residual),)
        fn.supports_residual = True
        return fn, hwio

    # library conv (cuDNN on the card): the analog of boda_tpu's XLA conv.
    # Weights are prepped OHWI, so the OIHW view cuDNN takes is channels_last.
    info_log.append(f"{op.name}: nhwc-lib_conv")
    ohwi = {op.bots[1]: OHWI}

    def fn(x, w, b, residual=None):
        out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), b,
                       stride=s, padding=p, dilation=dil, groups=groups)
        out = out.permute(0, 2, 3, 1)
        if residual is not None:
            out = out + residual
        if relu:
            out = torch.relu(out)
        return (out.contiguous(),)
    fn.supports_residual = True
    return fn, ohwi


def _stem_s2d_conv(op, geom, tune, lib: bool, relu: bool, info_log):
    """The stem conv on its space-to-depth fold (boda_tpu:
    lowering_nhwc.py:211-300, under any kernel policy): a stride-s k x k
    conv on C channels as the stride-1 m x m conv on s*s*C channels, the
    filters zero-padded to m*s taps and folded once at upload. The input
    arrives host-folded (input_s2d, channels maybe padded to ``pad_c``) or is
    folded here. Under gen the hand conv runs through K3's stride-1 entry,
    ``conv2d_nhwc``, on channels zero-padded to a multiple of 8 (as K4's
    fold pads them), so it takes wgmma and not the mma.sync loop of
    C % 8 != 0; under lib, cuDNN on the same fold."""
    sb, kk, m, cin = geom["sb"], geom["kk"], geom["m"], geom["cin"]
    (p0, p1), (pry, prx) = geom["pad"], geom["pad_r"]
    xs_h, xs_w = geom["xs_h"], geom["xs_w"]
    c_fold = sb * sb * cin
    c_eff = max(tune.pad_c, c_fold)
    c_k = c_eff if lib else -(-c_eff // 8) * 8  # the conv's channels
    info_log.append(f"{op.name}: nhwc-stem_s2d s={sb} k={kk} m={m} c={c_k} "
                    f"{'lib' if lib else 'conv2d_nhwc'}")

    def fold_w(w):  # OIHW -> (m, m, c_k, O), the fold's HWIO
        wh = F.pad(w.permute(2, 3, 1, 0), (0, 0, 0, 0, 0, m * sb - kk, 0, m * sb - kk))
        wh = wh.reshape(m, sb, m, sb, cin, -1).permute(0, 2, 1, 3, 4, 5) \
            .reshape(m, m, c_fold, -1)
        return F.pad(wh, (0, 0, 0, c_k - c_fold)).contiguous()

    def unfold_w(g):  # the fold's HWIO gradient -> OIHW
        g = g[:, :, :c_fold].reshape(m, m, sb, sb, cin, -1).permute(0, 2, 1, 3, 4, 5) \
            .reshape(m * sb, m * sb, cin, -1)
        return g[:kk, :kk].permute(3, 2, 0, 1).contiguous()
    if lib:  # OHWI: the channels_last view of the OIHW cuDNN takes
        prep = Prep(lambda w: fold_w(w).permute(3, 0, 1, 2).contiguous(),
                    lambda g: unfold_w(g.permute(1, 2, 3, 0)), 0, f"stem_s2d-OHWI{c_k}")
    else:
        prep = Prep(fold_w, unfold_w, 3, f"stem_s2d-HWIO{c_k}")

    def fn(x, w, b):
        if x.shape[1] == xs_h and x.shape[-1] in (c_fold, c_eff):
            xs = x  # host-folded by the loader (input_s2d)
        else:
            xs = F.pad(x, (0, 0, p1, prx, p0, pry)) \
                .reshape(x.shape[0], xs_h, sb, xs_w, sb, cin).permute(0, 1, 3, 2, 4, 5) \
                .reshape(x.shape[0], xs_h, xs_w, c_fold)
        if xs.shape[-1] < c_k:
            xs = F.pad(xs, (0, c_k - xs.shape[-1]))
        if not lib:
            return (conv2d_nhwc(xs.contiguous(), w, b, relu=relu),)
        out = F.conv2d(xs.permute(0, 3, 1, 2), w.permute(0, 3, 1, 2), b).permute(0, 2, 3, 1)
        return ((torch.relu(out) if relu else out).contiguous(),)
    return fn, {op.bots[1]: prep}


@nhwc_rule("InnerProduct")
def _nhwc_ip(pipe, op, ctx, tune, info_log):
    ind = pipe.must_dims(op.bots[0])
    fd = pipe.must_dims(op.bots[1])
    relu = bool(op.p("fused_relu", False))
    nchw_flat = "y" in ind.names and (ind["y"] > 1 or ind["x"] > 1)
    c, y, x = (ind["chan"], ind["y"], ind["x"]) if nchw_flat else (0, 0, 0)

    def prep(w):
        # fc weights are ordered for an NCHW flatten; permute once for NHWC,
        # then store as the (in, out) row-major B operand of the GEMM
        if nchw_flat:
            w = w.reshape(w.shape[0], c, y, x).permute(0, 2, 3, 1) \
                .reshape(w.shape[0], -1)
        return w.t().contiguous()

    def inv(g):
        g = g.t()
        if nchw_flat:
            g = g.reshape(g.shape[0], y, x, c).permute(0, 3, 1, 2) \
                .reshape(g.shape[0], -1)
        return g.contiguous()
    M, K, N = ind["img"], fd["in_feats"], fd["out_chan"]
    use_lib = tune.use_xla
    info_log.append(f"{op.name}: nhwc-ip {'lib' if use_lib else 'gemm'} "
                    f"M={M} K={K} N={N}")

    def fn(x, w, b):
        xf = x.reshape(x.shape[0], -1)
        if use_lib:
            out = torch.addmm(b, xf, w)
            return (torch.relu(out) if relu else out,)
        return (matmul(xf.contiguous(), w, b, relu=relu),)
    return fn, {op.bots[1]: Prep(prep, inv, 1, "IP")}


# -- spatial ops --------------------------------------------------------------------

def pool_geom(pipe, op) -> tuple:
    """A Pooling op's arguments to the pooling kernel and its library
    version: (kern, stride, pad_y, pad_x, oy, ox, avg), Caffe's ceil-mode
    windows as a bottom/right pad so the last window fits (the extra rows
    never win a max, and are not counted in an avg)."""
    k, s, p = op.kern_sz(), op.stride(), op.pad()
    ind, od = pipe.must_dims(op.bots[0]), pipe.must_dims(op.tops[0])
    oy, ox = od["y"], od["x"]
    pad_y = (p[0], max(0, (oy - 1) * s[0] + k[0] - ind["y"] - p[0]))
    pad_x = (p[1], max(0, (ox - 1) * s[1] + k[1] - ind["x"] - p[1]))
    return k, s, pad_y, pad_x, oy, ox, bool(op.p("avg_pool", False))


@nhwc_rule("Pooling")
def _nhwc_pool(pipe, op, ctx, tune, info_log):
    geom = pool_geom(pipe, op)
    k, s, avg = geom[0], geom[1], geom[6]
    if tune.pool_pallas:
        # the pooling kernel takes every plane: boda_tpu's VMEM plan and its
        # reduce_window fallback (lowering_nhwc.py:550-561) are Mosaic's
        info_log.append(f"{op.name}: nhwc-pool_pallas k={k} s={s} avg={avg}")
        return _no_preps(lambda x: (Pool2d.apply(x, *geom),))
    return _no_preps(lambda x: (pool2d_lib(x, *geom),))


@nhwc_rule("LRN")
def _nhwc_lrn(pipe, op, ctx, tune, info_log):
    """Caffe's across-channel LRN (boda_tpu: lowering_nhwc.py:625-644): the
    squares summed over a window of local_size channels in f32, scaled, then
    x * (k + alpha / size * sum)^-beta cast back to x's dtype."""
    size = int(op.p("local_size", 5))
    alpha = float(op.p("alpha", 1e-4))
    beta = float(op.p("beta", 0.75))
    kk = float(op.p("k", 1.0))
    half = (size - 1) // 2

    def fn(x):
        x32 = x.float()
        c = x.shape[3]
        sqp = F.pad(x32 * x32, (half, size - 1 - half))
        ssum = sqp[..., 0:c]
        for i in range(1, size):
            ssum = ssum + sqp[..., i:i + c]
        return ((x32 * lrn_inv_pow(kk + (alpha / size) * ssum, beta)).to(x.dtype),)
    return _no_preps(fn)


@nhwc_rule("BatchNorm")
def _nhwc_bn(pipe, op, ctx, tune, info_log):
    eps = float(op.p("eps", 1e-5))

    def fn(x, mean, var, scale_factor=None):
        sf = 1.0
        if scale_factor is not None:
            s0 = scale_factor[0]
            sf = torch.where(s0 != 0, 1.0 / s0, torch.ones_like(s0))
        m = mean * sf
        v = var * sf
        return (((x - m) * torch.rsqrt(v + eps)).to(x.dtype),)
    return _no_preps(fn)


@nhwc_rule("Scale")
def _nhwc_scale(pipe, op, ctx, tune, info_log):
    def fn(x, gamma, beta=None):
        out = x * gamma
        if beta is not None:
            out = out + beta
        return (out.to(x.dtype),)
    return _no_preps(fn)


# -- pointwise / structural ------------------------------------------------------------

@nhwc_rule("ReLU")
def _nhwc_relu(pipe, op, ctx, tune, info_log):
    return _no_preps(lambda x: (jax_maximum(x, 0.0),))


@nhwc_rule("Dropout")
def _nhwc_dropout(pipe, op, ctx, tune, info_log):
    return _no_preps(lambda x: (x,))  # inference: identity


@nhwc_rule("Split")
def _nhwc_split(pipe, op, ctx, tune, info_log):
    n = len(op.tops)
    return _no_preps(lambda x: (x,) * n)


@nhwc_rule("Concat")
def _nhwc_concat(pipe, op, ctx, tune, info_log):
    """Concat (boda_tpu: lowering_nhwc.py:708-720): on NHWC axis 3 for the
    channel axis of a canonical (img, chan, y, x) node, on the logical axis
    for other nodes."""
    d0 = pipe.must_dims(op.bots[0])
    axis_name = _concat_axis_name(op, d0)
    if d0.names == ("img", "chan", "y", "x"):  # physically NHWC
        axis = {"img": 0, "y": 1, "x": 2, "chan": 3}[axis_name]
    else:  # non-canonical nodes keep logical layout
        axis = d0.index(axis_name)
    return _no_preps(lambda *xs: (torch.cat(xs, dim=axis),))


@nhwc_rule("Eltwise")
def _nhwc_eltwise(pipe, op, ctx, tune, info_log):
    kind = op.p("eltwise_op", "sum")
    coeffs = op.p("coeffs", None)

    def fn(*xs):
        if kind == "sum":
            out = sum((c * x for c, x in zip(coeffs, xs)), start=0.0) \
                if coeffs else sum(xs[1:], start=xs[0])
        elif kind == "prod":
            out = functools.reduce(torch.mul, xs)
        elif kind == "max":
            out = functools.reduce(jax_maximum, xs)
        else:
            raise PipeError(f"eltwise: unknown op {kind!r}")
        return (out,)
    return _no_preps(fn)


@nhwc_rule("Softmax")
def _nhwc_softmax(pipe, op, ctx, tune, info_log):
    ind = pipe.must_dims(op.bots[0])
    laxis = int(op.p("axis", 1))
    if ind.names == ("img", "chan", "y", "x"):  # physically NHWC
        axis = {0: 0, 1: 3, 2: 1, 3: 2}[laxis]
    else:  # non-canonical nodes keep logical layout
        axis = laxis
    return _no_preps(lambda x: (_softmax(x, axis=axis).to(x.dtype),))


@nhwc_rule("SoftmaxWithLoss")
def _nhwc_sml(pipe, op, ctx, tune, info_log):
    ind = pipe.must_dims(op.bots[0])
    axis = 3 if "y" in ind.names else 1

    def fn(x, labels):
        prob = _softmax(x, axis=axis)
        n_cls = x.shape[axis]
        lab = torch.clamp(labels.reshape(labels.shape[0]).to(torch.int32),
                          0, n_cls - 1).long()
        rows = torch.arange(prob.shape[0], device=prob.device)
        p = prob[rows, 0, 0, lab] if prob.dim() == 4 else prob[rows, lab]
        loss = -torch.log(jax_maximum(p, 1e-38))
        return (loss.to(x.dtype), prob.to(x.dtype))
    return _no_preps(fn)


@nhwc_rule("GradAccum")
def _nhwc_gradaccum(pipe, op, ctx, tune, info_log):
    def fn(*parts):
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return (out,)
    return _no_preps(fn)


@nhwc_rule("Data")
def _nhwc_data(pipe, op, ctx, tune, info_log):
    return _no_preps(lambda x: (x,))
