"""SSD detection op set on PyTorch: Permute, Flatten, Reshape, Normalize,
PriorBox and DetectionOutput.

Counterpart of ``boda_tpu/graph/ssd_ops.py``: the same six shape rules and
the same NHWC rules, with boda_tpu's fixed-shape head, so that the whole
forward, head included, is captured once as a CUDA graph. Nothing in a rule
waits on the host: no boolean-mask indexing, no ``nonzero``, no ``.item()``
and no shape that depends on the data; every constant (the prior-box table,
the class labels, the image ids) is made on the engine's device when the
rule is lowered, at init, never copied from the host inside a forward.

DetectionOutput decodes the boxes, then runs greedy NMS for every (image,
class) pair at once: one stable descending sort picks each pair's top-k
candidates (lower index first among equal scores, as ``lax.top_k``), the
suppression test ``iou > nms_threshold`` is computed once, and one k-step
loop of two launches per step (a batched dot with the kept mask and a
clamp) decides each candidate in score order. A second stable sort picks
each image's keep_top_k detections across classes; rows past the valid ones
are padded with label -1, as Caffe's fixed-shape analog in boda_tpu.

Layout: canonical (img, chan, y, x) nodes are physically NHWC; these ops
run on the logical layout, so each rule turns a canonical input back to
NCHW first. Nodes with another dim order (everything after a Permute) are
held in their logical layout by the executor.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from ..utils.dims import Dims
from .lowering import lower_rule
from .lowering_nhwc import _no_preps, nhwc_rule
from .pipe import ConvOp, ConvPipe, PipeError, _op_info

_CANON = ("img", "chan", "y", "x")


def _is_canon4d(d: Dims) -> bool:
    return d.names == _CANON


# -- shape rules ---------------------------------------------------------------------

@_op_info("Permute")
def _calc_permute(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    order = tuple(op.p("order"))
    if sorted(order) != list(range(len(ind))):
        raise PipeError(f"op {op.name!r}: bad permute order {order} for {ind}")
    return [Dims.make([ind.names[i] for i in order],
                      [ind.sizes[i] for i in order], ind.tn)]


def _flat_range(ind: Dims, op: ConvOp) -> tuple[int, int]:
    axis = int(op.p("axis", 1))
    end = int(op.p("end_axis", -1))
    n = len(ind)
    axis = axis % n
    end = end % n
    if axis > end:
        raise PipeError(f"op {op.name!r}: flatten axis {axis} > end_axis {end}")
    return axis, end


@_op_info("Flatten")
def _calc_flatten(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    axis, end = _flat_range(ind, op)
    names = list(ind.names[:axis])
    sizes = list(ind.sizes[:axis])
    prod = 1
    for s in ind.sizes[axis:end + 1]:
        prod *= s
    kept_after = list(ind.names[end + 1:])
    flat_name = "chan" if "chan" not in names + kept_after else "flat"
    names.append(flat_name)
    sizes.append(prod)
    names += kept_after
    sizes += list(ind.sizes[end + 1:])
    return [Dims.make(names, sizes, ind.tn)]


@_op_info("Reshape")
def _calc_reshape(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    spec = list(op.p("shape"))
    sizes, names = [], []
    infer_at = -1
    for i, s in enumerate(spec):
        s = int(s)
        if s == 0:  # copy from the input (Caffe's ReshapeParameter)
            if i >= len(ind):
                raise PipeError(f"op {op.name!r}: reshape dim 0 at {i} "
                                f"but input has {len(ind)} dims")
            sizes.append(ind.sizes[i])
            names.append(ind.names[i])
        elif s == -1:
            if infer_at >= 0:
                raise PipeError(f"op {op.name!r}: multiple -1 in reshape")
            infer_at = i
            sizes.append(-1)
            names.append(f"d{i}")
        else:
            sizes.append(s)
            names.append(f"d{i}")
    known = 1
    for s in sizes:
        if s > 0:
            known *= s
    if infer_at >= 0:
        if ind.num_elems() % known:
            raise PipeError(f"op {op.name!r}: cannot infer -1 "
                            f"({ind.num_elems()} % {known})")
        sizes[infer_at] = ind.num_elems() // known
    elif known != ind.num_elems():
        raise PipeError(f"op {op.name!r}: reshape {spec} size {known} != "
                        f"input {ind.num_elems()}")
    seen: set = set()  # a copied name may collide with a generated one
    for i, nm in enumerate(names):
        while nm in seen:
            nm = nm + "_"
        seen.add(nm)
        names[i] = nm
    return [Dims.make(names, sizes, ind.tn)]


@_op_info("Normalize", min_bots=2, max_bots=2)
def _calc_normalize(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    return [pipe.must_dims(op.bots[0])]


def _prior_geometry(op: ConvOp):
    """The expanded aspect-ratio list and the priors per location (Caffe
    SSD's PriorBoxLayer::LayerSetUp)."""
    mins = [float(v) for v in op.p("min_sizes")]
    maxs = [float(v) for v in op.p("max_sizes") or []]
    flip = bool(op.p("flip", True))
    ars = [1.0]
    for ar in op.p("aspect_ratios") or []:
        ar = float(ar)
        if any(abs(ar - a) < 1e-6 for a in ars):
            continue
        ars.append(ar)
        if flip:
            ars.append(1.0 / ar)
    n_per_loc = len(ars) * len(mins) + len(maxs)
    return mins, maxs, ars, n_per_loc


@_op_info("PriorBox", min_bots=2, max_bots=2)
def _calc_priorbox(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    fd = pipe.must_dims(op.bots[0])
    _, _, _, n_per_loc = _prior_geometry(op)
    n_priors = fd["y"] * fd["x"] * n_per_loc
    return [Dims.make(("img", "pv", "pbox"), (1, 2, n_priors * 4), fd.tn)]


@_op_info("DetectionOutput", min_bots=3, max_bots=3)
def _calc_detout(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    keep = int(op.p("keep_top_k", 200))
    n = ind["img"] if "img" in ind.names else ind.sizes[0]
    # Caffe emits (1, 1, num_dets, 7); this is its fixed-shape padded analog
    return [Dims.make(("img", "lvl", "det", "attr"), (1, 1, n * keep, 7), ind.tn)]


# -- the math ------------------------------------------------------------------------

def _reshape_rule(pipe: ConvPipe, op: ConvOp) -> Callable:
    shape = pipe.must_dims(op.tops[0]).shape

    def fn(x):
        return (x.reshape(shape),)
    return fn


def _normalize_math(x, scales, *, chan_axis: int, across_spatial: bool, eps: float,
                    out_dtype):
    """SSD's L2 Normalize in f32: x / sqrt(sum x^2 + eps) * scale, the sum
    over the channel axis (or over all but the batch), cast to out_dtype."""
    x32 = x.float()
    red = tuple(range(1, x.dim())) if across_spatial else chan_axis
    norm = torch.sqrt(torch.sum(x32 * x32, dim=red, keepdim=True) + eps)
    shape = [1] * x.dim()
    shape[chan_axis] = -1
    s = scales.float()
    s = s.reshape(()) if s.numel() == 1 else s.reshape(shape)
    return (x32 / norm * s).to(out_dtype)


def _compute_priors(op: ConvOp, feat_d: Dims, img_d: Dims) -> np.ndarray:
    """The prior-box table on the host (Caffe SSD's PriorBoxLayer::
    Forward_cpu): (2, n_priors*4) float32, row 0 the boxes, row 1 the
    variances."""
    mins, maxs, ars, n_per_loc = _prior_geometry(op)
    clip = bool(op.p("clip", False))
    offset = float(op.p("offset", 0.5))
    variance = [float(v) for v in op.p("variance") or [0.1]]
    if len(variance) == 1:
        variance = variance * 4
    lh, lw = feat_d["y"], feat_d["x"]
    ih, iw = img_d["y"], img_d["x"]
    step_h = float(op.p("step_h", 0) or op.p("step", 0)) or ih / lh
    step_w = float(op.p("step_w", 0) or op.p("step", 0)) or iw / lw
    boxes = np.empty((lh, lw, n_per_loc, 4), np.float32)
    wh = []
    for mn in mins:
        wh.append((mn, mn))                      # ar = 1
        for mx in maxs:
            s = math.sqrt(mn * mx)               # the second ar = 1 box
            wh.append((s, s))
        for ar in ars[1:]:
            wh.append((mn * math.sqrt(ar), mn / math.sqrt(ar)))
    assert len(wh) == n_per_loc
    cy = (np.arange(lh, dtype=np.float32) + offset) * step_h
    cx = (np.arange(lw, dtype=np.float32) + offset) * step_w
    for k, (bw, bh) in enumerate(wh):
        boxes[:, :, k, 0] = (cx[None, :] - bw / 2.0) / iw
        boxes[:, :, k, 1] = (cy[:, None] - bh / 2.0) / ih
        boxes[:, :, k, 2] = (cx[None, :] + bw / 2.0) / iw
        boxes[:, :, k, 3] = (cy[:, None] + bh / 2.0) / ih
    if clip:
        boxes = np.clip(boxes, 0.0, 1.0)
    flat = boxes.reshape(-1)
    var = np.tile(np.asarray(variance, np.float32), flat.size // 4)
    return np.stack([flat, var])


def _decode_center_size(loc, pb, pv):
    """CENTER_SIZE decode (Caffe's bbox_util DecodeBBox, variance-scaled):
    loc (..., P, 4), pb and pv (P, 4)."""
    pw = pb[:, 2] - pb[:, 0]
    ph = pb[:, 3] - pb[:, 1]
    pcx = (pb[:, 0] + pb[:, 2]) * 0.5
    pcy = (pb[:, 1] + pb[:, 3]) * 0.5
    cx = pv[:, 0] * loc[..., 0] * pw + pcx
    cy = pv[:, 1] * loc[..., 1] * ph + pcy
    w = torch.exp(pv[:, 2] * loc[..., 2]) * pw
    h = torch.exp(pv[:, 3] * loc[..., 3]) * ph
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def _decode_corner(loc, pb, pv):
    return pb[None] + pv[None] * loc


def _pairwise_iou(b):
    """(..., K, 4) -> (..., K, K) IoU (Caffe's JaccardOverlap)."""
    area = torch.clamp_min(b[..., 2] - b[..., 0], 0) * torch.clamp_min(b[..., 3] - b[..., 1], 0)
    x0 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _top_k(x, k: int):
    """The k largest of the last axis, descending, the lower index first
    among equal values (``lax.top_k``'s order; ``torch.topk`` promises no
    order among ties): a stable descending sort, sliced."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _suppress_loop(ok0, sup):
    """The k-step greedy suppression over any leading dims: candidate i is
    kept if it passes the confidence test ``ok0`` and no kept j < i has
    ``sup[j, i]``. Two launches per step for all rows at once: candidate
    i's column of the test and its ok0 form a row of ``a``, and the kept
    mask, with a constant 1 after it, dotted with that row gives
    ok0[i] - (kept suppressors of i), which clamped at 0 is the decision."""
    lead, k = ok0.shape[:-1], ok0.shape[-1]
    rows = ok0.numel() // max(k, 1)
    sup_t = sup.reshape(rows, k, k).transpose(1, 2)     # sup_t[r, i, j] = sup[r, j, i]
    a = torch.cat([-sup_t.float(), ok0.reshape(rows, k, 1).float()], dim=2)
    keep = torch.zeros((rows, k + 1), dtype=torch.float32, device=ok0.device)
    keep[:, k] = 1.0
    kv = keep.unsqueeze(1)                              # (rows, 1, k + 1)
    for i in range(k):
        dot = torch.bmm(kv, a[:, i, :, None])           # (rows, 1, 1)
        torch.clamp_min(dot.view(rows, 1), 0.0, out=keep[:, i:i + 1])
    return (keep[:, :k] > 0.5).reshape(*lead, k)


def _suppress_fixpoint(ok0, sup):
    """The same greedy result by the parallel fixpoint of the recurrence
    K[i] = ok0[i] and not any_{j<i} (K[j] and sup[j, i]), reapplied until
    nothing changes (at most k times). It stops on a test of the data, a
    host wait, so it cannot be captured: it is on no engine path and is
    held equal to the loop by the tests."""
    k = ok0.shape[-1]
    rng = torch.arange(k, device=ok0.device)
    sup_m = (sup & (rng[:, None] < rng[None, :])).float()
    keep = ok0
    for _ in range(k):
        hit = (keep.float().unsqueeze(-2) @ sup_m).squeeze(-2) > 0.5
        new = ok0 & ~hit
        changed = bool((new != keep).any())
        keep = new
        if not changed:
            break
    return keep


def _greedy_nms(scores, boxes, k: int, nms_thresh: float, conf_thresh: float,
                method: str = "loop"):
    """Fixed-shape greedy NMS over the leading dims of ``scores`` (..., P)
    and ``boxes`` (..., P, 4): the top k by score, then suppression.
    Returns (scores_k, boxes_k, keep_mask_k). ``loop`` (the default, and
    the engine's) is the k-step sequential suppression; ``fixpoint`` gives
    the same result by iterating the recurrence in parallel, and waits on
    the host (:func:`_suppress_fixpoint`)."""
    sc, idx = _top_k(scores, k)
    b = torch.gather(boxes, -2, idx.unsqueeze(-1).expand(*idx.shape, 4))
    sup = _pairwise_iou(b) > nms_thresh
    ok0 = sc > conf_thresh
    if method == "loop":
        keep = _suppress_loop(ok0, sup)
    elif method == "fixpoint":
        keep = _suppress_fixpoint(ok0, sup)
    else:
        raise ValueError(f"_greedy_nms: unknown method {method!r}")
    return sc, b, keep


def _detection_output_fn(op: ConvOp, n_classes: int, n_img: int, device,
                         top_k_override: int = 0):
    """DetectionOutput for a batch of ``n_img`` images: decode, greedy NMS
    per (image, class) over all of them at once, then each image's
    keep_top_k across classes. Computes in f32 and returns the (1, 1,
    n_img * keep_top_k, 7) rows [image, label, score, x0, y0, x1, y1] in
    loc's dtype. The labels and image ids are made on ``device`` here."""
    bg = int(op.p("background_label_id", 0))
    share = bool(op.p("share_location", True))
    nms_thresh = float(op.p("nms_threshold", 0.3))
    top_k = int(op.p("top_k", 400) or 400)
    if top_k_override:
        # the serving knob (tune.det_top_k): fewer NMS candidates, a shorter
        # suppression loop and a smaller IoU matrix; Caffe parity needs the
        # prototxt's own top_k, and a smaller one drops candidates below it
        top_k = top_k_override
    keep_top_k = int(op.p("keep_top_k", 200))
    conf_thresh = float(op.p("confidence_threshold", 0.01))
    code = op.p("code_type", "CENTER_SIZE")
    if not share:
        raise PipeError(f"op {op.name!r}: share_location=false unsupported")
    cls_ids = [c for c in range(n_classes) if c != bg]
    lo, hi = (bg, bg + 1) if 0 <= bg < n_classes else (n_classes, n_classes)
    labels = torch.tensor(cls_ids, dtype=torch.float32).to(device)
    img_ids = torch.arange(n_img, dtype=torch.float32).reshape(n_img, 1, 1) \
        .expand(n_img, keep_top_k, 1).contiguous().to(device)

    def fn(loc, conf, priors):
        n = loc.shape[0]
        pb = priors[0, 0].reshape(-1, 4).float()
        pv = priors[0, 1].reshape(-1, 4).float()
        p = pb.shape[0]
        k = min(top_k, p)
        locs = loc.reshape(n, p, 4).float()
        confs = conf.reshape(n, p, n_classes).float()
        dec = _decode_center_size(locs, pb, pv) if code == "CENTER_SIZE" \
            else _decode_corner(locs, pb, pv)
        conf_c = torch.cat([confs[..., :lo], confs[..., hi:]], dim=-1).transpose(1, 2)
        cp = conf_c.shape[1]
        sc, b, keep = _greedy_nms(conf_c, dec[:, None].expand(n, cp, p, 4), k,
                                  nms_thresh, conf_thresh)
        sck = torch.where(keep, sc, -1.0).reshape(n, cp * k)
        kk = min(keep_top_k, cp * k)
        best, bidx = _top_k(sck, kk)
        sel_b = torch.gather(b.reshape(n, cp * k, 4), 1, bidx.unsqueeze(-1).expand(n, kk, 4))
        valid = best > 0
        lab = torch.where(valid, labels[bidx // k], -1.0)
        out = torch.cat([lab[..., None], torch.where(valid, best, 0.0)[..., None], sel_b],
                        dim=2)                                      # (n, kk, 6)
        if kk < keep_top_k:
            pad = out.new_zeros((n, keep_top_k - kk, 6))
            pad[..., 0] = -1.0
            out = torch.cat([out, pad], dim=1)
        dets = torch.cat([img_ids[:n], out], dim=2).reshape(1, 1, -1, 7)
        return (dets.to(loc.dtype),)
    return fn


# -- logical rules (boda_tpu: ssd_ops.py:173-434): the xla engine's, the NCHW route's --

@lower_rule("Permute")
def _lower_permute(pipe, op, ctx):
    order = tuple(op.p("order"))
    return lambda x: (x.permute(order),)


@lower_rule("Flatten")
def _lower_flatten(pipe, op, ctx):
    return _reshape_rule(pipe, op)


@lower_rule("Reshape")
def _lower_reshape(pipe, op, ctx):
    return _reshape_rule(pipe, op)


@lower_rule("Normalize")
def _lower_normalize(pipe, op, ctx):
    across = bool(op.p("across_spatial", False))
    eps = float(op.p("eps", 1e-10))
    return lambda x, scales: (_normalize_math(x, scales, chan_axis=1, across_spatial=across,
                                              eps=eps, out_dtype=x.dtype),)


@lower_rule("PriorBox")
def _lower_priorbox(pipe, op, ctx):
    """The table, made once here on the engine's device."""
    pri = torch.from_numpy(_compute_priors(op, pipe.must_dims(op.bots[0]),
                                           pipe.must_dims(op.bots[1]))[None]).to(ctx.device)
    return lambda feat, data: (pri,)


@lower_rule("DetectionOutput")
def _lower_detout(pipe, op, ctx):
    """The head with the prototxt's own top_k (boda_tpu's logical rule takes
    no det_top_k)."""
    ind = pipe.must_dims(op.bots[0])
    n_img = ind["img"] if "img" in ind.names else ind.sizes[0]
    return _detection_output_fn(op, int(op.p("num_classes")), n_img, ctx.device)


# -- NHWC rules: a canonical 4-D (physically NHWC) input turned logical first ------

def _nhwc_logicalize(pipe: ConvPipe, op: ConvOp, fn: Callable,
                     n_data_bots: int = 1) -> Callable:
    """Wrap fn so that its canonical 4-D data inputs arrive as logical NCHW."""
    need = [i for i in range(n_data_bots) if _is_canon4d(pipe.must_dims(op.bots[i]))]
    if not need:
        return fn

    def wrapped(*args):
        args = list(args)
        for i in need:
            args[i] = args[i].permute(0, 3, 1, 2)
        return fn(*args)
    return wrapped


def _nhwc_out(pipe: ConvPipe, op: ConvOp, fn: Callable) -> Callable:
    """Wrap a rule whose math yields the logical layout so that a top with
    canonical dims (img, chan, y, x), which the engine holds physically
    NHWC, comes out NHWC. boda_tpu's NHWC rules leave it logical, so a
    Permute or Reshape back to those dims reads transposed there (its NCHW
    engine is right): the port does not copy that."""
    if not _is_canon4d(pipe.must_dims(op.tops[0])):
        return fn

    def wrapped(*args):
        return tuple(o.permute(0, 2, 3, 1).contiguous() for o in fn(*args))
    return wrapped


@nhwc_rule("Permute")
def _nhwc_permute(pipe, op, ctx, tune, info_log):
    order = tuple(op.p("order"))
    if _is_canon4d(pipe.must_dims(op.bots[0])):
        # the input is physically (img, y, x, chan), the logical axes
        # (0, 2, 3, 1): the logical permute straight from the physical layout
        # (a canonical top comes out physically NHWC this way too)
        phys_of_logical = {0: 0, 2: 1, 3: 2, 1: 3}
        perm = tuple(phys_of_logical[o] for o in order)
        return _no_preps(lambda x: (x.permute(perm),))
    return _no_preps(_nhwc_out(pipe, op, lambda x: (x.permute(order),)))


@nhwc_rule("Flatten")
def _nhwc_flatten(pipe, op, ctx, tune, info_log):
    return _no_preps(_nhwc_out(pipe, op, _nhwc_logicalize(pipe, op, _reshape_rule(pipe, op))))


@nhwc_rule("Reshape")
def _nhwc_reshape(pipe, op, ctx, tune, info_log):
    return _no_preps(_nhwc_out(pipe, op, _nhwc_logicalize(pipe, op, _reshape_rule(pipe, op))))


@nhwc_rule("Normalize")
def _nhwc_normalize(pipe, op, ctx, tune, info_log):
    across = bool(op.p("across_spatial", False))
    eps = float(op.p("eps", 1e-10))
    chan_axis = 3 if _is_canon4d(pipe.must_dims(op.bots[0])) else 1

    def fn(x, scales):
        return (_normalize_math(x, scales, chan_axis=chan_axis, across_spatial=across,
                                eps=eps, out_dtype=x.dtype),)
    return _no_preps(fn)


@nhwc_rule("PriorBox")
def _nhwc_priorbox(pipe, op, ctx, tune, info_log):
    """The table is a constant: made once here, on the engine's device, and
    returned by every forward (boda_tpu's XLA folds it into the program)."""
    pri = torch.from_numpy(_compute_priors(op, pipe.must_dims(op.bots[0]),
                                           pipe.must_dims(op.bots[1]))[None]).to(ctx.device)
    return _no_preps(lambda feat, data: (pri,))


@nhwc_rule("DetectionOutput")
def _nhwc_detout(pipe, op, ctx, tune, info_log):
    k_over = int(getattr(tune, "det_top_k", 0))
    if k_over:
        info_log.append(f"{op.name}: det_top_k={k_over} (serving latency "
                        f"knob; caffe parity uses the prototxt top_k)")
    ind = pipe.must_dims(op.bots[0])
    n_img = ind["img"] if "img" in ind.names else ind.sizes[0]
    fn = _detection_output_fn(op, int(op.p("num_classes")), n_img, ctx.device,
                              top_k_override=k_over)
    return _no_preps(_nhwc_logicalize(pipe, op, fn, n_data_bots=3))
