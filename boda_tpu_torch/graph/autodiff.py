"""Graph-level autodiff: append backward ops to a ConvPipe.

Counterpart of ``boda_tpu/graph/autodiff.py``, copied (pure Python): the
graph it builds is boda_tpu's op for op, node for node.

Parity target: ``add_bck_ops`` (ref src/conv_util.cc:753-877): the reference
appends explicit gradient ops (BckConv producing in/filts/biases grads,
Spreading for pooling, ZeroIfNonPos for ReLU, BckLRN, BckDropout, SoftmaxWithLoss
grad) to the same dataflow graph, so gradients flow through the same engine and
regression harness as the forward ops.

Design: one generic ``Bck`` op type per forward op. The engine lowers it as
the autograd of the forward op's library lowering rule, or, for an eligible
conv, as the hand backward kernels (graph/executor.py). Gradient of node X
lives in node ``X__grad``; fan-out accumulates partial grads ``X__grad__pN``
through an explicit GradAccum (Eltwise-sum) op.

If the net ends in Softmax, it is converted to SoftmaxWithLoss with a new
``label`` input (the reference's gradient test configs do the same via net
surgery) and the loss gradient is seeded inside the SoftmaxWithLoss backward.
"""

from __future__ import annotations

from ..utils.dims import Dims
from .pipe import OP_INFOS, ConvOp, ConvPipe, OpInfo, PipeError

GRAD_SUFFIX = "__grad"


def _register_bck_types() -> None:
    if "Bck" in OP_INFOS:
        return
    OP_INFOS["Bck"] = OpInfo("Bck", 1, -1, -1, calc=_calc_bck)
    OP_INFOS["GradAccum"] = OpInfo("GradAccum", 2, -1, 1, calc=_calc_gradaccum)


def _calc_bck(pipe: ConvPipe, op: ConvOp):
    fwd = pipe.ops[op.p("fwd_op")]
    return [pipe.must_dims(b) for b in fwd.bots if _wants_grad(pipe, op, b)]


def _calc_gradaccum(pipe: ConvPipe, op: ConvOp):
    return [pipe.must_dims(op.bots[0])]


def _wants_grad(pipe: ConvPipe, op: ConvOp, bot: str) -> bool:
    """Which forward bots get gradients: data nodes and trainable weights,
    but not BN statistics or integer labels."""
    if bot.endswith(("__means", "__vars", "__sf")):
        return False
    if bot == "label":
        return False
    return True


def softmax_to_loss(pipe: ConvPipe) -> str:
    """Replace a final Softmax with SoftmaxWithLoss + label input (net surgery,
    the ref gradient-config pattern). Returns the loss node name."""
    sm_ops = [o for o in pipe.ops.values()
              if o.type == "Softmax" and not pipe.nodes[o.tops[0]].bot_for]
    if not sm_ops:
        # already has a loss?
        losses = [o for o in pipe.ops.values() if o.type == "SoftmaxWithLoss"]
        if losses:
            return losses[0].tops[0]
        raise PipeError("add_bck_ops: net has no final Softmax/SoftmaxWithLoss")
    sm = sm_ops[0]
    logits = sm.bots[0]
    img = pipe.must_dims(logits)["img"]
    label = pipe.get_or_make_node("label")
    label.dims = Dims.of(img=img, tn="float32")
    loss_name = f"{sm.name}_loss"
    # rewrite the op in place (keep graph order)
    del pipe.ops[sm.name]
    idx = pipe.op_order.index(sm.name)
    pipe.op_order.pop(idx)
    pipe.nodes[sm.tops[0]].top_for.remove(sm.name)
    pipe.nodes[logits].bot_for.remove(sm.name)
    new_op = ConvOp(sm.name, "SoftmaxWithLoss", {},
                    bots=[logits, "label"], tops=[loss_name, sm.tops[0]])
    pipe.ops[sm.name] = new_op
    pipe.op_order.insert(idx, sm.name)
    pipe.nodes[logits].bot_for.append(sm.name)
    label.bot_for.append(sm.name)
    ln = pipe.get_or_make_node(loss_name)
    ln.top_for.append(sm.name)
    ln.dims = Dims.of(img=img, tn="float32")
    pipe.nodes[sm.tops[0]].top_for.append(sm.name)
    pipe.infer_op_dims(sm.name)
    return loss_name


def add_bck_ops(pipe: ConvPipe, loss_node: str | None = None) -> None:
    """Append backward ops computing d(loss)/d(node) for every node feeding
    the loss (ref add_bck_ops, conv_util.cc:862)."""
    _register_bck_types()
    if pipe.bck_added:
        return
    if loss_node is None:
        loss_node = softmax_to_loss(pipe)

    # nodes contributing to the loss
    live: set[str] = set()

    def mark(node: str):
        if node in live:
            return
        live.add(node)
        for op_name in pipe.nodes[node].top_for:
            for b in pipe.ops[op_name].bots:
                mark(b)

    mark(loss_node)

    fwd_order = pipe.topo_op_order()
    # gradient contributions per node: node -> list of partial grad node names
    contribs: dict[str, list[str]] = {loss_node: []}

    for op_name in reversed(fwd_order):
        op = pipe.ops[op_name]
        if not any(t in live for t in op.tops):
            continue
        # resolve incoming grads of this op's tops (accumulate fan-out)
        top_grads = []
        for t in op.tops:
            g = _resolve_grad(pipe, t, contribs, loss_node)
            top_grads.append(g)
        if all(g is None for g in top_grads) and op.type != "SoftmaxWithLoss":
            continue
        grad_bots = [b for b in op.bots if _wants_grad(pipe, op, b)]
        if not grad_bots:
            continue
        bck_name = f"{op_name}__bck"
        bots = list(op.bots)
        for t, g in zip(op.tops, top_grads):
            if op.type == "SoftmaxWithLoss" and t == loss_node:
                continue  # loss grad is seeded (ones) inside the Bck lowering
            if g is not None:
                bots.append(g)
        tops = []
        for b in grad_bots:
            pg = f"{b}{GRAD_SUFFIX}__p{len(contribs.get(b, []))}"
            contribs.setdefault(b, []).append(pg)
            tops.append(pg)
        bck = ConvOp(bck_name, "Bck",
                     {"fwd_op": op_name,
                      "top_has_grad": [t for t, g in zip(op.tops, top_grads)
                                       if g is not None],
                      "loss_node": loss_node},
                     bots=bots, tops=tops)
        pipe.add_op(bck)
        pipe.infer_op_dims(bck_name)
    pipe.bck_added = True
    pipe.calc_support_info()


def _resolve_grad(pipe: ConvPipe, node: str, contribs: dict, loss_node: str):
    """Final gradient node name for ``node`` (inserting accumulation ops)."""
    if node == loss_node:
        return None  # seeded in the loss backward
    parts = contribs.get(node)
    if not parts:
        return None
    gname = f"{node}{GRAD_SUFFIX}"
    if pipe.nodes.get(gname) and pipe.nodes[gname].dims is not None:
        return gname
    if len(parts) == 1:
        # single contribution: alias via a copy-free Split-style rename —
        # just use the partial directly but expose the canonical name too
        if parts[0] != gname:
            acc = ConvOp(f"{gname}__accum", "GradAccum", {}, bots=[parts[0]],
                         tops=[gname])
            OP_INFOS["GradAccum"].min_bots = 1
            pipe.add_op(acc)
            pipe.infer_op_dims(acc.name)
        return gname
    acc = ConvOp(f"{gname}__accum", "GradAccum", {}, bots=list(parts),
                 tops=[gname])
    pipe.add_op(acc)
    pipe.infer_op_dims(acc.name)
    return gname
