"""Training step over a ConvPipe: loss, gradients and SGD on PyTorch.

Counterpart of ``boda_tpu/parallel/train.py``. boda_tpu takes
``jax.value_and_grad`` of the whole net as one jitted program, and its
callers jit the step with its weights and momentum donated; the port runs
the net's NHWC rules (graph/lowering_nhwc.py) with ``train`` set, under
autograd, and on the card captures that step once per key as one CUDA graph
(:class:`CapturedStep`) that each call replays:

* weights are held in boda_tpu's logical layouts (conv filters OIHW, fc
  (out, in)); each rule's upload layout (HWIO for the hand conv, the fc's
  NHWC-permuted (in, out), OHWI for the library conv) is applied inside the
  differentiated function, so the gradients, the momentum and the
  checkpoints are in the logical layouts too. There is no prefold and no
  fusion chain: BN, Scale, ReLU and the residual add are their own ops.
* ``kernel_policy=gen``: every groups-1, dilation-1 conv and every fc runs
  the autograd Functions of ops/kernels/train_conv.py (K1/K2 forward, K3, K5
  and K1 backward, the library's backward for strided k > 1 convs);
  ``lib``: autograd of the library rules (cuDNN/cuBLAS), the counterpart of
  boda_tpu's stock XLA step. On CPU tensors both compute with the plain
  versions.
* train-mode BatchNorm (bn_momentum > 0): the batch's f32 mean and biased
  two-pass variance, and the EMA of the unscaled running stats with the
  scale factor pinned to 1;
* the update: gradients widened to f32, the global norm clipped in f32, f32
  momentum, decoupled weight decay, and one rounding to the weight's dtype;
* remat through ``torch.utils.checkpoint`` (non-reentrant): per spatial
  segment (``seg``), the whole net (``full``), or the whole net with a
  selective policy that keeps conv and matmul outputs (``dots``).
* data parallel over a ``torch.distributed`` process group (``group``):
  each rank steps its equal slice of the global batch and the step
  computes what boda_tpu's dp-sharded GSPMD step computes on the global
  batch. Train-mode BatchNorm takes its mean and two-pass variance over the
  global batch (each rank's statistic scaled by 1/world and summed by an
  all-reduce whose backward sums the cotangents over the ranks); the loss
  is the global mean; the gradients are summed
  over the ranks before the clip, one flat bucket per dtype, so every rank
  clips, steps its momentum and updates its weights alike. With one rank
  every all-reduce is the identity and the step is the step without a
  group, bit for bit.
* tensor parallel over a ``mesh`` (parallel/mesh.py) of axes dp and tp:
  each rank of the group (one rank, without a group) steps the tp row of
  its dp slice. Every weight that ``weight_shardings`` splits is held as
  ``Shards`` over the row (``shard_weights``); each groups-1 conv and fc
  with split filters runs ``tp_call``: its out_chan slice on each device of
  the row, on the hand kernels under gen, at the slice's width, the slices
  gathered on the row's first device (the lead), where BN, Scale, ReLU,
  the residual add, the pools and the loss run whole. Each shard's
  gradient, momentum and update stay on its device; the clip's global
  norm is taken on the lead from every tensor's f32 norm. A bias stays
  whole on the lead and is cut per slice; its gradient comes back whole.
  In bf16, each slice's input gradient is rounded by its kernel before the
  slices sum on the lead: tp roundings where the unsplit conv has one. A
  row over several devices runs its backward on the calling thread, in one
  order on every rank. A ``(tp=1)`` mesh splits nothing and is the step
  without a mesh, bit for bit.
* the compiled step (``cuda_graph``, which the training modes turn on, as
  boda_tpu's callers jit the step, its sharded form included): forward,
  backward, the collectives and the update are captured as one CUDA graph
  per key over static tensors that the step owns, and replayed; the
  weights and momenta it returns are those tensors (each shard's own under
  a mesh), overwritten by the next call (the counterpart of
  ``donate_argnums``). It is captured on CUDA tensors without a group or
  with an NCCL one, and without a mesh or with a mesh whose tp row for
  this rank lies on one card. Two cases stay eager, launch by launch, and
  the ``info_log`` says why: a gloo group (it reduces through the host,
  which a graph cannot hold) and a tp row over several cards (tp_call's
  copies between cards; a capture's pool belongs to one device). Any step
  on CPU tensors runs eagerly. Under a group every rank must step equal
  slices, so that all ranks meet the same sequence of keys: at a new key
  the ranks compare the key's digest before they capture, and raise where
  the keys differ.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import time
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np
import torch

from ..graph import train_ops
from ..graph.lowering import LowerCtx, lib_precision
from ..graph.lowering_nhwc import HWIO, lower_op_nhwc, pool_geom
from ..graph.pipe import ConvPipe, PipeError
from ..ops.kernels.train_conv import conv_route, gen_conv, gen_fc
from ..ops.tune import OpTune
from ..rtc.backends import capture, side_stream_warmup
from ..utils.dims import torch_dtype
from .mesh import Mesh, Shards, train_row, tp_call, weight_shardings

_CANON = ("img", "chan", "y", "x")


def find_logits_node(pipe: ConvPipe, prob_node: str = "prob") -> str:
    """The input of the Softmax producing ``prob_node`` (pre-softmax logits)."""
    node = pipe.nodes.get(prob_node)
    if node and node.top_for:
        op = pipe.ops[node.top_for[0]]
        if op.type == "Softmax":
            return op.bots[0]
    return prob_node


def spatial_segments(pipe: ConvPipe) -> list[list[str]]:
    """Partition the topo op order at spatial-resolution boundaries: the
    checkpoints of structured remat (resnet50: 112/56/28/14/7, ~5 segments,
    about one extra forward in all)."""
    segs: list[list[str]] = []
    cur: list[str] = []
    prev_y = None
    for op_name in pipe.topo_op_order():
        op = pipe.ops[op_name]
        y = None
        for t in op.tops:
            node = pipe.nodes.get(t)
            d = node.dims if node is not None else None
            if d is not None and "y" in d:
                y = d["y"]
                break
        if cur and y is not None and prev_y is not None and y != prev_y:
            segs.append(cur)
            cur = []
        cur.append(op_name)
        if y is not None:
            prev_y = y
    if cur:
        segs.append(cur)
    return segs


# weight-name suffixes that are statistics, not trainable parameters
_FROZEN_SUFFIXES = ("__means", "__vars", "__sf")


def is_trainable(name: str) -> bool:
    return not name.endswith(_FROZEN_SUFFIXES)


def _needed_ops(pipe: ConvPipe, out_names) -> set[str]:
    """The ops whose tops ``out_names`` depend on (an eager run computes no
    more: the prob softmax and a loss layer past the logits are skipped)."""
    need, ops = set(out_names), set()
    for op_name in reversed(pipe.topo_op_order()):
        op = pipe.ops[op_name]
        if any(t in need for t in op.tops):
            ops.add(op_name)
            need.update(op.bots)
    return ops


def _lower_train(pipe: ConvPipe, op, ctx: LowerCtx, gen: bool, info_log: list[str]):
    """(fn, weight preps) of one op in the training step."""
    tune = dataclasses.replace(OpTune(), use_xla=not gen, precision=ctx.precision)
    if op.type == "Convolution" and int(op.p("groups", 1)) == 1 \
            and op.dilation() == (1, 1):
        s, p, k = op.stride(), op.pad(), op.kern_sz()
        if gen:
            route = conv_route(k, s, p)
            info_log.append(f"{op.name}: train-conv k={k} s={s} p={p} fwd="
                            f"{'sgemm' if route == 'k1' else 'conv'} bck="
                            + {"k1": "sgemm+atb", "direct": "conv_nhwc+atb",
                               "library": "library (strided k>1)"}[route])

            def fn(x, w, b):
                return (gen_conv(x, w, b, stride=s, pad=p),)
            return fn, {op.bots[1]: HWIO}
        if k == (1, 1) and p == (0, 0) and train_ops.enabled():
            conv = train_ops.conv1x1_explicit(s)
            info_log.append(f"{op.name}: train-conv conv1x1_explicit s={s}")

            def fn(x, w, b):
                return ((conv(x, w) + b.float()).to(x.dtype),)
            return fn, {op.bots[1]: HWIO}
    if op.type == "Pooling" and train_ops.enabled() and not op.p("avg_pool", False):
        k, s, pad_y, pad_x, oy, ox, _ = pool_geom(pipe, op)
        ind = pipe.must_dims(op.bots[0])
        pool = train_ops.make_maxpool_vjp(tuple(k), tuple(s), pad_y, pad_x,
                                          ind["y"], ind["x"], oy, ox)
        return (lambda x: (pool(x),)), {}
    r = lower_op_nhwc(pipe, op, ctx, tune, info_log)
    if r is None:
        raise PipeError(f"no NHWC lowering for op type {op.type!r} (op {op.name!r})")
    fn, preps = r
    if op.type == "InnerProduct" and gen:  # the rule's weight prep, the hand kernels
        return (lambda x, w, b: (gen_fc(x.reshape(x.shape[0], -1), w, b),)), preps
    return fn, preps


class _GlobalMean(torch.autograd.Function):
    """The mean over (n, y, x) of an NHWC tensor over the global batch of a
    process group: each rank's mean of its equal slice, scaled by 1/world,
    summed by an all-reduce. Its backward is the mean's on the cotangent
    summed over the ranks (each rank's output feeds that rank's share of the
    global loss). One node, as the mean without a group is one, so that with
    one rank the backward accumulates in the same order, bit for bit."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group, ctx.shape = group, x.shape
        ctx.scale = 1.0 / dist.get_world_size(group)
        return train_ops.all_reduce_sum(x.mean(dim=(0, 1, 2)) * ctx.scale, group)

    @staticmethod
    def backward(ctx, g):
        g = train_ops.all_reduce_sum(g, ctx.group) * ctx.scale
        n, h, w, c = ctx.shape
        return g.reshape(1, 1, 1, c).expand(ctx.shape) / (n * h * w), None


def _bn_train(op, vals: dict, new_stats: dict, bn_momentum: float, group=None):
    """Train-mode BatchNorm (boda_tpu: train.py:82-111): normalize with the
    batch's f32 mean over (n, y, x) and biased two-pass variance, cast back;
    EMA the unscaled running stats into ``new_stats`` with sf pinned to 1.
    With a process group, the batch is the global one."""
    x = vals[op.bots[0]]
    eps = float(op.p("eps", 1e-5))
    if train_ops.enabled():
        out, m_b, v_b = train_ops.make_bn_train(eps, group)(x)
    else:
        xf = x.float()
        m_b = xf.mean(dim=(0, 1, 2)) if group is None else _GlobalMean.apply(xf, group)
        xc = xf - m_b
        v_b = (xc * xc).mean(dim=(0, 1, 2)) if group is None else \
            _GlobalMean.apply(xc * xc, group)
        out = xc * torch.rsqrt(v_b + eps)
    mean_w, var_w = op.bots[1], op.bots[2]
    with torch.no_grad():
        one = torch.ones((), device=x.device)
        sf = vals[op.bots[3]][0].float() if len(op.bots) > 3 else one
        inv_sf = torch.where(sf != 0, 1.0 / sf, one)
        old_m = vals[mean_w].float() * inv_sf
        old_v = vals[var_w].float() * inv_sf
        new_stats[mean_w] = ((1 - bn_momentum) * old_m
                             + bn_momentum * m_b.detach()).to(vals[mean_w].dtype)
        new_stats[var_w] = ((1 - bn_momentum) * old_v
                            + bn_momentum * v_b.detach()).to(vals[var_w].dtype)
        if len(op.bots) > 3:
            new_stats[op.bots[3]] = torch.ones_like(vals[op.bots[3]])
    return (out.to(x.dtype),)


def _group_shape(group) -> tuple[int, int]:
    """(world size, rank) of a process group; (1, 0) without one."""
    if group is None:
        return 1, 0
    import torch.distributed as dist
    return dist.get_world_size(group), dist.get_rank(group)


def _splits_out_chan(op) -> bool:
    """Whether tp runs the op per out_chan slice: a groups-1 conv or an fc
    (the engine's rule)."""
    return op.type == "InnerProduct" or \
        (op.type == "Convolution" and int(op.p("groups", 1)) == 1)


def build_net_fn(pipe: ConvPipe, out_names: list[str],
                 ctx: Optional[LowerCtx] = None,
                 bn_momentum: float = 0.0,
                 segments: Optional[list[list[str]]] = None,
                 kernel_policy: str = "gen",
                 info_log: Optional[list[str]] = None,
                 group=None, mesh: Optional[Mesh] = None) -> Callable:
    """fn(weights, inputs) -> {name: tensor}: the net's rules on channels-last
    tensors, weights in the logical layouts, inputs and outputs logical
    (NCHW for canonical nodes). bn_momentum > 0 switches BatchNorm to its
    training semantics and adds the EMA running stats under
    ``"__bn_stats__"``. ``segments`` (from :func:`spatial_segments`) runs
    each segment under a non-reentrant ``torch.utils.checkpoint``: its
    backward recomputes it from its boundary inputs. ``info_log`` collects
    the rules' lines. ``group``: train-mode BatchNorm over the global
    batch of the group's ranks. ``mesh``: the weights that it splits come
    as ``Shards`` over this rank's tp row, and the convs and fcs that read
    them run ``tp_call`` over the row (module docstring); any other op
    reads a split weight gathered on the lead. An exception raised in an
    op carries the note ``at op '<name>'`` (a failed capture names it)."""
    if kernel_policy not in ("gen", "lib"):
        raise PipeError(f"kernel_policy {kernel_policy!r}: gen | lib")
    ctx = ctx or LowerCtx(train=True)
    log = info_log if info_log is not None else []
    row = train_row(mesh, *_group_shape(group)) if mesh is not None else None
    need = _needed_ops(pipe, out_names)
    topo = [o for o in pipe.topo_op_order() if o in need]
    lowered, preps = {}, {}
    for name in topo:
        fn, pr = _lower_train(pipe, pipe.ops[name], ctx, kernel_policy == "gen", log)
        lowered[name] = fn
        preps.update(pr)
    # a split weight stays split only where every op reads it as the
    # filters of a conv or fc that tp runs per slice (a grouped conv's, say,
    # is read whole, gathered on the lead)
    whole_reads = {b for name in topo for i, b in enumerate(pipe.ops[name].bots)
                   if i != 1 or not _splits_out_chan(pipe.ops[name])}
    if row is not None:
        split = [k for k, sp in weight_shardings(pipe, mesh).items() if "tp" in sp]
        log.append(f"mesh {mesh}: this rank's tp row {[str(d) for d in row]}; "
                   f"{len(split)} weights split over out_chan, "
                   f"{len([k for k in split if k not in whole_reads])} of them run per slice")

    def canon(n):
        node = pipe.nodes.get(n)
        return node is not None and node.dims is not None and node.dims.names == _CANON

    def run_op(op, vals, new_stats):
        if bn_momentum > 0 and op.type == "BatchNorm":
            return _bn_train(op, vals, new_stats, bn_momentum, group)
        args = [vals[b] for b in op.bots]
        if len(args) > 1 and isinstance(args[1], Shards):
            return tp_call(lowered[op.name], args, row)
        return lowered[op.name](*args)

    def run_ops(op_names, vals, new_stats):
        # a profiler range per op (train_trace's attribution), only while a
        # torch profiler records: outside a trace no range is entered
        ranges = torch.autograd.profiler._is_profiler_enabled
        for op_name in op_names:
            op = pipe.ops[op_name]
            try:
                if ranges:
                    with torch.profiler.record_function(op_name):
                        outs = run_op(op, vals, new_stats)
                else:
                    outs = run_op(op, vals, new_stats)
            except Exception as e:
                e.add_note(f"at op {op_name!r}")
                raise
            vals.update(zip(op.tops, outs))

    def enter(weights, inputs):
        vals = {k: v.permute(0, 2, 3, 1).contiguous() if canon(k) else v
                for k, v in inputs.items()}
        for k, w in weights.items():
            if isinstance(w, Shards) and k in whole_reads:
                w = w.gather()
            p = preps.get(k)
            if p is None:
                vals[k] = w
            else:  # a split weight's prep per shard: out_chan moves to p.oc_axis
                vals[k] = w.map(p.prep, p.oc_axis) if isinstance(w, Shards) else p.prep(w)
        return vals

    def leave(vals, new_stats):
        res = {n: vals[n].permute(0, 3, 1, 2) if canon(n) else vals[n] for n in out_names}
        if bn_momentum > 0:
            res["__bn_stats__"] = new_stats
        return res

    if segments is None:
        def net_fn(weights, inputs):
            vals = enter(weights, inputs)
            new_stats: dict = {}
            run_ops(topo, vals, new_stats)
            return leave(vals, new_stats)
        return net_fn

    # structured remat: per-segment in/out name sets, each segment run under
    # a checkpoint that keeps only its boundary inputs
    from torch.utils.checkpoint import checkpoint
    segments = [[o for o in s if o in need] for s in segments]
    segments = [s for s in segments if s]
    need_after = set(out_names)
    seg_ins: list[set] = [set() for _ in segments]
    seg_outs: list[set] = [set() for _ in segments]
    for i in range(len(segments) - 1, -1, -1):
        prod = {t for o in segments[i] for t in pipe.ops[o].tops}
        seg_outs[i] = prod & need_after
        cons = {b for o in segments[i] for b in pipe.ops[o].bots}
        seg_ins[i] = cons - prod
        need_after = (need_after - prod) | seg_ins[i]

    def make_seg(seg_ops, outs_s):
        def f(vin):
            vals = dict(vin)
            stats: dict = {}
            run_ops(seg_ops, vals, stats)
            return {n: vals[n] for n in outs_s}, stats
        return lambda vin: checkpoint(f, vin, use_reentrant=False, preserve_rng_state=False)

    seg_fns = [(make_seg(s, seg_outs[i]), sorted(seg_ins[i])) for i, s in enumerate(segments)]

    def net_fn(weights, inputs):
        vals = enter(weights, inputs)
        new_stats: dict = {}
        for f, ins_s in seg_fns:
            outs, stats = f({n: vals[n] for n in ins_s})
            vals.update(outs)
            new_stats.update(stats)
        return leave(vals, new_stats)
    return net_fn


def _tagged(tag: str):
    """A profiler range named ``tag`` while a torch profiler records, else
    nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(tag)
    return contextlib.nullcontext()


def _dots_context():
    """remat=dots: a selective checkpoint that keeps the library's conv and
    matmul outputs and recomputes the rest (the hand kernels' launches are
    not aten ops, so under gen on the card nothing is kept: a full remat)."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts
    aten = torch.ops.aten
    kept = {aten.convolution.default, aten.mm.default, aten.addmm.default, aten.bmm.default}

    def policy(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in kept else CheckpointPolicy.PREFER_RECOMPUTE
    return create_selective_checkpoint_contexts(policy)


def _parts(v) -> list:
    """The tensors of a weight or momentum: a Shards' parts, or the tensor."""
    return list(v) if isinstance(v, Shards) else [v]


def _sig(d: dict) -> tuple:
    """A dict of tensors' part of a captured step's key: per entry its
    shape, dtype and device, per part for a Shards (with its axis)."""
    def one(v):
        return (tuple(v.shape), v.dtype, v.device)
    return tuple((k, ("shards", v.axis, tuple(one(p) for p in v)) if isinstance(v, Shards)
                  else one(v)) for k, v in d.items())


def _copy_in(static, given) -> int:
    """Copy each part of ``given`` that is not the static tensor itself into
    it; the number of parts copied."""
    n = 0
    for s, t in zip(_parts(static), _parts(given)):
        if t is not s:
            s.copy_(t)
            n += 1
    return n


def _key_digest(key) -> int:
    """A key's digest, alike on every rank: devices by their type (each
    rank steps on its own card), below 2**56 so that it and its negation
    are exact in an int64."""
    def strip(o):
        if isinstance(o, torch.device):
            return o.type
        return tuple(strip(x) for x in o) if isinstance(o, tuple) else o
    return int.from_bytes(hashlib.sha256(repr(strip(key)).encode()).digest()[:7], "little")


def check_ranks_key(key, group, device: torch.device, what: str) -> None:
    """Raise unless every rank of ``group`` meets the same new key: one
    small eager all-reduce (MAX of the digest and of its negation) before
    any warm-up or capture. A rank that captured while another replayed
    would pair a warm-up's collective with a replayed one, and hang or
    reduce garbage."""
    import torch.distributed as dist
    d = _key_digest(key)
    t = torch.tensor([d, -d], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    hi, lo = int(t[0]), -int(t[1])
    if hi != lo:
        raise RuntimeError(
            f"train step: rank {dist.get_rank(group)} of {dist.get_world_size(group)} meets "
            f"a new key that differs from another rank's ({what}; digest {d:014x}, the ranks' "
            f"{lo:014x}..{hi:014x}); every rank must step equal slices of the global batch, "
            f"so that all meet the same sequence of keys")


def capture_step(body: Callable[[], None], warm: Callable[[], object], device: torch.device):
    """The handle whose ``replay()`` runs ``body``. On the card: ``body``
    captured as one CUDA graph after two eager ``warm`` steps on a side
    stream (the kernels' builds and shared-memory attributes, the plan
    caches, the libraries' algorithm choices, the pools' divisors), under
    rtc/backends.py's ``capture``; the capture runs nothing. A capture that
    fails raises, naming where it was (the notes ``build_net_fn``'s ops and
    the backward add to the exception); nothing runs eagerly in its place.
    On the CPU there is no graph: ``body`` runs at each replay."""
    if device.type != "cuda":
        return SimpleNamespace(replay=body)
    with torch.cuda.device(device):
        side_stream_warmup(warm, 2, device)
        torch.cuda.synchronize(device)
        graph = torch.cuda.CUDAGraph()
        try:
            with capture(graph, torch.cuda.Stream(device)):
                body()
        except Exception as e:
            at = "; ".join(getattr(e, "__notes__", ())) or "outside the net's ops"
            raise RuntimeError(f"train step: the CUDA-graph capture failed {at}: "
                               f"{type(e).__name__}: {e}") from e
    return graph


class CapturedStep:
    """The training step captured once per key as one CUDA graph and
    replayed: the port's ``jax.jit(step, donate_argnums=(0, 3))``
    (boda_tpu/modes/train_lmdb.py), and under a group or a mesh its jitted
    sharded step (boda_tpu/modes/dist_modes.py, ``__graft_entry__.py``).

    It owns one static tensor per weight (trainable or frozen, the BN
    running statistics among them), per momentum (zeros where a call passes
    ``mom_state=None``), per input and for the labels; a weight that a mesh
    splits, and its momentum, as a ``Shards`` of static parts, each on its
    part's device. The learning rate and the decoupled decay's coefficient
    are 0-dim f32 tensors on the lead (the labels' device), filled on the
    host from ``step=`` before a replay, so that a schedule replays with no
    recapture; the loss lies there too. The body is ``values``
    (make_train_step's step arithmetic, its collectives included) on the
    static tensors, then copies of its results into them, after the
    backward (a weight or running statistic that is rounded to its dtype is
    rounded straight into its static tensor). The key is the names, shapes,
    dtypes and devices of the weights (of each part), the inputs and the
    labels, and whether momentum is on; a new key frees the old graph and is
    captured anew (:func:`capture_step`). With a ``group``, the ranks first
    compare the new key (:func:`check_ranks_key`): the contract is that
    every rank steps equal slices, so that every rank meets the same
    sequence of keys.

    A call copies in each weight and momentum part that is not the step's
    own static tensor (``copies`` counts them), and the inputs and labels: a
    call that passes the last call's return copies no weight and no
    momentum. Donation: the weights and momenta returned ARE the static
    tensors (the Shards of static parts), which the next call overwrites
    (keep a copy to hold a value); the loss is a fresh tensor per call. On
    CPU tensors the same body runs eagerly at each call. :meth:`release`
    frees the graph: an NCCL communicator is not torn down while a graph
    that holds its kernels lives (``destroy_process_group`` waits for it),
    so release the step before destroying its group."""

    def __init__(self, values: Callable, rates: Callable, momentum: bool, info_log: list,
                 group=None):
        self._values, self._rates, self._momentum = values, rates, momentum
        self._info_log, self._group = info_log, group
        self.key, self.graph = None, None
        self.copies = 0  # weight and momentum tensors (parts) copied in
        self.captures = 0

    def release(self) -> None:
        """Free the graph now (the next call captures anew)."""
        if isinstance(self.graph, torch.cuda.CUDAGraph):
            self.graph.reset()
        self.key, self.graph = None, None

    def _new_key(self, weights, inputs, labels) -> None:
        self.release()  # free the old key's graph first
        dev = labels.device

        def zeros(t):
            return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
        self.w = {k: v.map(torch.empty_like, v.axis) if isinstance(v, Shards)
                  else torch.empty_like(v) for k, v in weights.items()}
        self.m = {k: v.map(zeros, v.axis) if isinstance(v, Shards) else zeros(v)
                  for k, v in weights.items() if is_trainable(k)} if self._momentum else {}
        self.x = {k: torch.empty_like(v) for k, v in inputs.items()}
        self.y = torch.empty_like(labels)
        self.lr, self.c, self.loss = (torch.zeros((), dtype=torch.float32, device=dev)
                                      for _ in range(3))
        self._rates_in = None

    def _step_values(self, into: bool = False):
        return self._values(self.w, self.x, self.y, self.m if self._momentum else None,
                            self.lr, self.c, into)

    def _body(self) -> None:
        loss, new_w, new_m = self._step_values(into=True)
        self.loss.copy_(loss)
        for k, t in new_w.items():
            _copy_in(self.w[k], t)
        for k, t in (new_m or {}).items():
            _copy_in(self.m[k], t)

    def _load(self, weights, inputs, labels, mom_state, step) -> None:
        for k, t in weights.items():
            self.copies += _copy_in(self.w[k], t)
        if self._momentum and mom_state is None:
            torch._foreach_zero_([p for v in self.m.values() for p in _parts(v)])
        elif self._momentum:
            for k, s in self.m.items():
                self.copies += _copy_in(s, mom_state[k])
        for k, t in inputs.items():
            if t is not self.x[k]:
                self.x[k].copy_(t)
        if labels is not self.y:
            self.y.copy_(labels)
        rates = self._rates(step)
        if rates != self._rates_in:
            self.lr.fill_(rates[0])
            self.c.fill_(rates[1])
            self._rates_in = rates

    def __call__(self, weights, inputs, labels, mom_state=None, step=None):
        key = (_sig(weights), _sig(inputs), (tuple(labels.shape), labels.dtype, labels.device),
               self._momentum)
        new = key != self.key
        if new:
            shapes = f"inputs {[tuple(v.shape) for v in inputs.values()]}"
            if self._group is not None:
                check_ranks_key(key, self._group, labels.device,
                                f"{shapes}, labels {tuple(labels.shape)}")
            self._new_key(weights, inputs, labels)
        self._load(weights, inputs, labels, mom_state, step)
        if new:
            t0 = time.perf_counter()
            self.graph = capture_step(self._body, self._step_values, labels.device)
            self.key = key
            self.captures += 1
            if labels.device.type == "cuda":
                self._info_log.append(
                    f"captured the step on {labels.device}: {shapes}, "
                    f"{time.perf_counter() - t0:.2f} s with its two warm-up steps")
        self.graph.replay()
        if self._momentum:
            return self.loss.clone(), dict(self.w), dict(self.m)
        return self.loss.clone(), dict(self.w)


def eager_reasons(group, row: list) -> list[str]:
    """Why a step asked for ``cuda_graph`` runs eagerly on CUDA tensors, one
    line per cause; empty where it is captured (no group or an NCCL one,
    and no mesh or a tp row on one card)."""
    why = []
    if group is not None:
        import torch.distributed as dist
        backend = str(dist.get_backend(group))
        if backend != "nccl":
            why.append(f"eager on CUDA tensors: the process group's backend is {backend}, "
                       f"which reduces through the host; a CUDA graph holds only the card's "
                       f"work (an NCCL group's step is captured)")
    if len(set(row)) > 1:
        why.append(f"eager on CUDA tensors: this rank's tp row spans {len(set(row))} devices "
                   f"({', '.join(map(str, row))}); tp_call's copies between cards and a "
                   f"capture's pool, which belongs to one device, keep it out of one CUDA "
                   f"graph (a row on one card is captured)")
    return why


def make_train_step(pipe: ConvPipe, logits_node: str, lr: float = 0.01,
                    precision: str = "default", clip_norm: float = 0.0,
                    momentum: float = 0.0, weight_decay: float = 0.0,
                    bn_momentum: float = 0.0,
                    compute_dtype=None,
                    lr_schedule: Optional[Callable] = None,
                    remat: str = "",
                    kernel_policy: str = "gen",
                    group=None, mesh: Optional[Mesh] = None,
                    cuda_graph: bool = False) -> Callable:
    """SGD (+momentum, +decoupled weight decay) step:
    fn(weights, inputs, labels[, mom_state][, step=]) -> (loss, new_weights)
    — or (loss, new_weights, new_mom_state) when momentum > 0 (pass the
    previous mom_state or None to start from zeros; f32 whatever the weight
    dtype). Weights are a dict of tensors in the logical layouts, inputs a
    dict of logical (NCHW) tensors, labels integer class ids; the step runs
    where they lie. BatchNorm statistics (means/vars/scale factor) are not
    updated by SGD. clip_norm > 0 clips the global gradient norm in f32.
    compute_dtype (a torch dtype or its name): f32 master weights, the
    forward and backward in compute_dtype, the frozen statistics kept in
    f32. lr_schedule (parallel.schedules.make_lr_schedule) derives lr from
    the ``step=`` index. remat: '' | seg | full | dots (module docstring;
    its checkpoints keep no RNG state, since the net draws nothing on the
    device: the Dropout masks are host draws made once per shape).
    kernel_policy: gen | lib. group: a ``torch.distributed`` process group
    whose ranks each step an equal slice of the global batch (module
    docstring); the returned loss is then the global one. mesh: a
    parallel.mesh.Mesh of axes dp (the group's size) and tp; the weights
    that it splits, and their momenta, come and go as ``Shards`` over this
    rank's tp row (parallel.mesh.shard_weights), the rest on the row's
    lead, where the inputs and labels lie (module docstring).
    cuda_graph (off by default; the training modes' ``cuda_graph`` Field
    turns it on, as boda_tpu's callers choose to ``jax.jit(step,
    donate_argnums=(0, 3))`` it, or with shardings under a mesh): every call
    on CUDA tensors goes to the returned function's ``captured``
    (:class:`CapturedStep`) when there is no group or an NCCL one, and no
    mesh or one whose tp row for this rank lies on one card: the step
    replayed as one CUDA graph per key, its all-reduces inside it, its
    returned weights and momenta the step's own static tensors (the parts
    of each Shards among them), DONATED: the next call overwrites them.
    Under a group every rank must step equal slices, so that all meet the
    same sequence of keys (a new key is compared across the ranks first,
    and a mismatch raises). Eager, each call returning new tensors: with
    ``cuda_graph`` off; on CPU tensors (where ``captured`` runs the same
    body eagerly); under a gloo group or a tp row over several cards, each
    a line of the ``info_log`` that says why. A capture that fails raises;
    no call drops to the eager step on its own; the returned function's
    ``release()`` frees the graph, which must come before
    ``destroy_process_group`` of an NCCL group (NCCL's teardown waits for
    every graph that holds its kernels). The returned
    function's ``info_log`` lists the rules' choices (the gen convs'
    routes among them)."""
    lctx = LowerCtx(precision=precision, train=True, det_drop_seed=42)
    info_log: list[str] = []
    build = functools.partial(build_net_fn, pipe, [logits_node], lctx,
                              bn_momentum=bn_momentum, kernel_policy=kernel_policy,
                              info_log=info_log, group=group, mesh=mesh)
    world = _group_shape(group)[0]
    split = [] if mesh is None else \
        [k for k, sp in weight_shardings(pipe, mesh).items() if "tp" in sp]
    # a tp row over several devices: autograd would run the backward on a
    # thread per device, and the lead's nodes, train-mode BN's all-reduces
    # among them, in an order that varies with the timing of the others
    # (two ranks then all-reduce different tensors). On the calling thread
    # the nodes run in one order, the same on every rank.
    row = train_row(mesh, *_group_shape(group)) if mesh is not None else []
    one_thread = len(set(row)) > 1
    if remat == "seg":
        net_fn = build(segments=spatial_segments(pipe))
    else:
        net_fn = build()
        if remat:
            from torch.utils.checkpoint import checkpoint
            policies = {"full": None, "dots": _dots_context}
            if remat not in policies:
                raise ValueError(f"remat must be one of "
                                 f"{sorted(policies) + ['seg']} "
                                 f"or '', not {remat!r}")
            kw = {"context_fn": policies[remat]} if policies[remat] else {}
            inner = net_fn

            def net_fn(weights, inputs):
                return checkpoint(inner, weights, inputs, use_reentrant=False,
                                  preserve_rng_state=False, **kw)
    cdt = torch_dtype(compute_dtype) if isinstance(compute_dtype, str) else compute_dtype

    def loss_fn(weights, inputs, labels):
        res = net_fn(weights, inputs)
        # the __loss__ range: train_trace's softmax-CE rows, apart from the
        # net's ops (boda_tpu's named scope of the same name)
        with _tagged("__loss__"):
            logits = res[logits_node]
            logits = logits.reshape(logits.shape[0], -1).float()
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, 1, labels.reshape(-1, 1).long())
            return torch.mean(nll), res.get("__bn_stats__", {})

    def rates(step) -> tuple[float, float]:
        """(lr, the decoupled decay's lr * weight_decay) of ``step=``."""
        if lr_schedule is None:
            return float(lr), lr * weight_decay
        lr_t = lr_schedule(step)
        return float(lr_t), float(np.float32(lr_t) * np.float32(weight_decay))

    def step_values(weights, inputs, labels, mom_state, lr_v, c_v, into=False):
        """(loss, new weights, new momenta or None) of one step. ``lr_v`` and
        ``c_v`` (see ``rates``) are floats, or the captured step's 0-dim f32
        tensors: the same f32 products either way. ``into``: a new weight or
        running statistic that is rounded to the dtype of the tensor it
        replaces is rounded into that tensor (the same conversion as ``to``),
        which is then returned in its place (the captured step's body)."""
        for k in split:
            if not isinstance(weights[k], Shards):
                raise ValueError(f"weight {k!r} is split over tp by the mesh: pass the "
                                 f"weights through parallel.mesh.shard_weights")
        names = [k for k in weights if is_trainable(k)]
        frozen = {k: v for k, v in weights.items() if not is_trainable(k)}
        # one slot per tensor: (name, None) for a whole weight, (name, j)
        # for shard j of a split one
        slots = [(k, j) for k in names for j in (
            range(len(weights[k])) if isinstance(weights[k], Shards) else [None])]

        def flat(d):
            return [d[k] if j is None else d[k][j] for k, j in slots]

        def regroup(ts):
            out = {}
            for (k, j), t in zip(slots, ts):
                if j is None:
                    out[k] = t
                else:
                    out.setdefault(k, Shards([], weights[k].axis)).append(t)
            return out
        w_flat = flat(weights)
        if cdt is not None:
            # f32 masters: forward and backward in the compute dtype; the
            # frozen statistics stay f32 (they feed the running-stat EMA)
            leaves = [w.detach().to(cdt).requires_grad_() for w in w_flat]
            inputs = {k: v.to(cdt) if v.is_floating_point() else v
                      for k, v in inputs.items()}
        else:
            leaves = [w.detach().requires_grad_() for w in w_flat]
        with torch.enable_grad(), lib_precision(precision), (
                torch.autograd.set_multithreading_enabled(False) if one_thread
                else contextlib.nullcontext()):
            loss, bn_stats = loss_fn({**regroup(leaves), **frozen}, inputs, labels)
            if group is not None:  # this rank's share of the global mean
                loss = loss * (1.0 / world)
            try:
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            except Exception as e:
                e.add_note("in the backward")
                raise
        # the __update__ range: train_trace's clip, momentum and SGD rows
        with torch.no_grad(), _tagged("__update__"):
            gs = [torch.zeros(t.shape, dtype=t.dtype, device=t.device) if g is None
                  else g for g, t in zip(grads, leaves)]
            if group is not None:  # the global batch's gradients and loss
                gs = train_ops.all_reduce_buckets(gs, group)
                loss = train_ops.all_reduce_sum(loss.detach(), group)
            gs = [g.float() for g in gs]
            # the foreach ops take one device's tensors: the slots by device
            by_dev: dict = {}
            for i, g in enumerate(gs):
                by_dev.setdefault(g.device, []).append(i)
            scale = None
            if clip_norm > 0:
                norms = [None] * len(gs)
                for ix in by_dev.values():
                    for i, n in zip(ix, torch._foreach_norm([gs[i] for i in ix])):
                        norms[i] = n.to(loss.device)
                gnorm = torch.linalg.vector_norm(torch.stack(norms))
                scale = torch.clamp(clip_norm / torch.clamp_min(gnorm, 1e-12), max=1.0)
            prev = flat(mom_state) if momentum > 0 and mom_state is not None else None
            new_f, new_m = [None] * len(gs), [None] * len(gs)
            for dev, ix in by_dev.items():
                g = [gs[i] for i in ix]
                if scale is not None:
                    torch._foreach_mul_(g, scale.to(dev))
                if momentum > 0:
                    m = torch._foreach_mul([prev[i] for i in ix], momentum) \
                        if prev is not None else torch._foreach_mul(
                            [torch.zeros_like(t) for t in g], momentum)
                    torch._foreach_add_(m, g)
                    g = m
                    for i, t in zip(ix, m):
                        new_m[i] = t
                wf = [w_flat[i].float() for i in ix]
                delta = torch._foreach_mul(g, lr_v)
                if weight_decay > 0:  # decoupled (AdamW-style) decay
                    torch._foreach_add_(delta, torch._foreach_mul(wf, c_v))
                for i, t in zip(ix, torch._foreach_sub(wf, delta)):
                    w = w_flat[i]
                    new_f[i] = w.copy_(t) if into and w.dtype != t.dtype else t.to(w.dtype)
            new_w = regroup(new_f)
            new_w.update(frozen)
            new_w.update({k: weights[k].copy_(v) if into else v.to(weights[k].dtype)
                          for k, v in bn_stats.items()})
        return loss.detach(), new_w, regroup(new_m) if momentum > 0 else None

    captured, eager_why = None, []
    if cuda_graph:
        captured = CapturedStep(step_values, rates, momentum > 0, info_log, group)
        eager_why = eager_reasons(group, row)
        info_log.extend(eager_why)

    def train_step(weights, inputs, labels, mom_state=None, step=None):
        if captured is not None and not eager_why and labels.is_cuda:
            return captured(weights, inputs, labels, mom_state, step)
        loss, new_w, new_m = step_values(weights, inputs, labels, mom_state, *rates(step))
        if momentum > 0:
            return loss, new_w, new_m
        return loss, new_w

    def release() -> None:
        """Free the captured graph, if any; call it before destroying the
        NCCL group the step reduces over (CapturedStep.release)."""
        if captured is not None:
            captured.release()

    train_step.info_log = info_log
    train_step.captured = captured
    train_step.release = release
    return train_step


def train_device(name: str, who: str) -> torch.device:
    """The training modes' device: the card unless ``cpu`` is asked for; no
    silent CPU fallback (``cuda`` without a usable card raises)."""
    d = torch.device(name)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device=cuda but torch finds no CUDA card; "
                           f"pass --device=cpu to run the plain versions")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {name!r}")
    return d
