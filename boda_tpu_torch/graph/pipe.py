"""The dataflow-graph IR: ops, nodes, shape + receptive-field inference.

Counterpart of ``boda_tpu/graph/pipe.py``, copied: it is pure Python, but
importing it from ``boda_tpu`` would run ``boda_tpu/graph/__init__.py``,
which imports the JAX executor.

Parity target: ``conv_pipe_t`` / ``conv_op_t`` / ``conv_node_t`` (ref
src/conv_util.H:96-228) and the per-op-type semantics tables (ref
src/conv_util.cc:31-65 ``conv_op_info_t``): the operator set, Caffe-compatible
shape inference (``calc_dims``, ref conv_util.cc:405-530), and the
support/receptive-field calculus (``calc_support_info``, conv_util.cc:319-404)
that maps output coordinates back to input pixels (used by the multi-scale
pyramid flow).

Dims convention: activations are named (img, chan, y, x) — NCHW *names*, as in
the reference; the executor lays data out NHWC internally.
Filters are (out_chan, in_chan, y, x); biases are (out_chan).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..utils.dims import NDA, Dims


class PipeError(ValueError):
    pass


@dataclass
class OpInfo:
    """Static per-op-type info (ref conv_op_info_t, conv_util.H:23)."""
    type: str
    min_bots: int
    max_bots: int          # -1 = unbounded
    num_tops: int
    same_dims: bool = False    # all tops have the bot's dims
    calc: Optional[Callable] = None  # custom shape fn(pipe, op) -> list[Dims]


OP_INFOS: dict[str, OpInfo] = {}


def _op_info(type: str, min_bots=1, max_bots=1, num_tops=1):
    def deco(fn=None):
        OP_INFOS[type] = OpInfo(type, min_bots, max_bots, num_tops, calc=fn)
        return fn
    return deco


@dataclass
class ConvOp:
    """A graph edge: an op instance (ref conv_op_t, conv_util.H:96)."""
    name: str
    type: str
    params: dict[str, object] = field(default_factory=dict)  # kern_sz/stride/pad/...
    bots: list[str] = field(default_factory=list)
    tops: list[str] = field(default_factory=list)

    def p(self, key: str, default=None):
        return self.params.get(key, default)

    # common geometric params, always stored as (y, x) int pairs
    def kern_sz(self):
        return self.params.get("kern_sz", (1, 1))

    def stride(self):
        return self.params.get("stride", (1, 1))

    def pad(self):
        return self.params.get("pad", (0, 0))

    def dilation(self):
        return self.params.get("dilation", (1, 1))

    def eff_kern_sz(self):
        """Dilated (effective) kernel extent: (k-1)*d + 1 per axis."""
        k, d = self.kern_sz(), self.dilation()
        return ((k[0] - 1) * d[0] + 1, (k[1] - 1) * d[1] + 1)

    def __str__(self):
        return (f"{self.type}[{self.name}] bots={self.bots} tops={self.tops} "
                f"params={self.params}")


@dataclass
class SupportInfo:
    """Receptive-field info for a node (ref conv_support_info_t, conv_common.H:8).

    For output coordinate o (y or x axis i):
      input span = [o*stride - pad, o*stride - pad + support_sz)
    """
    support_sz: tuple[int, int] = (1, 1)
    support_stride: tuple[int, int] = (1, 1)
    eff_tot_pad: tuple[int, int] = (0, 0)


@dataclass
class ConvNode:
    """A graph node: a named tensor (ref conv_node_t, conv_util.H:152)."""
    name: str
    dims: Optional[Dims] = None
    top_for: list[str] = field(default_factory=list)   # producer op names
    bot_for: list[str] = field(default_factory=list)   # consumer op names
    csi: SupportInfo = field(default_factory=SupportInfo)


class ConvPipe:
    """The dataflow graph (ref conv_pipe_t, conv_util.H:169)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.ops: dict[str, ConvOp] = {}
        self.nodes: dict[str, ConvNode] = {}
        self.op_order: list[str] = []        # insertion order (stable topo tie-break)
        self.weights: dict[str, NDA] = {}    # weight-node name -> host data
        self.bck_added = False               # add_bck_ops ran (graph/autodiff.py)

    # -- construction --------------------------------------------------------
    def get_or_make_node(self, name: str) -> ConvNode:
        n = self.nodes.get(name)
        if n is None:
            n = self.nodes[name] = ConvNode(name)
        return n

    def add_op(self, op: ConvOp) -> ConvOp:
        if op.name in self.ops:
            raise PipeError(f"duplicate op name {op.name!r}")
        oi = OP_INFOS.get(op.type)
        if oi is None:
            raise PipeError(f"unknown op type {op.type!r} (op {op.name!r}); "
                            f"known: {sorted(OP_INFOS)}")
        if len(op.bots) < oi.min_bots or (oi.max_bots != -1 and len(op.bots) > oi.max_bots):
            raise PipeError(f"op {op.name!r} ({op.type}): {len(op.bots)} inputs, "
                            f"expected [{oi.min_bots},{oi.max_bots}]")
        self.ops[op.name] = op
        self.op_order.append(op.name)
        for b in op.bots:
            self.get_or_make_node(b).bot_for.append(op.name)
        for t in op.tops:
            n = self.get_or_make_node(t)
            n.top_for.append(op.name)
        return op

    # -- queries ----------------------------------------------------------------
    def bots(self) -> list[str]:
        """Graph inputs: nodes with no producer (excluding weight nodes)."""
        return [n.name for n in self.nodes.values()
                if not n.top_for and n.name not in self.weights
                and not n.name.endswith("__filts") and not n.name.endswith("__biases")]

    def topo_op_order(self) -> list[str]:
        """Topological op order (ref topo_visit_setup, conv_util.cc:531)."""
        done_nodes = {n for n in self.nodes
                      if not self.nodes[n].top_for}
        out: list[str] = []
        remaining = [self.ops[o] for o in self.op_order]
        guard = len(remaining) + 1
        while remaining:
            guard -= 1
            if guard < 0:
                stuck = [o.name for o in remaining]
                raise PipeError(f"graph has a cycle or missing producer; stuck ops: {stuck}")
            rest = []
            for op in remaining:
                if all(b in done_nodes for b in op.bots):
                    out.append(op.name)
                    done_nodes.update(op.tops)
                else:
                    rest.append(op)
            remaining = rest
        return out

    # -- shape inference -----------------------------------------------------------
    def calc_dims(self, in_dims: dict[str, Dims]) -> None:
        """Infer all node dims from input dims (ref calc_dims, conv_util.cc:405)."""
        for name, d in in_dims.items():
            if name not in self.nodes:
                raise PipeError(f"calc_dims: no input node named {name!r}")
            self.nodes[name].dims = d
        for wname, w in self.weights.items():
            self.get_or_make_node(wname).dims = w.dims
        for op_name in self.topo_op_order():
            self.infer_op_dims(op_name)

    def infer_op_dims(self, op_name: str) -> None:
        """Infer+assign the tops' dims of one op (bots must have dims)."""
        op = self.ops[op_name]
        oi = OP_INFOS[op.type]
        for b in op.bots:
            if self.nodes[b].dims is None:
                raise PipeError(f"op {op.name!r}: input node {b!r} has no dims")
        if oi.same_dims:
            out_dims = [self.nodes[op.bots[0]].dims] * len(op.tops)
        else:
            out_dims = oi.calc(self, op)
        if len(out_dims) != len(op.tops):
            raise PipeError(f"op {op.name!r}: {len(out_dims)} inferred dims for "
                            f"{len(op.tops)} tops")
        for t, d in zip(op.tops, out_dims):
            cur = self.nodes[t].dims
            if cur is not None and cur != d:
                raise PipeError(f"node {t!r}: inconsistent dims {cur} vs {d}")
            self.nodes[t].dims = d

    def must_dims(self, node: str) -> Dims:
        d = self.nodes[node].dims
        if d is None:
            raise PipeError(f"node {node!r} has no dims (run calc_dims)")
        return d

    # -- receptive-field calculus -----------------------------------------------------
    def calc_support_info(self) -> None:
        """Per-node receptive-field propagation (ref conv_util.cc:319-404)."""
        for op_name in self.topo_op_order():
            op = self.ops[op_name]
            data_bots = [b for b in op.bots if not _is_weight_name(b)]
            if not data_bots:
                continue
            in_csi = self.nodes[data_bots[0]].csi
            if op.type in ("Convolution", "Pooling"):
                k, s, p = op.eff_kern_sz(), op.stride(), op.pad()
                csi = SupportInfo(
                    support_sz=tuple(in_csi.support_sz[i]
                                     + (k[i] - 1) * in_csi.support_stride[i]
                                     for i in range(2)),
                    support_stride=tuple(in_csi.support_stride[i] * s[i]
                                         for i in range(2)),
                    eff_tot_pad=tuple(in_csi.eff_tot_pad[i]
                                      + p[i] * in_csi.support_stride[i]
                                      for i in range(2)),
                )
            elif op.type == "InnerProduct":
                # global support (ref: treats FC as infinite/global support)
                csi = SupportInfo((0, 0), (0, 0), in_csi.eff_tot_pad)
            else:
                csi = in_csi
            for t in op.tops:
                self.nodes[t].csi = csi

    # -- stats ----------------------------------------------------------------------
    def op_flops(self, op_name: str) -> float:
        """Forward FLOPs for one op (ref pysrc/flops.py semantics)."""
        op = self.ops[op_name]
        if op.type == "Convolution":
            od = self.must_dims(op.tops[0])
            fd = self.must_dims(op.bots[1])
            return 2.0 * od.num_elems() * fd["in_chan"] * fd["y"] * fd["x"]
        if op.type == "InnerProduct":
            od = self.must_dims(op.tops[0])
            ind = self.must_dims(op.bots[0])
            return 2.0 * od.num_elems() * (ind.num_elems() // ind["img"])
        # elementwise-ish: one flop per output element
        return float(sum(self.must_dims(t).num_elems() for t in op.tops))

    def total_flops(self) -> float:
        return sum(self.op_flops(o) for o in self.ops)


def _is_weight_name(name: str) -> bool:
    return name.endswith("__filts") or name.endswith("__biases") or \
        name.endswith("__scales") or name.endswith("__means") or name.endswith("__vars")


# -- per-type shape rules (ref conv_util.cc:405-530) -------------------------------

def _conv_out_sz(in_sz: int, k: int, s: int, p: int, ceil_mode: bool) -> int:
    num = in_sz + 2 * p - k
    if num < 0:
        raise PipeError(f"spatial dim underflow: in={in_sz} kern={k} pad={p}")
    o = (math.ceil if ceil_mode else math.floor)(num / s) + 1
    if ceil_mode:  # Caffe pooling clip: last window must start inside input+pad
        if (o - 1) * s >= in_sz + p:
            o -= 1
    return o


@_op_info("Convolution", min_bots=3, max_bots=3)
def _calc_conv(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    fd = pipe.must_dims(op.bots[1])
    k, s, p = op.kern_sz(), op.stride(), op.pad()
    if (fd["y"], fd["x"]) != tuple(k):
        raise PipeError(f"op {op.name!r}: filter spatial {fd['y']}x{fd['x']} != kern_sz {k}")
    groups = int(op.p("groups", 1))
    if fd["in_chan"] * groups != ind["chan"]:
        raise PipeError(f"op {op.name!r}: filts in_chan {fd['in_chan']}*groups {groups} "
                        f"!= input chan {ind['chan']}")
    ek = op.eff_kern_sz()  # dilation-aware (atrous conv, e.g. SSD fc6)
    oy = _conv_out_sz(ind["y"], ek[0], s[0], p[0], False)
    ox = _conv_out_sz(ind["x"], ek[1], s[1], p[1], False)
    return [Dims.of(img=ind["img"], chan=fd["out_chan"], y=oy, x=ox, tn=ind.tn)]


@_op_info("Pooling")
def _calc_pool(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    if op.p("global_pooling", False):
        op.params["kern_sz"] = (ind["y"], ind["x"])
        op.params["stride"] = (1, 1)
        op.params["pad"] = (0, 0)
    k, s, p = op.kern_sz(), op.stride(), op.pad()
    # Caffe pooling uses ceil division (ref conv_util.cc pooling path)
    oy = _conv_out_sz(ind["y"], k[0], s[0], p[0], True)
    ox = _conv_out_sz(ind["x"], k[1], s[1], p[1], True)
    return [Dims.of(img=ind["img"], chan=ind["chan"], y=oy, x=ox, tn=ind.tn)]


@_op_info("InnerProduct", min_bots=3, max_bots=3)
def _calc_ip(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    fd = pipe.must_dims(op.bots[1])
    in_feats = ind.num_elems() // ind["img"]
    if fd["in_feats"] != in_feats:
        raise PipeError(f"op {op.name!r}: weights in_feats {fd['in_feats']} != "
                        f"input features {in_feats}")
    return [Dims.of(img=ind["img"], chan=fd["out_chan"], tn=ind.tn)]


@_op_info("Split", num_tops=-1)
def _calc_split(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    return [pipe.must_dims(op.bots[0])] * len(op.tops)


def _concat_axis_name(op: ConvOp, d0: "Dims") -> str:
    # prefer explicit index (needed for non-canonical dims, e.g. SSD
    # priorbox concat along axis 2 of (img,pv,pbox)); fall back to name
    axis = op.p("axis", None)
    if axis is not None:
        return d0.names[int(axis) % len(d0)]
    return op.p("axis_name", "chan")


@_op_info("Concat", min_bots=1, max_bots=-1)
def _calc_concat(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ds = [pipe.must_dims(b) for b in op.bots]
    d0 = ds[0]
    axis_name = _concat_axis_name(op, d0)
    tot = sum(d[axis_name] for d in ds)
    for d in ds[1:]:
        if not d.drop(axis_name).matches(d0.drop(axis_name)):
            raise PipeError(f"op {op.name!r}: concat input dims mismatch {d} vs {d0}")
    return [d0.with_size(axis_name, tot)]


@_op_info("Eltwise", min_bots=2, max_bots=-1)
def _calc_eltwise(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ds = [pipe.must_dims(b) for b in op.bots]
    for d in ds[1:]:
        if d != ds[0]:
            raise PipeError(f"op {op.name!r}: eltwise input dims mismatch")
    return [ds[0]]


@_op_info("SoftmaxWithLoss", min_bots=2, max_bots=2, num_tops=2)
def _calc_sml(pipe: ConvPipe, op: ConvOp) -> list[Dims]:
    ind = pipe.must_dims(op.bots[0])
    # tops: per-img loss + prob (ref conv_util.cc SoftmaxWithLoss dims)
    return [Dims.of(img=ind["img"], tn=ind.tn), ind]


# same-dims unary ops (Scale takes optional scales/biases weight bots;
# BatchNorm takes means/vars/scale-factor weight bots)
for _t, _mb in (("ReLU", 1), ("Dropout", 1), ("LRN", 1), ("Softmax", 1),
                ("Scale", 3), ("BatchNorm", 4), ("Data", 1)):
    OP_INFOS[_t] = OpInfo(_t, 1, _mb, 1, same_dims=True)
