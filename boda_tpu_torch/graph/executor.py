"""The whole-net forward engines on PyTorch: conv_fwd modes ``cuda``, ``xla``
and ``pallas``.

Counterpart of ``boda_tpu/graph/executor.py``. ``FwdEngine``'s own path is
boda_tpu's ``xla`` engine (``XlaFwd``): every op by the logical-layout
rules of graph/lowering.py, NCHW, no rewrite. ``pallas`` (``PallasFwd``)
is boda_tpu's engine of the same name: ``layout=nhwc`` is the ``cuda``
engine, ``layout=nchw`` the logical path with each conv and fc routed by
ops/cnn_variants.py to K1 or K3. The ``cuda`` engine (``CudaFwd``) is the
NHWC path of boda_tpu's ``PallasFwd``: the same fusion chains, the same
upload-time weight preps and BN/Scale prefold, and the same per-call
fusion decision, run eagerly by PyTorch instead of as one jit program. Under
``kernel_policy=gen`` every conv and fc runs a hand-written CUDA kernel
(``ops/kernels``: the GEMM for 1x1 convs and fc, the direct conv for the
rest); under ``lib`` they run cuDNN/cuBLAS through ``F.conv2d`` and
``torch.matmul``, the analog of boda_tpu's XLA library path. Pools, softmax
and the unfused BN/Scale are plain PyTorch either way, unless the tune asks
for the pooling kernel (``pool_pallas``). With ``fuse_block=1`` each
identity bottleneck runs as one hand kernel (``ops/kernels/block.py``). The
engine's ``precision`` is applied to the library ops around every forward.

Graphs with backward ops (``graph/autodiff.add_bck_ops``) run here too: a
``Bck`` op is the autograd of its forward op's library lowering, except
that every eligible conv (stride 1, groups 1, no dilation, unfused) under
``gen`` runs the hand backward kernels (``ops/kernels/bconv``): dgrad on the
conv kernel, wgrad on K5's port. Weight gradients come out in the logical
layout, through the inverse of the weight's upload prep.

Activations are physically NHWC; ``run_fwd`` takes and returns logical NCHW
host arrays in each node's logical dtype, as boda_tpu does.

With ``int8=1`` every conv and fc but the s2d-folded stem, grouped and
dilated convs computes on int8 operands with an int32 accumulator (the
library's int8 GEMM, ops/int8.py), with static act scales from a
``calib_fn`` sidecar or per-forward ones without; ``act_int8`` stores the
listed activations as int8 or uint8 and dequantizes them on every read.

On the card (``cuda_graph=1``, the default) each forward, and each graph
with backward ops, is captured once per key (input names, shapes and dtypes,
the requested outputs) as a CUDA graph after one eager warm-up forward, and
``run_fwd`` and ``time_fwd`` replay it: the counterpart of boda_tpu's one jit
program per net, with the host out of the loop. ``cuda_graph=0`` runs every
forward eagerly, launch by launch.

Under a ``mesh`` (parallel/mesh.py; boda_tpu: executor.py:86-109, :713-769)
each dp slice of the batch runs the whole net on its own device, with its
own copy of the weights and its own captured graph (boda_tpu's pallas
engine, through ``shard_map``), and the outputs are concatenated on the
first device. Under ``kernel_policy=lib`` a tp axis splits every groups-1
conv and fc weight over out_chan: each of the slice's tp devices computes
its channels and the slices are gathered on the first before the next op
(boda_tpu's GSPMD path; parallel/mesh.py:tp_call, which the training step
runs too); the block fusion is off and a gen tune is forced to
the library, as there. ``gen_src_dir`` writes what each forward ran: its
plan per op, and on the card the captured graph and the kernels' PTX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
import time
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..config import ConfigError, Field, register, register_base
from ..ops.kernels import common as kcommon
from ..ops.kernels.bconv import conv2d_bck_filts, conv2d_bck_in
from ..ops.kernels.block import block_fuse_ok, bottleneck
from ..ops.tune import OpTune
from ..parallel.mesh import Mesh, make_mesh, split_tensor, tp_call, weight_shardings
from ..rtc.backends import capture, graph_time, side_stream_warmup
from ..utils.dims import NDA, torch_dtype
from .autodiff import _wants_grad
from .lowering import AUTOGRAD_RULES, PRECISIONS, LowerCtx, lib_precision, lower_op
from .lowering_nhwc import HWIO, Prep, host_stem_s2d, lower_op_nhwc, stem_s2d_geom
from .pipe import ConvPipe, PipeError


def _quantize(x: torch.Tensor, max_val: float, keep_bits: int) -> torch.Tensor:
    """Clamp to [0, max_val] and keep ``keep_bits`` bits of fixed point
    (boda_tpu: executor.py:182-186, ref quantize.cucl)."""
    levels = float(2 ** keep_bits)
    q = torch.clamp(x, 0.0, max_val)
    return torch.floor(q * (levels / max_val)) * (max_val / levels)


@dataclasses.dataclass
class CapturedFwd:
    """One forward captured as a CUDA graph: its key, the graph, the static
    input tensors a replay reads, the static outputs it writes, and the
    capture's own wall time."""
    key: tuple
    graph: "torch.cuda.CUDAGraph"
    ins: dict
    outs: dict
    capture_secs: float

    def load(self, ins: dict[str, NDA]) -> None:
        """Copy host inputs into the static input tensors."""
        for k, v in ins.items():
            self.ins[k].copy_(torch.from_numpy(np.ascontiguousarray(v.data)))


class _Replica:
    """A dp slice of a mesh after the first (the engine itself holds the
    first's state, under the same names): its devices along tp (the first,
    ``_lead``, runs the net; the others only their channels of the split
    convs), its weights and its captured forward."""

    def __init__(self, devs: list):
        self._lead = devs[0]
        self._tp_devs = devs
        self._weights_dev: dict = {}
        self._graph: Optional[CapturedFwd] = None
        self._warm_key = None


class _TpShards(NamedTuple):
    """A dp slice's tp shards, under the key ``__tp__`` of its weights: its
    devices along tp, and per split weight (a conv or fc filter, its bias,
    their prefolded forms) its :class:`~..parallel.mesh.Shards`."""
    devs: list
    parts: dict


@dataclasses.dataclass
class _SrcRecord:
    """What a gen_src pass saw: per op run, its bots and tops (name,
    dtype[shape]) and its calls; the kernel entries' calls and the library's
    (torch functions outside a kernel entry) in call order; the chains that
    fused."""
    ops: dict = dataclasses.field(default_factory=dict)
    kernels: list = dataclasses.field(default_factory=list)
    lib: list = dataclasses.field(default_factory=list)
    chains: dict = dataclasses.field(default_factory=dict)


def resolve_batch_split(pipe: ConvPipe, specs, units: list[str], tops_of: Callable,
                        deps_of: Callable) -> list[dict]:
    """boda_tpu's batch_split regions (executor.py:1523-1575): each spec
    'in_node:out_node:k' resolved to the execution units (ops, or fused
    chains) between its nodes, walking back from out_node to in_node. A
    region must be closed (no data input but in_node and weights), none of
    its nodes may be read outside it, and k must divide in_node's img."""
    regions = []
    for spec in specs:
        try:
            a_node, b_node, k_str = str(spec).split(":")
            k = int(k_str)
        except ValueError:
            raise ConfigError(f"batch_split entry {spec!r} is not 'in_node:out_node:k'")
        region, needed = [], {b_node}
        for op_name in reversed(units):
            tops = tops_of(op_name)
            if any(t in needed for t in tops):
                region.append(op_name)
                needed.difference_update(tops)
                needed.update(d for d in deps_of(op_name) if d != a_node)
        region.reverse()
        ext = [n for n in needed if n not in pipe.weights and not n.endswith("__folded")]
        if not region or ext:
            raise ConfigError(f"batch_split region {spec!r}: external data deps {ext} "
                              f"(region must be closed between its in and out nodes)")
        internal = set()
        for u in region:
            internal.update(tops_of(u))
        internal.discard(b_node)
        inside = set(region)
        for op_name in units:
            leak = set() if op_name in inside else internal.intersection(deps_of(op_name))
            if leak:
                raise ConfigError(f"batch_split region {spec!r}: node(s) {sorted(leak)} "
                                  f"consumed outside the region")
        img = pipe.must_dims(a_node)["img"]
        if img % k != 0:
            raise ConfigError(f"batch_split region {spec!r}: k={k} does not divide "
                              f"batch {img}")
        regions.append({"a": a_node, "b": b_node, "k": k, "units": region,
                        "internal": internal})
    return regions


# FwdEngine.platform -> the torch device type it runs on
_PLATFORMS = {"": "", "cpu": "cpu", "gpu": "cuda", "cuda": "cuda"}


def _cuda_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _on(dev: torch.device):
    """The CUDA device context of ``dev`` (nothing for the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


@register_base("conv_fwd", tid_vn="mode")
class FwdEngine:
    """Abstract engine: init(pipe) then run_fwd(ins, out_names)."""

    precision = Field(str, default="highest", help="matmul precision: default/high/highest")
    # compute dtype override: 'bfloat16' casts weights at upload and inputs at
    # entry, computes the whole net in bf16, and returns outputs in each
    # node's logical dtype. '' = keep input dtypes (f32).
    compute_tn = Field(str, default="", help="compute dtype: '' | bfloat16 | float32")
    device = Field(str, default="",
                   help="torch device: cuda (the card; raises without one) | "
                        "cpu (kernels' plain versions, for tests); '' = the "
                        "platform's, else cuda")
    # boda_tpu's jax platform override (executor.py:48): the same names, on
    # torch's devices; a TPU has no counterpart here
    platform = Field(str, default="",
                     help="platform: '' (the engine's device) | cpu | gpu | cuda")
    train = Field(bool, default="0", help="training mode (dropout active)")
    det_drop_seed = Field(int, default="0", help="deterministic dropout seed")
    cuda_graph = Field(bool, default="1",
                       help="on the card, capture each forward once per key as a CUDA "
                            "graph and replay it; 0 = eager launches (per-launch host "
                            "timing, per-op debugging)")
    # per-node activation statistics computed on the card (ref var_stats.cucl /
    # gen_op_stats, rtc_fwd.cc:163); surfaced via get_info_log()
    per_layer_stats = Field(bool, default="0", help="collect per-node var stats")
    # fixed-point quantization injection (ref gen_op_quantize, rtc_fwd.cc:212):
    # node name -> (max_val=...,keep_bits=...) clamps + drops mantissa bits
    quantize = Field((dict, "lexp"), default="()",
                     help="per-node quantization: (node=(max_val=8,keep_bits=6),...)")
    # multi-device mesh (parallel/mesh.py), e.g. (dp=2,tp=4) over the local
    # devices of the engine's kind: dp runs the whole net on each device's
    # img slice; tp (kernel_policy=lib) splits the conv and fc weights over
    # out_chan. From code, a built Mesh, whose devices may repeat.
    mesh = Field("lexp", default="()", help="device mesh axes, e.g. (dp=2,tp=4)")
    # gen_src analog (ref rtc_compute.H:39-40; boda_tpu: executor.py:283-296):
    # once per forward key, the plan per op, and on the card the captured
    # graph and the PTX of the kernels' sources that it launches
    gen_src_dir = Field(str, default="",
                        help="write each forward's plan (and, on the card, its "
                             "captured graph and kernels' PTX) here")
    # boda_tpu's per-program XLA backend flags (executor.py:70): accepted
    # empty only, since no flag of XLA's has a counterpart here
    compiler_options = Field((dict, "lexp"), default="()",
                             help="XLA backend flags: () only (the port has no XLA)")

    def base_setup(self) -> None:
        self._resolve_device()
        flags = sorted(self.compiler_options or {})
        if flags:
            raise ConfigError(f"conv_fwd: compiler_options {flags}: XLA compiler flags, "
                              f"which have no counterpart in the port")
        if self.precision not in PRECISIONS:
            raise ConfigError(f"precision {self.precision!r}: have {sorted(PRECISIONS)}")
        if self.compute_tn:
            torch_dtype(self.compute_tn)
        self.pipe: Optional[ConvPipe] = None
        self._fn: Optional[Callable] = None
        self._fn_key = None
        self._info_log: list[str] = []
        self._weights_dev: dict[str, torch.Tensor] = {}
        self._graph: Optional[CapturedFwd] = None
        self._warm_key = None
        self._cur_op: Optional[str] = None  # the op net_fn is in (capture errors)
        self._last_stats: dict[str, np.ndarray] = {}
        self._quant: dict[str, tuple[float, int]] = {}
        for node, q in (self.quantize or {}).items():
            qv = {k: float(v.leaf_val) for k, v in q.kids}
            self._quant[node] = (qv.get("max_val", 8.0), int(qv.get("keep_bits", 8)))
        self._rec: Optional[_SrcRecord] = None  # the gen_src pass in progress
        self._dumped: set = set()  # the keys gen_src_dir has
        self._setup_mesh()

    def _resolve_device(self) -> None:
        """``device`` from ``platform`` (boda_tpu: ``FwdEngine.device()``,
        executor.py:136): '' keeps the engine's device (default cuda), cpu
        runs on the CPU, gpu and cuda on the card; any other platform, and
        one that contradicts an explicit device, raises."""
        want = _PLATFORMS.get(self.platform)
        if want is None:
            raise ConfigError(f"conv_fwd: platform {self.platform!r} has no counterpart "
                              f"in the port (have {sorted(_PLATFORMS)}; '' = the "
                              f"engine's device)")
        if self.device and want and torch.device(self.device).type != want:
            raise ConfigError(f"conv_fwd: platform {self.platform!r} contradicts "
                              f"device {self.device!r}")
        self.device = self.device or want or "cuda"

    def _setup_mesh(self) -> None:
        """The mesh (boda_tpu: executor.py:86-90) and its dp slices: the
        engine itself holds the first's state, a :class:`_Replica` each
        other's."""
        kind = torch.device(self.device).type
        m = self.mesh
        if isinstance(m, Mesh):
            self._mesh: Optional[Mesh] = m
        else:
            axes = {k: int(v.leaf_val) for k, v in (m.kids if m else [])}
            self._mesh = make_mesh(axes, kind=kind) if axes else None
        self._reps: list = [self]
        self._tp_devs: list = []
        self._tp_eager = False
        if self._mesh is None:
            return
        kinds = {d.type for d in self._mesh.devices.flat}
        if kinds != {kind}:
            raise ConfigError(f"conv_fwd: mesh devices of kind {sorted(kinds)}, "
                              f"engine device {self.device!r}")
        dp, tp = self._mesh.size("dp"), self._mesh.size("tp")
        rows = [[self._mesh.device(dp=i, tp=j) for j in range(tp)] for i in range(dp)]
        self._tp_devs = rows[0]
        self._reps += [_Replica(r) for r in rows[1:]]
        # one CUDA graph captures one device's work: a slice whose tp shards
        # lie on several cards runs eagerly
        self._tp_eager = any(len(set(r)) > 1 for r in rows)
        self._info_log.append(f"mesh {self._mesh}" + (
            "; tp over several cards: eager forwards, no CUDA graph" if self._tp_eager else ""))

    def _tp(self) -> int:
        return self._mesh.size("tp") if self._mesh is not None else 1

    @property
    def _lead(self) -> torch.device:
        return self.dev()

    def dev(self) -> torch.device:
        """The engine's device (under a mesh, its first device). No silent
        CPU fallback: device=cuda without a usable card raises."""
        d = self._mesh.device() if self._mesh is not None else torch.device(self.device)
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("conv_fwd: device=cuda but torch finds no CUDA "
                               "card; pass device=cpu to run the plain versions")
        if d.type not in ("cuda", "cpu"):
            raise ConfigError(f"conv_fwd: unsupported device {self.device!r}")
        return d

    def set_det_drop_seed(self, seed: int) -> None:
        """A new dropout seed (boda_tpu: executor.py:163-168): the lowerings
        are rebuilt, so the next forward draws the seed's masks."""
        self.det_drop_seed = seed
        if self.pipe is not None:
            self._fn = None
            self._fn_key = None
            self.init(self.pipe)

    def get_info_log(self) -> str:
        return "\n".join(self._info_log)

    # -- the logical-layout engine (boda_tpu: FwdEngine, executor.py:112-494) ---------

    def init(self, pipe: ConvPipe) -> None:
        """Lower every op by the logical-layout rules (graph/lowering.py) and
        upload the weights (cast to compute_tn, in their logical layout but
        where a lowering names another, ``_weight_preps``)."""
        self.pipe = pipe
        self._fn, self._fn_key = None, None
        self.drop_graph()
        self._weight_preps: dict[str, Prep] = {}
        self._prefold_plan, self._prefold_keys = {}, {}
        unknown = sorted(set(self._quant) - set(pipe.nodes))
        if unknown:
            raise ConfigError(f"quantize: no node {unknown} in {pipe.name!r}")
        ctx = self.lower_ctx()
        self._lowered: dict[str, Callable] = {}
        for op_name in pipe.topo_op_order():
            self._lowered[op_name] = self.lower_one(pipe, pipe.ops[op_name], ctx)
        self._upload_weights()

    def lower_ctx(self) -> LowerCtx:
        amax = None
        if getattr(self, "calib_fn", ""):
            from ..prof.calib import read_calib
            amax = read_calib(self.calib_fn)
        return LowerCtx(precision=self.precision, compute_tn=self.compute_tn,
                        act_amax=amax, device=str(self.dev()), train=self.train,
                        det_drop_seed=self.det_drop_seed)

    def lower_one(self, pipe: ConvPipe, op, ctx: LowerCtx) -> Callable:
        return lower_op(pipe, op, ctx)

    def _batch_split(self) -> tuple:
        return ()

    def build_raw_fn(self, out_names: list[str]) -> Callable:
        """fn(weights, inputs) -> {name: tensor} on the logical layout: every
        op's lowering in topo order, pruned to the ops that the requested
        outputs need from the given inputs (so a mid-graph node may be an
        input); quantize and per_layer_stats as boda_tpu's; under tp each
        split conv and fc through ``tp_call``; outputs in each node's
        logical dtype, weight gradients in the logical layout."""
        pipe = self.pipe
        topo = pipe.topo_op_order()
        lowered = self._lowered
        grad_inv = {n: prep.inv for n in out_names
                    for w, prep in self._weight_preps.items() if n.startswith(w + "__grad")}
        regions = resolve_batch_split(pipe, self._batch_split(), topo,
                                      lambda o: list(pipe.ops[o].tops),
                                      lambda o: list(pipe.ops[o].bots))
        cdt = torch_dtype(self.compute_tn) if self.compute_tn else None
        quant, stats = self._quant, bool(self.per_layer_stats)

        def net_fn(weights: dict, inputs: dict):
            ranges = torch.autograd.profiler._is_profiler_enabled
            tp, rec = weights.get("__tp__"), self._rec
            vals = dict(weights)
            vals.update((k, self._ingest(k, v)) for k, v in inputs.items())
            stat_out = {}
            needed = set(out_names)
            run_ops = set()
            for op_name in reversed(topo):
                op = pipe.ops[op_name]
                if any(t in needed and t not in vals for t in op.tops):
                    run_ops.add(op_name)
                    needed.update(op.bots)

            def exec_one(op_name, look):
                op = pipe.ops[op_name]
                try:
                    bot_vals = [look(b) for b in op.bots]
                except KeyError as e:
                    raise PipeError(f"op {op_name!r}: missing input {e}") from None
                self._cur_op = op_name
                fn, args = lowered[op_name], bot_vals
                if tp is not None and op.type in ("Convolution", "InnerProduct") \
                        and op.bots[1] in tp.parts:
                    fn, args = functools.partial(tp_call, fn, devs=tp.devs, out_dim=1), (
                        [tp.parts.get(b, v) for b, v in zip(op.bots, bot_vals)],)
                if rec is not None:
                    n_k, n_l = len(rec.kernels), len(rec.lib)
                if ranges:
                    with torch.profiler.record_function(op_name):
                        outs = fn(*args)
                else:
                    outs = fn(*args)
                if rec is not None:
                    rec.ops[op_name] = {
                        "in": [(b, kcommon.describe(v)) for b, v in zip(op.bots, bot_vals)],
                        "out": [(t, kcommon.describe(v)) for t, v in zip(op.tops, outs)],
                        "kernels": rec.kernels[n_k:], "lib": rec.lib[n_l:]}
                return list(zip(op.tops, outs))

            def store(t, v):
                if t in quant:
                    v = _quantize(v, *quant[t])
                if stats and v.is_floating_point():
                    v32 = v.float()
                    stat_out[t] = torch.stack([v32.min(), v32.max(), v32.sum(),
                                               (v32 * v32).sum()])
                return v
            self._run_topo(topo, run_ops, regions, vals, out_names, exec_one, store)
            self._cur_op = None
            res = {}
            for n in out_names:
                v = vals[n]
                if n in grad_inv:
                    v = grad_inv[n](v)
                if cdt is not None:
                    v = v.to(torch_dtype(pipe.must_dims(n).tn))
                res[n] = v.contiguous()
            if stats:
                res["__stats__"] = stat_out
            return res

        return net_fn

    def _run_topo(self, topo, run_ops, regions, vals, out_names, exec_one, store,
                  inner=lambda t, v: v) -> None:
        """Run the ops of ``run_ops`` in topo order into ``vals``:
        ``exec_one(op, look)`` gives an op's (top, value) pairs, its inputs
        read through ``look``; ``store(top, value)`` is the value kept. A
        batch_split region whose units all run and no node inside which is
        an input or a requested output runs as k chunks of its in node's
        img dim, its units in order per chunk, and the chunks of its out
        node concatenated (boda_tpu: executor.py:1626-1650), a value inside
        kept as ``inner(top, value)``; the regions that applied are in
        ``_bs_applied``."""
        unit_region = {}
        for reg in regions:
            if all(u in run_ops for u in reg["units"]) and \
                    not reg["internal"].intersection(vals) and \
                    not reg["internal"].intersection(out_names):
                for u in reg["units"]:
                    unit_region[u] = reg
        self._bs_applied = sorted({(r["a"], r["b"]) for r in unit_region.values()})
        done = set()
        for op_name in topo:
            if op_name not in run_ops:
                continue
            reg = unit_region.get(op_name)
            if reg is None:
                for t, v in exec_one(op_name, vals.__getitem__):
                    vals[t] = store(t, v)
                continue
            if id(reg) in done:
                continue
            done.add(id(reg))
            xa = vals[reg["a"]]
            parts = []
            for xc in torch.split(xa, xa.shape[0] // reg["k"], dim=0):
                rv = {reg["a"]: xc}
                for u in reg["units"]:
                    for t, v in exec_one(u, lambda n, rv=rv: rv[n] if n in rv else vals[n]):
                        rv[t] = inner(t, v)
                parts.append(rv[reg["b"]])
            vals[reg["b"]] = store(reg["b"], torch.cat(parts, dim=0))

    def _upload_weights(self) -> None:
        """The weights on each dp slice's device: cast, prepped, prefolded;
        under tp also each split weight's shards on the slice's devices."""
        self.drop_graph()
        for rep in self._reps:
            rep._weights_dev = self._upload_to(rep._lead)
            if self._tp() > 1:
                rep._weights_dev["__tp__"] = self._tp_shards(rep._weights_dev, rep._tp_devs)

    def _upload_to(self, d: torch.device) -> dict[str, torch.Tensor]:
        cdt = torch_dtype(self.compute_tn) if self.compute_tn else None
        wd = {}
        for k, w in self.pipe.weights.items():
            t = torch.from_numpy(np.ascontiguousarray(w.data)).to(d)
            if cdt is not None:  # cast first, then prep and fold
                t = t.to(cdt)
            prep = self._weight_preps.get(k)
            if prep is not None:
                t = prep.prep(t)
            wd[k] = t
        for wf, (wk, bk, fkeys, fold) in self._prefold_plan.items():
            wd[wf], wd[bk + "__folded"] = fold(wd[wk], wd[bk], [wd[k] for k in fkeys])
        return wd

    def _tp_shards(self, wd: dict, devs: list) -> _TpShards:
        """The shards of every groups-1 conv's and every fc's filters that
        boda_tpu's rule splits over tp (parallel/mesh.py:weight_shardings),
        and of their biases, raw and prefolded, along out_chan's axis of the
        uploaded layout."""
        parts = {}
        split = weight_shardings(self.pipe, self._mesh)
        for op in self.pipe.ops.values():
            if op.type not in ("Convolution", "InnerProduct") or \
                    int(op.p("groups", 1)) != 1 or "tp" not in split[op.bots[1]]:
                continue
            prep = self._weight_preps.get(op.bots[1])
            axis = prep.oc_axis if prep is not None else split[op.bots[1]].index("tp")
            keys = [(op.bots[1], axis)] + [(b, 0) for b in op.bots[2:3]]
            if op.name in self._prefold_keys:
                wf, bf = self._prefold_keys[op.name]
                keys += [(wf, axis), (bf, 0)]
            for key, ax in keys:
                parts[key] = split_tensor(wd[key], ax, devs)
        return _TpShards(devs, parts)

    def _is_4d(self, node: str) -> bool:
        d = self.pipe.nodes[node].dims
        return d is not None and d.names == ("img", "chan", "y", "x")

    def _ingest(self, k: str, v: torch.Tensor) -> torch.Tensor:
        """An input as net_fn holds it: cast to the compute dtype, in the
        logical layout."""
        if self.compute_tn and v.is_floating_point():
            v = v.to(torch_dtype(self.compute_tn))
        return v

    def per_layer_times(self, ins: dict[str, NDA], n_iters: int = 10) -> dict[str, float]:
        """Device seconds per call of each op's own (unfused) lowering, timed
        alone on the activations of one full forward (boda_tpu:
        executor.py:357-395): ``n_iters`` calls captured in one CUDA graph
        and replayed between two CUDA events (rtc/backends.py:graph_time),
        so the host's cost per launch stays out. An op whose inputs the
        forward does not give, or whose timing raises, is skipped with an
        info-log line. Raises off the card, as time_fwd does."""
        d = self.dev()
        if d.type != "cuda":
            raise RuntimeError("per_layer_times times the card; this engine runs on "
                               f"{d} (a CPU time is not a device metric)")
        pipe = self.pipe
        acts = self.run_fwd(ins, [n for n, node in pipe.nodes.items()
                                  if node.dims is not None and node.top_for
                                  and n not in pipe.weights and n not in ins])
        acts.update(ins)
        vals = dict(self._weights_dev)
        vals.update((k, self._ingest(k, torch.from_numpy(np.ascontiguousarray(v.data)).to(d)))
                    for k, v in acts.items())
        out: dict[str, float] = {}
        with self._run_ctx():
            for op_name in pipe.topo_op_order():
                op = pipe.ops[op_name]
                try:
                    bots = [vals[b] for b in op.bots]
                except KeyError:
                    continue
                fn = self._lowered[op_name]
                try:
                    out[op_name] = graph_time(lambda fn=fn, bots=bots: fn(*bots), n_iters)
                except Exception as e:
                    self._info_log.append(f"per_layer_times: {op_name} skipped ({e})")
        return out

    def compile_for(self, out_names: list[str]) -> None:
        key = tuple(out_names)
        if self._fn_key != key:
            self._check_mesh(out_names)
            self._fn = self.build_raw_fn(list(out_names))
            self._fn_key = key

    def _check_mesh(self, out_names: list[str]) -> None:
        """Under dp, each output is gathered over its img dim."""
        if len(self._reps) == 1:
            return
        for n in out_names:
            d = self.pipe.must_dims(n)
            if "img" not in d.names:
                raise PipeError(f"mesh dp={len(self._reps)}: output {n!r} {d} has no "
                                f"img dim to gather the slices over")

    def _graphed(self) -> bool:
        return bool(self.cuda_graph) and self.dev().type == "cuda" and not self._tp_eager

    def drop_graph(self) -> None:
        """Free the captured forward (its graph, memory pool and static
        tensors) of every dp slice. Done on init, on every weight upload (a
        graph holds the weights' addresses and host-encoded tensor maps by
        value) and before a new key is captured: an engine holds one graph
        (per dp slice) at a time."""
        for rep in self._reps:
            rep._graph = None
            rep._warm_key = None

    @staticmethod
    def _graph_key(ins: dict[str, NDA], out_names: list[str]) -> tuple:
        return (tuple(sorted((k, tuple(v.data.shape), str(v.data.dtype))
                             for k, v in ins.items())), tuple(out_names))

    def _slices(self, ins: dict[str, NDA]) -> list[dict[str, NDA]]:
        """The inputs of each dp slice: img split over dp (boda_tpu's
        shard_map in_specs, executor.py:762); without a mesh, the inputs."""
        dp = len(self._reps)
        if dp == 1:
            return [ins]
        out: list[dict[str, NDA]] = [{} for _ in range(dp)]
        for k, v in ins.items():
            if "img" not in v.dims.names or v.dims["img"] % dp:
                raise PipeError(f"mesh dp={dp}: input {k!r} {v.dims} has no img dim "
                                f"that dp divides")
            ax, n = v.dims.index("img"), v.dims["img"] // dp
            d = v.dims.with_size("img", n)
            for i in range(dp):
                out[i][k] = NDA(d, np.take(v.data, np.arange(i * n, (i + 1) * n), axis=ax))
        return out

    def _gather(self, parts: list[dict], out_names: list[str]) -> dict:
        """The dp slices' outputs concatenated over img on the first device;
        per_layer_stats combined over the slices."""
        lead = self.dev()
        res = {n: torch.cat([p[n].to(lead) for p in parts],
                            dim=self.pipe.must_dims(n).index("img")) for n in out_names}
        if "__stats__" in parts[0]:
            st = {}
            for n in parts[0]["__stats__"]:
                s = torch.stack([p["__stats__"][n].to(lead) for p in parts])
                st[n] = torch.stack([s[:, 0].min(), s[:, 1].max(), s[:, 2].sum(),
                                     s[:, 3].sum()])
            res["__stats__"] = st
        return res

    def prepare(self, ins: dict[str, NDA], out_names: list[str]) -> None:
        """Build the forward for (ins, out_names) and, under ``cuda_graph``
        on the card, run the eager warm-up forward its capture needs, on a
        side stream (under a mesh, each dp slice's on its slice): it builds
        the kernels, sets their shared-memory attributes, fills the plan
        caches, lets cuDNN and cuBLAS choose their algorithms and makes the
        pool divisors. The launch counters tick for it. run_fwd and time_fwd
        call it for a new key; a caller that wants the counts of the
        captured forward alone calls it first and zeroes them after."""
        self.compile_for(out_names)
        if not self._graphed():
            return
        for rep, sl in zip(self._reps, self._slices(ins)):
            self._prepare_rep(rep, sl, out_names)

    def _prepare_rep(self, rep, ins: dict[str, NDA], out_names: list[str]) -> None:
        key = self._graph_key(ins, out_names)
        if key == rep._warm_key or (rep._graph is not None and rep._graph.key == key):
            return
        dev_ins = self._put_inputs(ins, rep._lead)
        self.warm_up(lambda w: self._fn(w, dev_ins), rep)
        rep._warm_key = key

    def _captured(self, ins: dict[str, NDA], out_names: list[str], rep=None) -> CapturedFwd:
        """The captured forward for (ins, out_names) of a dp slice (default:
        the engine's own): its graph if it has this key, else a new capture
        after the warm-up. A capture that fails raises, naming the op it was
        in; nothing runs eagerly in its place. Under gen_src_dir, a new key's
        warm-up records the plan, and the graph is captured in debug mode."""
        rep = rep or self
        key = self._graph_key(ins, out_names)
        if rep._graph is not None and rep._graph.key == key:
            return rep._graph
        dump = rep is self and self._src_pending(key)
        rec = None
        if dump:  # the warm-up forward records the plan
            rep._warm_key = None
            with self._recording() as rec:
                self._prepare_rep(rep, ins, out_names)
        else:
            self._prepare_rep(rep, ins, out_names)
        rep._graph = None  # free the old key's graph before capturing
        static_ins = self._put_inputs(ins, rep._lead)
        rep._graph = self.capture_graph(lambda w: self._fn(w, static_ins), key, static_ins,
                                        rep, debug=dump)
        rep._warm_key = None
        if dump:
            self._dump_src(key, rec, rep._graph)
        return rep._graph

    def run_eager(self, forward: Callable[[dict], Any], rep=None) -> Any:
        """``forward(weights)`` once, eagerly, under the run context: the
        uploaded weights (of a dp slice; default: the engine's own) as a
        ``build_raw_fn`` function takes them."""
        rep = rep or self
        with self._run_ctx(), _on(rep._lead):
            return forward(rep._weights_dev)

    def warm_up(self, forward: Callable[[dict], Any], rep=None) -> None:
        """The eager warm-up that a capture of ``forward(weights)`` needs:
        one call on a side stream (kernel builds, shared-memory attributes,
        plan caches, the libraries' algorithm choices), then a sync. The
        launch counters tick for it."""
        rep = rep or self
        d = rep._lead
        side_stream_warmup(lambda: self.run_eager(forward, rep), 1, d)
        torch.cuda.synchronize(d)

    def capture_graph(self, forward: Callable[[dict], dict], key: tuple = (),
                      ins: Optional[dict] = None, rep=None, debug: bool = False) -> CapturedFwd:
        """``forward(weights)``, a function of static device tensors
        (``ins``) that returns a dict of outputs, captured as one CUDA graph
        under the run context (call ``warm_up`` first) on the device of a dp
        slice (default: the engine's own): the outputs become the handle's
        static outputs, which each replay overwrites. A capture that fails
        raises, naming the op it was in; nothing runs eagerly in its place.
        The engine's own forward and any caller's (a preprocess in front of
        a ``build_raw_fn`` net, say) are captured here alone. ``debug``
        keeps the graph for ``debug_dump``."""
        rep = rep or self
        graph = torch.cuda.CUDAGraph(keep_graph=debug)  # debug_dump reads the kept graph
        if debug:
            graph.enable_debug_mode()
        self._cur_op = None
        t0 = time.perf_counter()
        # under a mesh, a capture stream of the slice's own card
        stream = torch.cuda.Stream(rep._lead) if self._mesh is not None else None
        try:
            with self._run_ctx(), _on(rep._lead), capture(graph, stream):
                outs = forward(rep._weights_dev)
        except Exception as e:
            where = f"op {self._cur_op!r}" if self._cur_op else "the end of the capture"
            raise RuntimeError(f"conv_fwd: the CUDA-graph capture failed at {where}: "
                               f"{type(e).__name__}: {e}") from e
        if debug:
            graph.instantiate()
        return CapturedFwd(key, graph, ins or {}, outs, time.perf_counter() - t0)

    def _put_inputs(self, ins: dict[str, NDA], dev: Optional[torch.device] = None
                    ) -> dict[str, torch.Tensor]:
        d = dev or self.dev()
        return {k: torch.from_numpy(np.ascontiguousarray(v.data)).to(d)
                for k, v in ins.items()}

    def _run_ctx(self) -> contextlib.ExitStack:
        """The context of one forward: the engine's precision on the library
        ops, under inference_mode, or under no_grad for a graph with
        backward ops (its Bck ops turn autograd on for their recompute, and
        inference tensors cannot enter autograd)."""
        stack = contextlib.ExitStack()
        autograd = self.pipe.bck_added or any(op.type in AUTOGRAD_RULES
                                              for op in self.pipe.ops.values())
        stack.enter_context(torch.no_grad() if autograd else torch.inference_mode())
        stack.enter_context(lib_precision(self.precision))
        return stack

    def _run_rep(self, rep, ins: dict[str, NDA], out_names: list[str]) -> dict:
        """One dp slice's forward (default: the engine's own): a replay of
        its captured graph, or an eager forward."""
        if self._graphed():
            g = self._captured(ins, out_names, rep)
            with _on(rep._lead):
                g.load(ins)
                g.graph.replay()
            return dict(g.outs)
        key = self._graph_key(ins, out_names)
        dump = rep is self and self._src_pending(key)
        dev_ins = self._put_inputs(ins, rep._lead)
        with (self._recording() if dump else contextlib.nullcontext()) as rec:
            outs = self.run_eager(lambda w: self._fn(w, dev_ins), rep)
        if dump:
            self._dump_src(key, rec, None)
        return outs

    def run_fwd(self, ins: dict[str, NDA], out_names: list[str]) -> dict[str, NDA]:
        self.compile_for(out_names)
        parts = [self._run_rep(rep, sl, out_names)
                 for rep, sl in zip(self._reps, self._slices(ins))]
        outs = parts[0] if len(parts) == 1 else self._gather(parts, out_names)
        stats = outs.pop("__stats__", None)
        if stats is not None:
            self._last_stats = {n: stats[n].cpu().numpy() for n in sorted(stats)}
            for n, s in self._last_stats.items():
                cnt = self.pipe.must_dims(n).num_elems()
                self._info_log.append(
                    f"var_stats {n}: min={s[0]:.6g} max={s[1]:.6g} "
                    f"avg={s[2] / cnt:.6g} sum_sq={s[3]:.6g} cnt={cnt}")
        res = {}
        for n, t in outs.items():
            t = t.detach().cpu()
            if t.dtype == torch.bfloat16:  # numpy has no bf16: host f32
                t = t.float()
            res[n] = NDA(self.pipe.must_dims(n), t.numpy())
        return res

    def time_fwd(self, ins: dict[str, NDA], out_names: list[str],
                 n_iters: int = 20, warmup: int = 3) -> float:
        """Seconds per whole-net forward on the card: `warmup` forwards, then
        `n_iters` forwards between two CUDA events on the current stream.
        Under ``cuda_graph`` each forward is one replay of the captured graph,
        so the host is out of the loop (boda_tpu's on-device chain, executor.py
        :400-493); with ``cuda_graph=0`` each is an eager forward, and the
        reading includes the host's dispatch. Under a mesh each forward
        replays every dp slice's graph, and the second event waits for every
        device's work (boda_tpu times its mesh without the chain, :425)."""
        d = self.dev()
        if d.type != "cuda":
            raise RuntimeError("time_fwd times the card; this engine runs on "
                               f"{d} (a CPU time is not a device metric)")
        self.compile_for(out_names)
        with contextlib.ExitStack() as stack:
            runs = []
            if not self._graphed():
                stack.enter_context(self._run_ctx())
            for rep, sl in zip(self._reps, self._slices(ins)):
                if self._graphed():
                    g = self._captured(sl, out_names, rep)
                    with _on(rep._lead):
                        g.load(sl)
                    runs.append((rep._lead, g.graph.replay))
                else:
                    dev_ins = self._put_inputs(sl, rep._lead)
                    runs.append((rep._lead, functools.partial(self._fn, rep._weights_dev,
                                                              dev_ins)))

            def run():
                for dv, r in runs:
                    with _on(dv):
                        r()
            for _ in range(max(1, warmup)):
                run()
            devs = list(dict.fromkeys(_cuda_index(dv) for dv, _ in runs))
            for i in devs:
                torch.cuda.synchronize(i)
            s0 = torch.cuda.current_stream(d)
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record(s0)
            for _ in range(n_iters):
                run()
            for i in devs:  # the last event waits for every device's forwards
                if i != _cuda_index(d):
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(i))
                    s0.wait_event(ev)
            t1.record(s0)
            t1.synchronize()
        return t0.elapsed_time(t1) / 1e3 / n_iters

    # -- gen_src ----------------------------------------------------------------

    def _src_pending(self, key: tuple) -> bool:
        return bool(self.gen_src_dir) and key not in self._dumped

    @contextlib.contextmanager
    def _recording(self):
        """Record one forward for gen_src: net_fn notes each op it runs, the
        kernel entries their calls (ops/kernels/common.py:recording), and a
        TorchFunctionMode the library's calls outside a kernel entry."""
        from torch.overrides import TorchFunctionMode
        rec = _SrcRecord()

        class LibCalls(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                mod = getattr(func, "__module__", None)
                if mod and mod.startswith("torch") and not kcommon.in_kernel():
                    rec.lib.append(f"{mod}.{func.__name__}")
                return func(*args, **(kwargs or {}))
        with kcommon.recording() as calls, LibCalls():
            rec.kernels = calls
            self._rec = rec
            try:
                yield rec
            finally:
                self._rec = None

    def _dump_src(self, key: tuple, rec: _SrcRecord, graph: Optional[CapturedFwd]) -> None:
        """Write the gen_src files of one key (boda_tpu: executor.py:283-296)
        under gen_src_dir (a relative one under the mode's output dir):
        ``<pipe>_<hash>.plan.txt`` always; on the card the captured graph,
        ``<pipe>_<hash>.cuda_graph.dot``, and the PTX of each kernel source
        the forward launched, ``<source>.ptx``."""
        import os

        from ..config import get_env
        from ..ops.kernels import build
        from ..utils.dims import stable_hash
        d = self.gen_src_dir
        if not os.path.isabs(d):
            d = os.path.join(get_env().get("boda_output_dir", "."), d)
        os.makedirs(d, exist_ok=True)
        tag = f"{self.pipe.name}_{stable_hash(repr(key)) & 0xFFFF:04x}"
        with open(os.path.join(d, f"{tag}.plan.txt"), "w") as f:
            f.write(self._plan_text(key, rec))
        wrote = [f"{tag}.plan.txt"]
        if graph is not None:
            graph.graph.debug_dump(os.path.join(d, f"{tag}.cuda_graph.dot"))
            wrote.append(f"{tag}.cuda_graph.dot")
        if self.dev().type == "cuda":
            srcs = sorted({build.KERNEL_SOURCES[c.kernel] for c in rec.kernels})
            wrote += build.write_ptx(srcs, d)
        self._dumped.add(key)
        self._info_log.append(f"gen_src: wrote {', '.join(wrote)}")

    def _plan_text(self, key: tuple, rec: _SrcRecord) -> str:
        """Each op of the pipe in topo order: the ops a forward ran with
        their rule (the lowering's log lines), the chain ops fused into them,
        their bots and tops, and their calls (a kernel entry with its route
        and plan, or the library's functions); the others as fused or not
        run."""
        ins = ", ".join(f"{k} {dt}[{','.join(map(str, sh))}]" for k, sh, dt in key[0])
        lines = [f"# {self.pipe.name}: inputs {ins}; outputs {', '.join(key[1])}",
                 f"# engine: device={self.dev()} " + self._plan_engine()]
        fused_into = {c: head for head, chain in rec.chains.items() for c in chain}
        for i, op_name in enumerate(self.pipe.topo_op_order()):
            op = self.pipe.ops[op_name]
            head = f"{i} {op_name} {op.type}"
            if op_name in fused_into:
                lines.append(f"{head}: fused into {fused_into[op_name]}")
                continue
            r = rec.ops.get(op_name)
            if r is None:
                lines.append(f"{head}: not run (no requested output needs it)")
                continue
            lines.append(head)
            lines += [f"  rule: {ln.split(': ', 1)[1]}" for ln in dict.fromkeys(self._info_log)
                      if ln.startswith(f"{op_name}: ")]
            if op_name in rec.chains:
                lines.append(f"  fused: {', '.join(rec.chains[op_name])}")
            lines.append("  in: " + ", ".join(f"{n} {t}" for n, t in r["in"]))
            lines.append("  out: " + ", ".join(f"{n} {t}" for n, t in r["out"]))
            for c in r["kernels"]:
                plan = c.plan if isinstance(c.plan, str) else repr(c.plan)
                route = getattr(c.plan, "path", getattr(c.plan, "route", c.plan))
                lines.append(f"  kernel: {c.kernel} {c.entry} route={route} plan={plan} "
                             f"({' '.join(c.operands)})")
            if not r["kernels"]:
                lines.append("  kernel: library " + (", ".join(dict.fromkeys(r["lib"]))
                                                     or "(no call: a view)"))
        return "\n".join(lines) + "\n"

    def _plan_engine(self) -> str:  # pragma: no cover
        return ""


@register("conv_fwd", "cuda", help="NHWC engine: hand CUDA kernels for conv/fc "
                                   "(kernel_policy=gen) or cuDNN/cuBLAS (lib)")
class CudaFwd(FwdEngine):
    tune = Field("lexp", default="()", help="default op_tune for generated kernels")
    per_op_tune = Field((dict, "lexp"), default="()", help="per-op-name tune overrides")
    # conv+ReLU fusion, generalized to conv -> [BN] -> [Scale] -> [ReLU]:
    # applied per call, only when no chain intermediate is a requested output
    fuse_relu = Field(bool, default="1", help="fuse BN/Scale/ReLU into conv/fc stores")
    # residual fusion: fold Eltwise(sum)+ReLU tails (ResNet blocks) into the
    # producing conv kernel's store epilogue
    fuse_eltwise = Field(bool, default="1", help="fuse residual add into conv stores")
    # whole-bottleneck fusion: conv1x1+BN/Scale+ReLU -> conv3x3 -> conv1x1 +
    # skip + ReLU as one kernel (ops/kernels/block.py), h1/h2 never in HBM
    fuse_block = Field(bool, default="0", help="fuse residual bottleneck blocks")
    # fold BN/Scale into the conv weights once at upload instead of in every
    # forward (inference weights are frozen)
    prefold = Field(bool, default="1", help="fold BN/Scale at upload, not per-forward")
    # boda_tpu defaults to lib on the strength of a TPU v5e measurement
    # (boda_tpu/graph/executor.py:584-592) that says nothing about an H100;
    # the port's subject is its hand kernels, so gen is the default here
    kernel_policy = Field(str, default="gen",
                          help="conv/fc default: gen (hand CUDA kernels; the "
                               "port's default, unlike boda_tpu's TPU-measured "
                               "lib) | lib (cuDNN/cuBLAS)")

    # autotuning wisdom: best recorded tune per op signature + platform
    # (ref: per-op tune selection from wisdom files, op-tuner.cc)
    wisdom_fn = Field("filename", default="", help="wisdom file for per-op tunes")
    # host-side stem space-to-depth (boda_tpu: executor.py:550-562): the data
    # loader feeds the net input already folded to the stem_s2d layout
    # (N, oy+m-1, ox+m-1, s*s*C) (host_input_s2d), so the starved-C stem conv
    # runs as a stride-1 conv on s*s*C channels with no fold per forward.
    # Forces tune.stem_s2d=1 on the qualifying input conv; logical-layout and
    # plain-NHWC inputs remain accepted (the fold then runs on the card).
    input_s2d = Field(bool, default="0",
                      help="accept net input pre-folded to the stem_s2d layout")
    # entry channel pad on top of input_s2d: the loader emits the folded input
    # with channels zero-padded to this count, and the stem weights pad to
    # match at upload. 0 = exact folded channels. Requires input_s2d.
    input_pad_c = Field(int, default="0",
                        help="pad the pre-folded entry channels to this count")
    # int8 conv/fc compute (boda_tpu: executor.py:559-583): per-tensor act
    # scales, per-out-channel weight scales, an int32 accumulator; the
    # engine-wide default, which a per-op tune's int8=0 turns off
    int8 = Field(bool, default="0", help="int8 conv/fc compute")
    # static calibration sidecar (net_calib): per-node act amax, so int8
    # conv/fc quantize with a static scale instead of a per-forward amax
    calib_fn = Field("filename", default="", help="activation-amax calibration file")
    # int8 activation storage, apart from int8 compute: the listed nodes
    # (names or glob patterns) are stored as int8, or uint8 where their
    # producer is provably non-negative, with static per-tensor scales from
    # calib_fn, and dequantized on every read; inference only
    act_int8 = Field((list, str), default="()",
                     help="store these activation nodes as int8 (glob ok)")

    def base_setup(self) -> None:
        super().base_setup()
        if self.kernel_policy not in ("gen", "lib"):
            raise ConfigError(f"kernel_policy {self.kernel_policy!r}: gen | lib")
        self._wisdom = None
        self._input_s2d: dict[str, dict] = {}
        self._input_s2d_ops: set[str] = set()
        self._act_q: dict[str, tuple[bool, float]] = {}
        self._q8_direct: set[str] = set()
        if self._mesh is not None and (self.int8 or self.act_int8) and \
                len(set(self._mesh.devices.flat)) > 1:
            raise ConfigError("conv_fwd: int8 under a mesh of several devices is not "
                              "supported (its static scales are made on one device)")

    def _check_mesh(self, out_names: list[str]) -> None:
        super()._check_mesh(out_names)
        # boda_tpu: executor.py:742-747; the hand kernels shard dp only
        if self._tp() > 1 and self.kernel_policy != "lib":
            raise PipeError("the cuda engine shards dp only with generated kernels "
                            "(kernel_policy=gen); use kernel_policy=lib for tp")

    def _plan_engine(self) -> str:
        return (f"kernel_policy={self.kernel_policy} compute_tn={self.compute_tn or 'float32'} "
                f"fuse_block={int(self.fuse_block)} tune={self.tune} "
                f"cuda_graph={int(self._graphed())}"
                + (f" mesh={self._mesh}" if self._mesh is not None else ""))

    def _graph_key(self, ins: dict[str, NDA], out_names: list[str]) -> tuple:
        return super()._graph_key(ins, out_names) + \
            (bool(self.int8), tuple(sorted(map(str, self.act_int8))))

    def fusion_fingerprint(self) -> str:
        """Stable tag of the engine configuration that shapes what a 'good'
        per-op tune is (boda_tpu: executor.py:611; fusion structure, dtype,
        precision, policy and int8, over this engine's own Fields). Wisdom
        recorded under one fingerprint is not applied under another."""
        from ..utils.dims import stable_hash
        cfg = (getattr(self, "layout", "nhwc"), bool(self.fuse_relu), bool(self.fuse_eltwise),
               self.compute_tn, self.precision, self.kernel_policy) + \
            (("block",) if self.fuse_block else ()) + \
            (("prefold",) if self.prefold else ()) + \
            (("input_s2d",) if self.input_s2d else ()) + \
            ((f"pad_c{self.input_pad_c}",) if self.input_pad_c else ()) + \
            (("int8",) if self.int8 else ()) + \
            (("act_int8",) + tuple(sorted(map(str, self.act_int8)))
             if self.act_int8 else ()) + \
            tuple(sorted(map(str, self._batch_split())))
        return f"{stable_hash(repr(cfg)) & 0xFFFFFFFF:08x}"

    def wisdom_plats(self) -> tuple[str, str]:
        """(net-context plat tag, standalone plat tag) for wisdom records:
        ``net:cuda:<card>:<fingerprint>`` and ``cuda:<card>``, the latter
        the cuda backend's own tag, so the engine finds what ``ops_prof``
        wrote on the same card."""
        from ..rtc.backends import plat_tag
        plat = plat_tag(self.dev())
        return f"net:{plat}:{self.fusion_fingerprint()}", plat

    def wisdom_sig(self, op_name: str):
        """The signature this engine uses for wisdom lookup of op_name: the
        rtc sig with dims re-typed to the engine's compute dtype (as
        boda_tpu's, executor.py:636), so writers and readers key alike."""
        from ..ops.sig_of import rtc_sig_of
        sig = rtc_sig_of(self.pipe, self.pipe.ops[op_name]) \
            if self.pipe is not None and op_name in self.pipe.ops else None
        if sig is None:
            return None
        if self.compute_tn:  # wisdom keys carry the compute dtype
            sig.dims_vals = {k: d.with_tn(self.compute_tn)
                             for k, d in sig.dims_vals.items()}
        return sig

    def _wisdom_tune(self, op_name: str):
        """Best recorded tune for this op's signature on this platform
        (boda_tpu: executor.py:651). Preference order: net-level runs with
        our fusion fingerprint, then standalone runs for this device, then
        standalone runs from other platforms (a TPU's, from a committed
        wisdom file: they transfer imperfectly but harmlessly, and their
        TPU-only knobs have no effect here). Net runs from another
        fingerprint are ignored (they tuned a different program)."""
        if not self.wisdom_fn:
            return None
        if self._wisdom is None:
            from ..prof.wisdom import read_wisdom
            self._wisdom = {w.op.key(): w for w in read_wisdom(self.wisdom_fn)}
        sig = self.wisdom_sig(op_name)
        if sig is None:
            return None
        w = self._wisdom.get(sig.key())
        if w is None:
            return None
        net_plat, plat = self.wisdom_plats()
        best = w.best(net_plat) or w.best(plat)
        if best is None:
            standalone = [r for r in w.runs if not r.plat.startswith("net:")]
            ab = [r for r in standalone if r.method == "ab"]  # trust tiers
            standalone = ab or standalone
            best = min(standalone, key=lambda r: r.secs) if standalone else None
        if best is None:
            return None
        self._info_log.append(f"{op_name}: wisdom tune {best.tune} "
                              f"({best.secs * 1e6:.1f}us on {best.plat})")
        from ..utils.lexp import parse_lexp
        return parse_lexp(best.tune)

    def op_tune(self, op_name: str) -> OpTune:
        """The op's tune: a per-op tune wins, then wisdom, then the engine
        tune; the engine's int8 unless the op's own tune names int8."""
        t = self.per_op_tune.get(op_name)
        if t is None:
            t = self._wisdom_tune(op_name)
        tune = OpTune.from_lexp(t) if t is not None else OpTune.from_lexp(self.tune)
        if tune.no_effect():
            self._info_log.append(f"{op_name}: tune knobs with no effect on the "
                                  f"card: {','.join(tune.no_effect())}")
        # the engine's precision is the default unless the tune overrides
        # it; bf16 compute always runs bf16 inputs with an f32 accumulator
        if (t is None or t.get_kid("precision") is None) and \
                "precision" not in str(self.tune):
            prec = "default" if self.compute_tn == "bfloat16" else self.precision
            tune = dataclasses.replace(tune, precision=prec)
        if self.int8 and (t is None or t.get_kid("int8") is None):
            tune = dataclasses.replace(tune, int8=True)
        # library policy: only when no explicit per-op tune exists and the
        # engine-level tune doesn't mention use_xla
        explicit = t is not None and bool(t.leaf_val if t.is_leaf else t.kids)
        if self.kernel_policy == "lib" and not explicit \
                and "use_xla" not in str(self.tune):
            tune = dataclasses.replace(tune, use_xla=True)
        # tp splits the library path's convs and fcs: a per-op or wisdom tune
        # naming a hand kernel is forced to the library under tp, as boda_tpu
        # forces it for GSPMD (executor.py:713-725); kernel_policy=gen with tp
        # raises at the first forward (_check_mesh)
        if not tune.use_xla and self.kernel_policy == "lib" and self._tp() > 1:
            self._info_log.append(f"{op_name}: tp>1 forces use_xla (gen tune deferred)")
            tune = dataclasses.replace(tune, use_xla=True)
        # an input_s2d stem must lower by the stem_s2d rule (the pre-folded
        # input shape only matches that rule's conv): over wisdom and policy
        if op_name in self._input_s2d_ops:
            tune = dataclasses.replace(tune, stem_s2d=1, pad_c=self.input_pad_c)
        return tune

    def init(self, pipe: ConvPipe) -> None:
        self.pipe = pipe
        self._fn, self._fn_key = None, None
        self.drop_graph()
        self._weight_preps: dict[str, Prep] = {}
        self._lowered: dict[str, Callable] = {}
        self._lowered_fused: dict[str, Callable] = {}
        amax = None
        if self.calib_fn:
            from ..prof.calib import read_calib
            amax = read_calib(self.calib_fn)
        ctx = LowerCtx(precision=self.precision, compute_tn=self.compute_tn,
                       act_amax=amax, device=str(self.dev()), train=self.train,
                       det_drop_seed=self.det_drop_seed)
        self._int8_notice()
        self._chains = self._find_chains(pipe)
        self._blocks: dict[str, dict] = {}
        # no block fusion in graphs with backward ops or in training (the
        # kernel has no backward; gradients flow through the unfused
        # lowerings), nor under tp (the block's convs are not split), as in
        # boda_tpu (executor.py:900-902)
        if self.fuse_block and self.fuse_relu and self.fuse_eltwise and \
                not pipe.bck_added and not self.train and self._tp() <= 1:
            self._detect_blocks(pipe)
        # bck graphs keep the per-forward fold: BN/Scale grads flow through it
        self._prefold_on = bool(self.prefold) and not pipe.bck_added
        self._prefold_plan = {}   # folded-w key -> (w_key, b_key, param_keys, fold)
        self._prefold_keys = {}   # conv op name -> (folded w key, folded b key)
        # input_s2d: net input node -> stem fold geometry (forward graphs only,
        # as boda_tpu's guard has it)
        self._input_s2d, self._input_s2d_ops = {}, set()
        if self.input_pad_c and not self.input_s2d:
            raise ConfigError("input_pad_c requires input_s2d=1 (the pad is "
                              "part of the host-folded entry layout)")
        if self.input_s2d and not pipe.bck_added:
            self._detect_input_s2d(pipe)
        unknown = sorted(set(self._quant) - set(pipe.nodes))
        if unknown:
            raise ConfigError(f"quantize: no node {unknown} in {pipe.name!r}")
        # act_int8: patterns -> per-node static scales now, so that a typo or a
        # missing calib entry fails at init; int8 convs fed a signed stored
        # value dequantize with its storage scale
        self._act_q = {}
        if self.act_int8:
            self._resolve_act_int8(pipe, amax)
            ctx = dataclasses.replace(ctx, act_store_scale={
                n: sc for n, (uns, sc) in self._act_q.items() if not uns})
        topo = pipe.topo_op_order()
        # each op's own lowering, then its chain's, in boda_tpu's order (the
        # info log's); the blocks after every op, since a block folds in the
        # weight preps of its convs B and C, which come after A
        for op_name in topo:
            op = pipe.ops[op_name]
            self._lowered[op_name] = self._lower(pipe, op, ctx, fused=False)
            if op_name in self._chains and op_name not in self._blocks:
                self._lowered_fused[op_name] = self._lower_chain(
                    pipe, op, self._chains[op_name], ctx)
        for op_name in self._blocks:
            self._lowered_fused[op_name] = self._lower_block(
                pipe, pipe.ops[op_name], self._blocks[op_name])
        self._upload_weights()

    def _int8_notice(self) -> None:
        """Engine-wide int8 without a sidecar quantizes with an amax reduce
        of every conv and fc input in every forward: say so at init."""
        if self.int8 and not self.calib_fn:
            print("conv_fwd: int8=1 without calib_fn uses DYNAMIC per-forward act "
                  "scales (a max|x| reduce of every conv and fc input per forward); "
                  "run net_calib and pass --calib-fn for the static-scale serving "
                  "config", file=sys.stderr)
            self._info_log.append("int8 dynamic (no calib_fn): expect a "
                                  "throughput REGRESSION vs bf16")

    def _detect_input_s2d(self, pipe: ConvPipe) -> None:
        """Find net inputs whose single consumer is a stem conv qualifying
        for the space-to-depth fold (stem_s2d_geom); those inputs may then
        arrive pre-folded from the host loader (boda_tpu: executor.py:939)."""
        for n in pipe.bots():
            consumers = list(pipe.nodes[n].bot_for)
            if len(consumers) != 1:
                continue
            op = pipe.ops[consumers[0]]
            if op.type != "Convolution" or op.bots[0] != n:
                continue
            geom = stem_s2d_geom(pipe.must_dims(n), pipe.must_dims(op.tops[0]),
                                 op.stride(), op.pad(), op.kern_sz(), op.dilation(),
                                 int(op.p("groups", 1)))
            if geom is None:
                continue
            c_fold = geom["sb"] ** 2 * geom["cin"]
            if self.input_pad_c and self.input_pad_c < c_fold:
                raise ConfigError(f"input_pad_c={self.input_pad_c} < folded channels "
                                  f"{c_fold} for input {n!r}")
            geom["c_eff"] = max(self.input_pad_c, c_fold)
            self._input_s2d[n] = geom
            self._input_s2d_ops.add(op.name)
            self._info_log.append(f"{op.name}: input_s2d on {n!r} -> "
                                  f"(*, {geom['xs_h']}, {geom['xs_w']}, {geom['c_eff']})")

    def host_input_s2d(self, node: str, x_nhwc: np.ndarray) -> np.ndarray:
        """Numpy fold of an NHWC batch into the pre-folded stem_s2d layout
        that the engine accepts for ``node`` under input_s2d=1, channels
        zero-padded to input_pad_c: what a data loader runs at decode time
        (boda_tpu: executor.py:970)."""
        geom = self._input_s2d.get(node)
        if geom is None:
            raise PipeError(f"input {node!r} has no input_s2d fold "
                            f"(have {sorted(self._input_s2d)})")
        xs = host_stem_s2d(x_nhwc, geom)
        return np.pad(xs, ((0, 0), (0, 0), (0, 0), (0, geom["c_eff"] - xs.shape[-1])))

    def _resolve_act_int8(self, pipe: ConvPipe, amax: Optional[dict]) -> None:
        """act_int8's patterns -> ``self._act_q``: node -> (unsigned, scale)
        (boda_tpu: executor.py:987-1048). Scales are static, from calib_fn's
        amax: uint8 (amax / 255) where the producer provably emits >= 0 (a
        ReLU, or a Pooling, Dropout or Concat of such), else int8 (amax /
        127); under engine-wide int8 always int8, so that an int8 conv can
        take the stored value as its operand."""
        import fnmatch
        if pipe.bck_added or self.train:
            raise ConfigError("act_int8 is inference-only (the storage "
                              "rounding has zero gradient)")
        if amax is None:
            raise ConfigError("act_int8 needs calib_fn (net_calib amax "
                              "sidecar) for the static scales")
        nodes = [n for n, node in pipe.nodes.items()
                 if node.dims is not None and n not in pipe.weights and node.top_for]
        nonneg: set[str] = set()
        changed = True
        while changed:  # the fixpoint over producers
            changed = False
            for n in nodes:
                if n in nonneg:
                    continue
                prod = pipe.ops[pipe.nodes[n].top_for[0]]
                if prod.type == "ReLU" or (
                        prod.type in ("Pooling", "Dropout", "Concat")
                        and all(b in nonneg for b in prod.bots)):
                    nonneg.add(n)
                    changed = True
        matched: set[str] = set()
        for pat in map(str, self.act_int8):
            hits = fnmatch.filter(nodes, pat)
            if not hits:
                raise ConfigError(f"act_int8 pattern {pat!r} matches no activation node")
            matched.update(hits)
        missing = sorted(n for n in matched if n not in amax)
        if missing:
            raise ConfigError(f"act_int8: calib file {self.calib_fn!r} has no amax for "
                              f"{missing} (re-run net_calib on this net)")
        for n in sorted(matched):
            a = max(float(amax[n]), 1e-12)
            uns = n in nonneg and not self.int8
            self._act_q[n] = (uns, a / (255.0 if uns else 127.0))
            self._info_log.append(
                f"act_int8 {n}: {'uint8' if uns else 'int8'} "
                f"scale={self._act_q[n][1]:.4g}"
                + (" (signed for direct int8-conv feed)" if n in nonneg and not uns else ""))

    def _find_chains(self, pipe: ConvPipe) -> dict[str, list[str]]:
        """Fusion chains conv/fc -> [BatchNorm] -> [Scale] -> [ReLU], each
        link single-consumer, extended by a residual tail
        conv[->BN][->Scale] -> Eltwise(sum, this + skip) [-> ReLU]."""
        chains: dict[str, list[str]] = {}
        if not self.fuse_relu:
            return chains
        topo = pipe.topo_op_order()
        topo_ix = {n: i for i, n in enumerate(topo)}

        def single_next(cur):
            consumers = pipe.nodes[cur.tops[0]].bot_for
            if len(consumers) != 1:
                return None
            return pipe.ops[consumers[0]]

        elt_claim: dict[str, str] = {}  # eltwise op -> claiming conv
        for op_name in topo:
            op = pipe.ops[op_name]
            if op.type not in ("Convolution", "InnerProduct"):
                continue
            chain = []
            cur = op
            for want in ("BatchNorm", "Scale", "ReLU"):
                nxt = single_next(cur)
                if nxt is None:
                    break
                if nxt.type != want:
                    if want == "ReLU":
                        break
                    continue
                if nxt.bots[0] != cur.tops[0]:
                    break
                chain.append(nxt.name)
                cur = nxt
            # residual tail: the skip value must already be computed at this
            # conv's topo slot; when both eltwise inputs end in fusable convs,
            # the later conv wins and the earlier one is un-claimed
            if self.fuse_eltwise and \
                    (not chain or pipe.ops[chain[-1]].type != "ReLU"):
                nxt = single_next(cur)
                if nxt is not None and nxt.type == "Eltwise" and \
                        nxt.p("eltwise_op", "sum") == "sum" and \
                        not nxt.p("coeffs", None) and \
                        len(nxt.bots) == 2 and nxt.bots[0] != nxt.bots[1] and \
                        cur.tops[0] in nxt.bots:
                    skip = next(b for b in nxt.bots if b != cur.tops[0])
                    prods = pipe.nodes[skip].top_for
                    if not prods or all(topo_ix[pr] < topo_ix[op_name]
                                        for pr in prods):
                        prev = elt_claim.get(nxt.name)
                        if prev is None or topo_ix[prev] < topo_ix[op_name]:
                            if prev is not None:  # un-claim the earlier conv
                                pc = chains.get(prev, [])
                                chains[prev] = pc[:pc.index(nxt.name)]
                                if not chains[prev]:
                                    del chains[prev]
                            elt_claim[nxt.name] = op_name
                            chain.append(nxt.name)
                            cur = nxt
                            nxt2 = single_next(cur)
                            if nxt2 is not None and nxt2.type == "ReLU" \
                                    and nxt2.bots[0] == cur.tops[0]:
                                chain.append(nxt2.name)
                                cur = nxt2
            if chain:
                chains[op_name] = chain
        return chains

    def _detect_blocks(self, pipe: ConvPipe) -> None:
        """Find residual bottlenecks (boda_tpu: ``_detect_blocks``,
        executor.py:1051-1119): convA(1x1 s1)+BN/Sc+ReLU -> convB(3x3 s1
        p1)+BN/Sc+ReLU -> convC(1x1 s1)+BN/Sc + Eltwise(skip=x) + ReLU, every
        link single-consumer. Each block becomes one mega-chain on convA;
        B's and C's own chains stay, so when a call asks for a value inside
        the block, the block runs unfused and B and C still fuse alone."""
        def pure_relu_chain(conv_name):
            ch = self._chains.get(conv_name)
            if not ch:
                return None
            ops = [pipe.ops[c] for c in ch]
            if ops[-1].type != "ReLU" or any(o.type == "Eltwise" for o in ops):
                return None
            return ch

        def is_conv(op, k, s, p):
            return (op is not None and op.type == "Convolution"
                    and len(op.bots) == 3 and op.kern_sz() == (k, k)
                    and op.stride() == (s, s) and op.pad() == (p, p)
                    and op.p("groups", 1) == 1 and op.dilation() == (1, 1))

        def sole_consumer(node):
            cons = pipe.nodes[node].bot_for
            return pipe.ops.get(cons[0]) if len(cons) == 1 else None

        for a_name in list(self._chains):
            opA = pipe.ops[a_name]
            chA = pure_relu_chain(a_name)
            if chA is None or not is_conv(opA, 1, 1, 0):
                continue
            tailA = pipe.ops[chA[-1]].tops[0]
            opB = sole_consumer(tailA)
            chB = pure_relu_chain(opB.name) if opB is not None else None
            if chB is None or not is_conv(opB, 3, 1, 1) or opB.bots[0] != tailA:
                continue
            tailB = pipe.ops[chB[-1]].tops[0]
            opC = sole_consumer(tailB)
            chC = self._chains.get(opC.name) if opC is not None else None
            if chC is None or not is_conv(opC, 1, 1, 0) or opC.bots[0] != tailB:
                continue
            copsC = [pipe.ops[c] for c in chC]
            elt = next((o for o in copsC if o.type == "Eltwise"), None)
            if elt is None or copsC[-1].type != "ReLU":
                continue
            x_node = opA.bots[0]
            if x_node not in elt.bots:
                continue
            k_mid = pipe.must_dims(opA.tops[0])["chan"]
            if pipe.must_dims(tailB)["chan"] != k_mid or \
                    not block_fuse_ok(pipe.must_dims(x_node), 3, k_mid, (1, 1),
                                      (1, 1), 1):
                continue
            self._blocks[a_name] = {"a_chain": chA, "b": opB.name, "b_chain": chB,
                                    "c": opC.name, "c_chain": chC}
            self._chains[a_name] = chA + [opB.name] + chB + [opC.name] + chC
            self._info_log.append(
                f"{a_name}: block-fused bottleneck (+{opB.name},{opC.name})")

    def _lower_block(self, pipe: ConvPipe, opA, block: dict) -> Callable:
        """One bottleneck kernel for a block (boda_tpu: ``_lower_block``,
        executor.py:1121-1162). BN/Scale of all three convs fold into their
        (w, b), at upload (prefold) or per call. Extras arrive in mega-chain
        order: A's folds, (wB, bB), B's folds, (wC, bC), C's folds, the
        eltwise skip (x itself, unused). Weights in another layout than the
        hand kernels' HWIO (the lib policy's OHWI) are turned to HWIO per
        call."""
        convs, n_folds = [], []
        for op, chain in ((opA, block["a_chain"]),
                          (pipe.ops[block["b"]], block["b_chain"]),
                          (pipe.ops[block["c"]], block["c_chain"])):
            fold, n, fkeys = self._make_fold(pipe, op, chain)
            if self._register_prefold(op, fold, fkeys):
                fold, n = None, 0
            prep = self._weight_preps[op.bots[1]]
            to_hwio = None if prep.layout == HWIO.layout else \
                (lambda w, prep=prep: HWIO.prep(prep.inv(w)))
            convs.append((fold, to_hwio))
            n_folds.append(n)

        def fn(x, wA, bA, *rest):
            rest = list(rest)
            wbs, w, b = [], wA, bA
            for i, (fold, to_hwio) in enumerate(convs):
                if i:
                    w, b = rest.pop(0), rest.pop(0)
                extras = [rest.pop(0) for _ in range(n_folds[i])]
                if fold is not None:
                    w, b = fold(w, b, extras)
                wbs.append((to_hwio(w) if to_hwio else w, b))
            (w1, b1), (w2, b2), (w3, b3) = wbs
            c, k = x.shape[-1], w1.shape[-1]
            return (bottleneck(x, w1.reshape(c, k), b1, w2, b2, w3.reshape(k, c), b3),)
        return fn

    def _make_fold(self, pipe: ConvPipe, conv_op, chain: list[str]):
        """BN/Scale weight folding for a conv's chain: returns
        (fold(w, b, extras) -> (w2, b2), n_extras, param_keys), extras being
        the BN/Scale parameters in chain order. A chain with neither BN nor
        Scale returns (None, 0, []). The fold runs on the cast (compute_tn)
        and prepped weights in f32 and casts back, in boda_tpu's order."""
        ops = [pipe.ops[c] for c in chain]
        bn = next((o for o in ops if o.type == "BatchNorm"), None)
        sc = next((o for o in ops if o.type == "Scale"), None)
        if bn is None and sc is None:
            return None, 0, []
        param_keys = (list(bn.bots[1:]) if bn is not None else []) + \
            (list(sc.bots[1:]) if sc is not None else [])
        eps = float(bn.p("eps", 1e-5)) if bn is not None else 0.0
        n_bn = (len(bn.bots) - 1) if bn is not None else 0
        n_sc = (len(sc.bots) - 1) if sc is not None else 0
        oc_axis = self._weight_preps[conv_op.bots[1]].oc_axis

        def fold(w, b, extras):
            i = 0
            scale_eff = torch.ones((), dtype=torch.float32, device=w.device)
            shift = torch.zeros((), dtype=torch.float32, device=w.device)
            if bn is not None:
                mean, var = extras[i], extras[i + 1]
                sf = extras[i + 2] if n_bn == 3 else None
                i += n_bn
                sfv = torch.where(sf[0] != 0, 1.0 / sf[0], torch.ones_like(sf[0])) \
                    if sf is not None else 1.0
                # in the parameters' dtype, then f32 (jnp promotion order)
                inv = torch.rsqrt(var * sfv + eps)
                scale_eff = scale_eff * inv.float()
                shift = shift - ((mean * sfv) * inv).float()
            if sc is not None:
                gamma = extras[i]
                beta = extras[i + 1] if n_sc == 2 else None
                i += n_sc
                scale_eff = scale_eff * gamma.float()
                shift = shift * gamma.float()
                if beta is not None:
                    shift = shift + beta.float()
            sh = [1] * w.dim()
            sh[oc_axis] = -1
            w2 = (w.float() * scale_eff.reshape(sh)).to(w.dtype)
            b2 = (b.float() * scale_eff + shift).to(b.dtype)
            return w2, b2
        return fold, n_bn + n_sc, param_keys

    def _register_prefold(self, conv_op, fold, param_keys) -> bool:
        """Queue this conv's fold for the one-shot upload-time computation.
        Returns True when the fold is prefolded (no per-forward fold)."""
        if not self._prefold_on or fold is None:
            return False
        w_key, b_key = conv_op.bots[1], conv_op.bots[2]
        wf, bf = w_key + "__folded", b_key + "__folded"
        self._prefold_plan.setdefault(wf, (w_key, b_key, param_keys, fold))
        self._prefold_keys[conv_op.name] = (wf, bf)
        return True

    def _lower_chain(self, pipe: ConvPipe, conv_op, chain: list[str],
                     ctx: LowerCtx) -> Callable:
        """Fused lowering for conv(+bias) -> [BN] -> [Scale] -> [Eltwise-sum]
        -> [ReLU]: one kernel with a bias(+residual)(+ReLU) store epilogue,
        on weights folded at upload (prefold) or per call."""
        ops = [pipe.ops[c] for c in chain]
        has_relu = any(o.type == "ReLU" for o in ops)
        elt = next((o for o in ops if o.type == "Eltwise"), None)
        fused_conv_fn = self._lower(pipe, conv_op, ctx, fused=has_relu)
        res_in_kernel = elt is not None and \
            getattr(fused_conv_fn, "supports_residual", False)
        if elt is not None and not res_in_kernel:
            fused_conv_fn = self._lower(pipe, conv_op, ctx, fused=False)
        fold, n_fold, fkeys = self._make_fold(pipe, conv_op, chain)
        if self._register_prefold(conv_op, fold, fkeys):
            fold, n_fold = None, 0  # w/b arrive already folded; no extras

        def fn(x, w, b, *rest):
            if fold is not None:
                w, b = fold(w, b, rest[:n_fold])
            if elt is None:
                return fused_conv_fn(x, w, b)
            res = rest[n_fold]
            if res_in_kernel:
                return fused_conv_fn(x, w, b, residual=res)
            out = fused_conv_fn(x, w, b)[0] + res
            return (torch.relu(out) if has_relu else out,)
        # the head conv takes x: an int8-stored x may feed it as it is
        fn.q8_input_ok = getattr(fused_conv_fn, "q8_input_ok", False)
        return fn

    def _lower(self, pipe: ConvPipe, op, ctx: LowerCtx, fused: bool) -> Callable:
        if op.type == "Bck":
            return self._lower_bck(pipe, op, ctx)
        if fused:
            op = dataclasses.replace(op, params=dict(op.params, fused_relu=True))
        r = lower_op_nhwc(pipe, op, ctx, self.op_tune(op.name), self._info_log)
        if r is None:
            raise PipeError(f"no NHWC lowering for op type {op.type!r} "
                            f"(op {op.name!r})")
        fn, preps = r
        self._weight_preps.update(preps)
        return fn

    def _lower_bck(self, pipe: ConvPipe, op, ctx: LowerCtx) -> Callable:
        """A Bck op (boda_tpu: executor.py:1287-1340): the hand backward
        kernels for an eligible conv, else the autograd of the forward op's
        library lowering, recomputed on detached inputs, with boda_tpu's
        cotangents: ones for the loss top, the incoming grad for the tops in
        ``top_has_grad``, zeros (no contribution) for the rest. The recompute
        takes the weights as uploaded for the forward and registers no prep:
        where the library lowering wants another layout (the lib conv's
        OHWI beside the hand conv's HWIO), it converts them inside the
        recompute, so their gradient comes out in the uploaded layout."""
        fwd = pipe.ops[op.p("fwd_op")]
        bck_fn = self._lower_bck_conv(pipe, op, fwd)
        if bck_fn is not None:
            return bck_fn
        # int8=False: the rounding has no gradient; a backward differentiates
        # the float math, as in boda_tpu
        lib_tune = dataclasses.replace(self.op_tune(fwd.name), use_xla=True, int8=False)
        r = lower_op_nhwc(pipe, fwd, ctx, lib_tune, self._info_log)
        if r is None:
            raise PipeError(f"no NHWC lowering for {fwd.type!r}")
        fwd_fn, lib_preps = r
        adapt = {}
        for pos, b in enumerate(fwd.bots):
            want, have = lib_preps.get(b), self._weight_preps.get(b)
            if (want and want.layout) != (have and have.layout):
                def conv_layout(w, want=want, have=have):
                    w = have.inv(w) if have else w
                    return want.prep(w) if want else w
                adapt[pos] = conv_layout
        n_fwd_bots = len(fwd.bots)
        grad_pos = [i for i, b in enumerate(fwd.bots) if _wants_grad(pipe, op, b)]
        top_has_grad = set(op.p("top_has_grad") or [])
        loss_node = op.p("loss_node")
        is_loss = fwd.type == "SoftmaxWithLoss"

        def fn(*args):
            full = list(args[:n_fwd_bots])
            gs = iter(args[n_fwd_bots:])
            with torch.enable_grad():
                prim = [full[p].detach().requires_grad_() for p in grad_pos]
                for p, t in zip(grad_pos, prim):
                    full[p] = t
                for p, f in adapt.items():
                    full[p] = f(full[p])
                ys, cts = [], []
                for t, out in zip(fwd.tops, fwd_fn(*full)):
                    if is_loss and t == loss_node:
                        ct = torch.ones_like(out)
                    elif t in top_has_grad:
                        ct = next(gs).to(out.dtype)
                    else:
                        continue
                    if out.requires_grad:
                        ys.append(out)
                        cts.append(ct)
                grads = torch.autograd.grad(ys, prim, cts, allow_unused=True) \
                    if ys else [None] * len(prim)
            return tuple((torch.zeros_like(p) if g is None else g).to(p.dtype)
                         for g, p in zip(grads, prim))
        return fn

    def _lower_bck_conv(self, pipe: ConvPipe, op, fwd) -> Optional[Callable]:
        """The hand backward kernels for a Bck conv (boda_tpu:
        ``_lower_bck_conv_pallas``, executor.py:1349-1398), same eligibility:
        unfused, gen (not use_xla), stride 1, dilation 1, groups 1, and a
        grad on the conv's output only. boda_tpu also needs its Mosaic block
        plan for the dgrad (``bck_in_blocks``); the Hopper conv has no such
        limit, so every eligible conv takes this path. dgrad = the conv
        kernel on the flipped, io-transposed HWIO weights; wgrad = K5's
        kernel over every tap; bias grad = a plain sum. Returns None to take
        the autograd path."""
        if fwd.type != "Convolution" or fwd.p("fused_relu", False):
            return None
        tune = self.op_tune(fwd.name)
        if tune.use_xla or fwd.stride() != (1, 1) or \
                fwd.dilation() != (1, 1) or int(fwd.p("groups", 1)) != 1:
            return None
        if op.p("top_has_grad") != [fwd.tops[0]]:
            return None
        if self._weight_preps[fwd.bots[1]].layout != HWIO.layout:
            raise PipeError(f"{op.name}: bck-conv needs the HWIO weights of "
                            f"the hand conv")
        grad_pos = [i for i, b in enumerate(fwd.bots) if _wants_grad(pipe, op, b)]
        pad = fwd.pad()
        n_fwd_bots = len(fwd.bots)
        self._info_log.append(f"{op.name}: bck-conv k={fwd.kern_sz()} p={pad} "
                              f"grads={[fwd.bots[i] for i in grad_pos]}")

        def fn(*args):
            x, w = args[0], args[1]  # NHWC activation, HWIO weights
            dy = args[n_fwd_bots].to(x.dtype).contiguous()
            outs = []
            for pos in grad_pos:
                if pos == 0:
                    outs.append(conv2d_bck_in(dy, w, pad=pad).to(x.dtype))
                elif pos == 1:
                    outs.append(conv2d_bck_filts(x.contiguous(), dy, pad=pad)
                                .to(w.dtype))
                else:
                    outs.append(dy.float().sum(dim=(0, 1, 2)).to(args[pos].dtype))
            return tuple(outs)
        return fn

    def build_raw_fn(self, out_names: list[str]) -> Callable:
        """fn(weights, inputs) -> {name: tensor}: inputs are logical-layout
        device tensors; outputs come back in logical NCHW and dtype."""
        pipe = self.pipe
        topo = pipe.topo_op_order()
        # per-call fusion decision: fuse a chain only when none of its
        # intermediate values are requested outputs or quantized nodes
        kept = set(out_names) | set(self._quant)
        fused_now = {}
        for conv_name, chain in self._chains.items():
            inter = [pipe.ops[conv_name].tops[0]] + \
                [pipe.ops[c].tops[0] for c in chain[:-1]]
            if not (set(inter) & kept):
                fused_now[conv_name] = chain
        skip_ops = {c for chain in fused_now.values() for c in chain}

        # extra inputs of a fused chain: every bot except the link value
        # (BN/Scale params, the eltwise skip); prefolded BN/Scale params are
        # upload-time constants and drop out
        def _extras(conv_name, chain):
            link, out = pipe.ops[conv_name].tops[0], []
            prefolded = conv_name in self._prefold_keys  # the fold owner's
            for cn in chain:
                cop = pipe.ops[cn]
                if cop.type == "Convolution":  # mid-chain conv of a block
                    prefolded = cn in self._prefold_keys
                    out += list(self._prefold_keys[cn]) if prefolded else \
                        [b for b in cop.bots if b != link]
                elif not (cop.type in ("BatchNorm", "Scale") and prefolded):
                    out += [b for b in cop.bots if b != link]
                link = cop.tops[0]
            return out
        chain_args = {c: _extras(c, chain) for c, chain in fused_now.items()}
        chain_final_top = {c: pipe.ops[chain[-1]].tops[0]
                           for c, chain in fused_now.items()}
        lowered = {o: (self._lowered_fused[o] if o in fused_now else self._lowered[o])
                   for o in topo}
        is4d = {n: self._is_4d(n) for n in pipe.nodes}
        # batch_split regions over the units that run (a fused chain is one)
        regions = resolve_batch_split(
            pipe, self._batch_split(), [o for o in topo if o not in skip_ops],
            lambda o: [chain_final_top[o]] if o in fused_now else list(pipe.ops[o].tops),
            lambda o: list(pipe.ops[o].bots) + chain_args.get(o, []))
        # weight gradients come out in the prepped layout: invert
        grad_inv = {n: prep.inv for n in out_names if not is4d.get(n)
                    for w, prep in self._weight_preps.items()
                    if n.startswith(w + "__grad")}
        cdt = torch_dtype(self.compute_tn) if self.compute_tn else None
        quant, stats = self._quant, bool(self.per_layer_stats)
        actq = self._act_q
        load_dt = cdt if cdt is not None else torch.float32

        # act_int8 storage (boda_tpu: executor.py:1580-1600): qstore
        # quantizes a node's value as it enters the store, qload dequantizes
        # it on every read; float values pass both, so a run fed a stored
        # node as a float input stays exact
        def qstore(n, v):
            q = actq.get(n)
            if q is None or not v.is_floating_point():
                return v
            uns, scale = q
            vq = torch.round(v.float() * (1.0 / scale))
            if uns:
                return torch.clamp(vq, 0.0, 255.0).to(torch.uint8)
            return torch.clamp(vq, -127.0, 127.0).to(torch.int8)

        def qload(n, v):
            q = actq.get(n)
            if q is None or v.is_floating_point():
                return v
            return (v.float() * q[1]).to(load_dt)

        def net_fn(weights: dict, inputs: dict):
            # a profiler range per op (net_trace's attribution), only while a
            # torch profiler records: outside a trace no range is entered
            ranges = torch.autograd.profiler._is_profiler_enabled
            tp, rec = weights.get("__tp__"), self._rec
            if rec is not None:
                rec.chains = dict(fused_now)
            self._q8_direct = set()
            vals = dict(weights)
            vals.update((k, self._ingest(k, v)) for k, v in inputs.items())
            stat_out = {}
            # prune to the subgraph reaching out_names from the given inputs
            needed = set(out_names)
            run_ops = set()
            for op_name in reversed(topo):
                if op_name in skip_ops:
                    continue
                op = pipe.ops[op_name]
                tops = ([chain_final_top[op_name]] if op_name in fused_now
                        else list(op.tops))
                if any(t in needed and t not in vals for t in tops):
                    run_ops.add(op_name)
                    needed.update(op.bots)
                    if op_name in fused_now:
                        needed.update(chain_args[op_name])

            def exec_one(op_name, look):
                op = pipe.ops[op_name]
                bots = op.bots
                pf = self._prefold_keys.get(op_name) if op_name in fused_now else None
                if pf is not None:  # head conv reads its upload-folded w/b
                    bots = [op.bots[0], pf[0], pf[1]] + list(op.bots[3:])
                if op_name in fused_now:
                    bots = list(bots) + chain_args[op_name]
                # an int8 conv with static scales takes a signed stored x as
                # its operand: neither a dequantize nor its own quantize runs
                q8ok = getattr(lowered[op_name], "q8_input_ok", False)
                try:
                    bot_vals = []
                    for i, b in enumerate(bots):
                        v = look(b)
                        if i == 0 and q8ok and v.dtype == torch.int8:
                            self._q8_direct.add(op_name)
                        else:
                            v = qload(b, v)
                        bot_vals.append(v)
                except KeyError as e:
                    raise PipeError(f"op {op_name!r}: missing input {e}") from None
                self._cur_op = op_name
                fn, args = lowered[op_name], bot_vals
                if tp is not None and op.type in ("Convolution", "InnerProduct") \
                        and bots[1] in tp.parts:
                    fn, args = functools.partial(tp_call, fn, devs=tp.devs), (
                        [tp.parts.get(b, v) for b, v in zip(bots, bot_vals)],)
                if rec is not None:
                    n_k, n_l = len(rec.kernels), len(rec.lib)
                if ranges:
                    with torch.profiler.record_function(op_name):
                        outs = fn(*args)
                else:
                    outs = fn(*args)
                tops = [chain_final_top[op_name]] if op_name in fused_now else op.tops
                if rec is not None:
                    rec.ops[op_name] = {
                        "in": [(b, kcommon.describe(v)) for b, v in zip(bots, bot_vals)],
                        "out": [(t, kcommon.describe(v)) for t, v in zip(tops, outs)],
                        "kernels": rec.kernels[n_k:], "lib": rec.lib[n_l:]}
                return list(zip(tops, outs))

            def store(t, v):
                if t in quant:
                    v = _quantize(v, *quant[t])
                if stats and v.is_floating_point():
                    v32 = v.float()
                    stat_out[t] = torch.stack([v32.min(), v32.max(), v32.sum(),
                                               (v32 * v32).sum()])
                return qstore(t, v)
            self._run_topo(topo, run_ops, regions, vals, out_names, exec_one, store, qstore)
            self._cur_op = None
            res = {}
            for n in out_names:
                v = qload(n, vals[n])
                if is4d.get(n) and v.dim() == 4:
                    v = v.permute(0, 3, 1, 2)
                elif n in grad_inv:
                    v = grad_inv[n](v)
                if cdt is not None:
                    v = v.to(torch_dtype(pipe.must_dims(n).tn))
                res[n] = v.contiguous()
            if stats:
                res["__stats__"] = stat_out
            return res

        return net_fn

    def _ingest(self, k: str, v: torch.Tensor) -> torch.Tensor:
        """An input as net_fn holds it: cast to the compute dtype; a 4-D
        node's logical NCHW turned NHWC, where an input already in NHWC (the
        natural decode layout) or, under input_s2d, in the stem's host-folded
        layout passes as it is (ambiguous shapes are taken as logical)."""
        if self.compute_tn and v.is_floating_point():
            v = v.to(torch_dtype(self.compute_tn))
        if not self._is_4d(k):
            return v
        ld = self.pipe.must_dims(k).shape
        nhwc = (ld[2], ld[3], ld[1])
        g = self._input_s2d.get(k)
        if g is not None and v.dim() == 4 and tuple(v.shape[1:3]) == (g["xs_h"], g["xs_w"]) \
                and v.shape[3] in (g["sb"] ** 2 * g["cin"], g["c_eff"]):
            return v  # the stem's lowering takes the host-folded input
        if tuple(v.shape[1:]) == ld[1:]:
            return v.permute(0, 2, 3, 1).contiguous()
        if tuple(v.shape[1:]) != nhwc:
            raise PipeError(
                f"input {k!r}: shape {tuple(v.shape)} is neither logical NCHW "
                f"(*, {ld[1]}, {ld[2]}, {ld[3]}) nor native NHWC "
                f"(*, {nhwc[0]}, {nhwc[1]}, {nhwc[2]})"
                + (f" nor the input_s2d fold (*, {g['xs_h']}, {g['xs_w']}, "
                   f"{g['c_eff']})" if g is not None else ""))
        return v


@register("conv_fwd", "xla", help="logical-layout (NCHW) engine on the library's ops: "
                                  "the oracle, sharing no rule with the NHWC engine")
class XlaFwd(FwdEngine):
    """boda_tpu's ``xla`` engine (executor.py:503), its default and the
    oracle of test_compute: every op by the logical-layout rules of
    graph/lowering.py and graph/ssd_ops.py (cuDNN/cuBLAS on the card, the
    conv and fc with an f32 accumulator), NCHW activations and OIHW
    filters as uploaded, no prefold, no fusion chain and no space-to-depth,
    so it shares none of the NHWC engine's rewrites. A ``Bck`` op is the
    autograd of its forward rule. Under a mesh, dp runs each img slice on
    its own device and tp splits every groups-1 conv's and fc's out_chan
    (boda_tpu's ``_weight_sharding``/``_input_sharding``, executor.py:93-109)."""

    def _plan_engine(self) -> str:
        return (f"mode=xla compute_tn={self.compute_tn or 'float32'} "
                f"cuda_graph={int(self._graphed())}"
                + (f" mesh={self._mesh}" if self._mesh is not None else ""))


@register("conv_fwd", "pallas", help="boda_tpu's generated-kernel engine: layout=nhwc is "
                                     "the cuda engine, layout=nchw the per-op K1/K3 route")
class PallasFwd(CudaFwd):
    """boda_tpu's ``pallas`` engine (executor.py:508) with its Fields and
    defaults: ``kernel_policy`` defaults to lib. ``layout=nhwc`` is the
    ``cuda`` engine, its code shared; ``layout=nchw`` runs the logical
    engine of the base class with each conv and fc routed by
    ops/cnn_variants.py (K1 for fc and 1x1 convs, K3 for stride-1 k x k
    convs, the logical rules for the rest), as boda_tpu's does: its fusion
    chains, blocks, prefold and input_s2d are the NHWC engine's, act_int8
    refuses it, and int8 is the same no-op that it is there (the NCHW
    route and the logical rules compute in the compute dtype; only the
    dynamic-scale notice prints). Each routing decision is logged once (boda_tpu
    logs a chain head's again for the fused lowering that its NCHW build
    never runs). ``batch_split`` runs its regions in k img chunks under
    either layout."""

    layout = Field(str, default="nhwc", help="internal layout: nhwc | nchw")
    kernel_policy = Field(str, default="lib",
                          help="conv/fc default: lib (cuDNN/cuBLAS; boda_tpu's default) | "
                               "gen (the hand CUDA kernels)")
    # net-level tune (boda_tpu: executor.py:608): the subgraph in_node ->
    # out_node runs as k img chunks, each a full pass of its ops; inference
    # ops are per-sample along img, so the split is exact
    batch_split = Field((list, str), default="()",
                        help="batch-split regions 'in_node:out_node:k'")

    def base_setup(self) -> None:
        if self.layout not in ("nhwc", "nchw"):
            raise ConfigError(f"layout {self.layout!r}: nhwc | nchw")
        super().base_setup()

    def _nchw(self) -> bool:
        return self.layout == "nchw"

    def _batch_split(self) -> tuple:
        return tuple(self.batch_split or ())

    def _check_mesh(self, out_names: list[str]) -> None:
        FwdEngine._check_mesh(self, out_names)
        # boda_tpu: executor.py:742-747
        if self._tp() > 1 and self.kernel_policy != "lib":
            raise PipeError("pallas engine shards dp only with generated kernels; use "
                            "kernel_policy=lib or mode=xla for tp")

    def _plan_engine(self) -> str:
        return f"mode=pallas layout={self.layout} " + super()._plan_engine()

    def init(self, pipe: ConvPipe) -> None:
        if not self._nchw():
            super().init(pipe)
            return
        self._int8_notice()
        if self.input_pad_c and not self.input_s2d:
            raise ConfigError("input_pad_c requires input_s2d=1 (the pad is "
                              "part of the host-folded entry layout)")
        if self.act_int8:
            raise ConfigError("act_int8 requires the NHWC engine layout")
        self._chains, self._blocks, self._lowered_fused = {}, {}, {}
        FwdEngine.init(self, pipe)

    def lower_one(self, pipe: ConvPipe, op, ctx: LowerCtx) -> Callable:
        """The NCHW route of one op: a conv or fc by ops/cnn_variants.py,
        whose filters are turned to the kernel's layout at upload; the
        logical rule for the rest, and for a ``Bck`` op, whose prepped
        filters are turned back to OIHW for its autograd and its filter
        gradient to the prepped layout."""
        from ..ops.cnn_variants import lower_op_pallas
        if op.type == "Bck":
            return self._nchw_bck(pipe, op, ctx)
        r = lower_op_pallas(pipe, op, ctx, self.op_tune(op.name), self._info_log)
        if r is None:
            return lower_op(pipe, op, ctx)
        fn, preps = r
        self._weight_preps.update(preps)
        return fn

    def _nchw_bck(self, pipe: ConvPipe, op, ctx: LowerCtx) -> Callable:
        fn = lower_op(pipe, op, ctx)
        fwd = pipe.ops[op.p("fwd_op")]
        preps = {i: self._weight_preps[b] for i, b in enumerate(fwd.bots)
                 if b in self._weight_preps}
        if not preps:
            return fn
        grad_pos = [i for i, b in enumerate(fwd.bots) if _wants_grad(pipe, op, b)]

        def bck(*args):
            args = [preps[i].inv(a) if i in preps else a for i, a in enumerate(args)]
            return tuple(preps[p].prep(g) if p in preps else g
                         for p, g in zip(grad_pos, fn(*args)))
        return bck

    def build_raw_fn(self, out_names: list[str]) -> Callable:
        if self._nchw():
            return FwdEngine.build_raw_fn(self, out_names)
        return super().build_raw_fn(out_names)

    def _ingest(self, k: str, v: torch.Tensor) -> torch.Tensor:
        if self._nchw():
            return FwdEngine._ingest(self, k, v)
        return super()._ingest(k, v)
