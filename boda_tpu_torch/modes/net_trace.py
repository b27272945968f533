"""net_trace / train_trace: a torch.profiler trace and in-net per-op time.

Counterpart of ``boda_tpu/modes/net_trace.py``, with its modes, Fields and
output lines. boda_tpu traces its one jit program with ``jax.profiler`` and
maps each device instruction to a graph op through the ``jax.named_scope``
each engine op opens (an HLO instruction map). The port runs a net as a
sequence of launches, so it reads the same thing off a ``torch.profiler``
trace (CPU and CUDA activities), written with ``export_chrome_trace`` under
``--trace-dir``:

* the engine (``graph/executor.py``) and the training step
  (``parallel/train.py``) open a ``record_function`` range per op while a
  profiler records (and the step's ``__loss__`` and ``__update__``), and
  none otherwise;
* each CUDA kernel of the trace is joined, through its correlation id, to the
  runtime call on the host that launched it, and so to the innermost range
  open on that thread at the launch (failing a runtime event, through the
  kernel's external id to the op that launched it). A kernel outside every
  range goes to ``(other)``. The nested range names are joined by '/' and
  matched leftmost-longest against the net's op names (``_scope_of``), since
  Caffe names hold '/' (``inception_3a/3x3``);
* a backward kernel runs on autograd's thread, outside every forward range.
  Its backward node's event (``autograd::engine::evaluate_function``) carries
  the node's sequence number, which the forward op that made the node
  carries too: the kernel is tagged ``<op> [bwd]`` after the range that op
  ran in. Recomputation under remat runs inside the op ranges again and
  counts as forward, as in boda_tpu.

On the CPU (``device=cpu``) there are no kernels: the top-level ATen ops are
attributed the same way, by their start, and the time is host time.

A CUDA graph's replay shows no per-op ranges, so ``net_trace`` traces eager
forwards (``cuda_graph`` off for the traced window) and prints the replay's
ms per forward from ``time_fwd`` beside its table.
"""

from __future__ import annotations

import bisect
import glob
import json
import os

import numpy as np
import torch

from .. import graph  # noqa: F401
from ..config import ConfigError, Field, Mode, register
from ..utils.dims import NDA
from .cnet import gen_data_inputs, load_net

_BWD_NODE = "autograd::engine::evaluate_function: "
_TAGS = ("__loss__", "__update__")


def _scope_of(op_name_path: str, op_names=None) -> str:
    """The graph op a '/'-joined range path names: the leftmost-longest
    contiguous segment-join naming a real op (graph-op names may themselves
    contain '/': caffe-style 'inception_3a/3x3'), else the first segment
    (boda_tpu: net_trace.py:41)."""
    path = op_name_path.split("/")
    if len(path) > 1 and path[0].startswith("jit("):
        path = path[1:]
    if op_names:
        for i in range(len(path)):
            for k in range(len(path), i, -1):
                if "/".join(path[i:k]) in op_names:
                    return "/".join(path[i:k])
    return path[0]


def load_trace(fn: str) -> list[dict]:
    """The complete events ('X') of a chrome trace written by
    ``torch.profiler.profile.export_chrome_trace``."""
    with open(fn) as f:
        d = json.load(f)
    return [e for e in d.get("traceEvents", []) if e.get("ph") == "X"]


def _ns(v) -> int:
    return int(round(float(v) * 1000))


class _Resolver:
    """Per thread, the ranges (user annotations) and backward-node events
    open at a point, innermost last. The ranges of one thread nest, so the
    innermost one holding a point is the last one started before it or one
    of that one's parents."""

    def __init__(self, evs: list[dict]):
        self.by_tid: dict = {}
        for e in evs:
            if e.get("cat") == "user_annotation":
                kind, val = "r", e["name"]
            elif e.get("cat") == "cpu_op" and e["name"].startswith(_BWD_NODE) \
                    and "Sequence number" in e.get("args", {}):
                kind, val = "b", e["args"]["Sequence number"]
            else:
                continue
            t0 = _ns(e["ts"])
            self.by_tid.setdefault(e.get("tid"), []).append((t0, t0 + _ns(e["dur"]), kind, val))
        self.starts, self.parent = {}, {}
        for tid, cs in self.by_tid.items():
            cs.sort(key=lambda c: (c[0], -c[1]))
            par, open_ = [], []
            for i, c in enumerate(cs):
                while open_ and cs[open_[-1]][1] <= c[0]:
                    open_.pop()
                par.append(open_[-1] if open_ else -1)
                open_.append(i)
            self.starts[tid], self.parent[tid] = [c[0] for c in cs], par

    def stack(self, tid, t: int) -> list:
        """The containers open on ``tid`` at ``t``, outermost first."""
        cs = self.by_tid.get(tid)
        if not cs:
            return []
        i = bisect.bisect_right(self.starts[tid], t) - 1
        par = self.parent[tid]
        while i >= 0 and cs[i][1] < t:
            i = par[i]
        out = []
        while i >= 0:
            out.append(cs[i])
            i = par[i]
        return out[::-1]


def _units(evs: list[dict]) -> tuple[bool, list]:
    """(on_device, [(event, launch point (tid, t) or None)]): the CUDA kernels
    at their launches, or, in a trace without kernels, the top-level CPU ops
    at their starts."""
    kernels = [e for e in evs if e.get("cat") == "kernel"]
    if kernels:
        by_corr, by_ext = {}, {}
        for e in evs:
            a = e.get("args", {})
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in a:
                by_corr[a["correlation"]] = (e.get("tid"), _ns(e["ts"]))
            elif e.get("cat") in ("cpu_op", "user_annotation") and "External id" in a:
                by_ext[a["External id"]] = (e.get("tid"), _ns(e["ts"]))
        return True, [(k, by_corr.get(k.get("args", {}).get("correlation"))
                       or by_ext.get(k.get("args", {}).get("External id")))
                      for k in kernels]
    ops = sorted((e for e in evs if e.get("cat") == "cpu_op"),
                 key=lambda e: (e.get("tid"), _ns(e["ts"]), -_ns(e["dur"])))
    top, end = [], {}
    for e in ops:  # not inside an earlier op of its thread
        t0 = _ns(e["ts"])
        if t0 >= end.get(e.get("tid"), -1):
            top.append((e, (e.get("tid"), t0)))
            end[e.get("tid")] = t0 + _ns(e["dur"])
    return False, top


def attribute(evs: list[dict], op_names, train: bool = False,
              unmapped: dict | None = None) -> tuple[dict, int, bool]:
    """(per scope us, units attributed to a range, on_device) of a trace's
    events. Scopes are graph-op names, or under ``train`` '<op> [fwd]',
    '<op> [bwd]', '__loss__ [fwd|bwd]' and '__update__'; what no range
    holds is '(other)', its event names summed into ``unmapped``."""
    names = set(op_names) | (set(_TAGS) if train else set())
    res = _Resolver(evs)
    # each backward node's forward op: the latest forward event carrying its
    # sequence number (an op that makes no node records the next number)
    fwd_at = {}
    for e in evs:
        a = e.get("args", {})
        if e.get("cat") == "cpu_op" and "Sequence number" in a and \
                not a.get("Fwd thread id") and not e["name"].startswith(_BWD_NODE):
            p = (e.get("tid"), _ns(e["ts"]))
            if p[1] >= fwd_at.get(a["Sequence number"], (None, -1))[1]:
                fwd_at[a["Sequence number"]] = p

    def fwd_scope(point):
        """The op whose range holds ``point``, and the phase."""
        st = res.stack(*point)
        if not st:
            return None, ""
        if st[-1][2] == "b":
            fp = fwd_at.get(st[-1][3])
            scope = fwd_scope(fp)[0] if fp is not None and fp != point else None
            return scope, "bwd"
        path = []
        for c in reversed(st):
            if c[2] != "r":
                break
            path.append(c[3])
        return _scope_of("/".join(reversed(path)), names), "fwd"

    on_dev, units = _units(evs)
    per: dict[str, float] = {}
    n_mapped = 0
    for e, point in units:
        scope, phase = fwd_scope(point) if point is not None else (None, "")
        if scope is None:
            scope = "(other)"
            if unmapped is not None:
                unmapped[e["name"]] = unmapped.get(e["name"], 0.0) + float(e["dur"])
        else:
            n_mapped += 1
            if train and scope != "__update__":
                scope = f"{scope} [{phase}]"
        per[scope] = per.get(scope, 0.0) + float(e["dur"])
    return per, n_mapped, on_dev


def _profile(on_card: bool):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _write_trace(mode: Mode, prof, trace_dir: str, name: str) -> tuple[str, list[str]]:
    """Export the chrome trace under ``trace_dir``: (its path, the files
    there, relative to the output dir)."""
    td = mode.out_path(trace_dir)
    os.makedirs(td, exist_ok=True)
    fn = os.path.join(td, f"{name}.pt.trace.json")
    prof.export_chrome_trace(fn)
    files = [os.path.relpath(f, mode.boda_output_dir)
             for f in glob.glob(os.path.join(td, "**", "*"), recursive=True)
             if os.path.isfile(f)]
    return fn, files


def _print_unmapped(um: dict, top: int, n: int, per_what: str) -> None:
    if top and um:
        print(f"top unattributed event names ({len(um)} distinct, "
              f"{sum(um.values()):.0f}us):")
        for name, us in sorted(um.items(), key=lambda kv: -kv[1])[:top]:
            print(f"  {name:<40} {us / n:>10.1f} us/{per_what}")


@register("mode", "net_trace", help="dump a torch.profiler trace of net forwards")
class NetTrace(Mode):
    model = Field(str, default="", help="zoo model")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img = Field(int, default="4", help="batch size")
    in_sz = Field(int, default="0", help="input size override")
    conv_fwd = Field("conv_fwd", default="(mode=cuda,compute_tn=bfloat16)",
                     help="engine config")
    out_node = Field(str, default="prob", help="output node")
    n_iters = Field(int, default="4", help="traced forwards")
    trace_dir = Field(str, default="trace", help="trace output subdir")
    native = Field(bool, default="0",
                   help="feed native NHWC compute-dtype input (what the "
                        "production loader emits); engines with input_s2d=1 "
                        "additionally get the host-folded stem layout — "
                        "matches the flagship bench program")
    per_op = Field(bool, default="0",
                   help="print in-net per-op device time from the trace")
    top_k = Field(int, default="20", help="per-op table rows (0=all)")
    unmapped = Field(int, default="0",
                     help="also list top-N unattributed '(other)' event names")
    wisdom_fn = Field("filename", default="",
                      help="with --per-op: reconcile against this wisdom "
                           "file — print each op's best standalone wisdom "
                           "runtime (+ trust tier) next to its in-net time")

    def _wisdom_by_op(self, pipe, eng) -> dict:
        """graph-op name -> best wisdom run for that op's rtc signature,
        keyed by the engine's own ``wisdom_sig`` and preferring runs of this
        card's platform tag (``wisdom_plats``); OpWisdom.best prefers the ab
        trust tier."""
        from ..prof.wisdom import read_wisdom
        wis = {w.op.key(): w for w in read_wisdom(self.wisdom_fn)}
        _, plat = eng.wisdom_plats()
        out = {}
        for op_name in pipe.ops:
            sig = eng.wisdom_sig(op_name)
            if sig is None:
                continue
            w = wis.get(sig.key())
            if w is None:
                continue
            best = w.best(plat) or w.best()
            if best is not None:
                out[op_name] = best
        return out

    def _input(self, eng, in_dims) -> NDA:
        """The gen_data batch: logical NCHW, or under ``native`` NHWC in the
        compute dtype (held as f32 on the host for bf16), folded by
        ``host_input_s2d`` when the engine takes input_s2d."""
        from ..utils.dims import Dims, torch_dtype
        x = gen_data_inputs(in_dims)["data"]
        d = x.dims
        if not self.native:
            return x
        ctn = getattr(eng, "compute_tn", "") or d.tn
        xh = np.ascontiguousarray(x.data.transpose(0, 2, 3, 1))
        if ctn != d.tn:  # the compute dtype's values
            xh = torch.from_numpy(xh).to(torch_dtype(ctn)).float().numpy()
        if getattr(eng, "input_s2d", False):
            xh = eng.host_input_s2d("data", xh)
        nd = Dims.of(img=xh.shape[0], y=xh.shape[1], x=xh.shape[2], chan=xh.shape[3],
                     tn=ctn)
        return NDA(nd, xh)

    def main(self) -> None:
        if self.n_iters < 1:
            raise ConfigError("net_trace: n_iters must be >= 1")
        pipe, in_dims = load_net(self.model, self.ptt_fn, "", self.img, self.in_sz)
        eng = self.conv_fwd
        eng.init(pipe)
        on_card = eng.dev().type == "cuda"
        ins = {"data": self._input(eng, in_dims)}
        outs = [self.out_node]
        graphed = bool(eng.cuda_graph)
        replay = eng.time_fwd(ins, outs) if on_card else None
        eng.cuda_graph = False  # a replay shows no per-op ranges: trace eagerly
        try:
            # the kernels' builds, cuDNN's algorithm choice and the plan
            # caches happen outside the traced window
            eng.run_fwd(ins, outs)
            with _profile(on_card) as prof:
                for _ in range(self.n_iters):
                    eng.run_fwd(ins, outs)  # host arrays out: synced
        finally:
            eng.cuda_graph = graphed
        fn, files = _write_trace(self, prof, self.trace_dir, pipe.name)
        kinds = sorted({os.path.basename(f).split(".", 1)[-1] for f in files})
        how = (f"eager, cuda_graph off in the window (a replay shows no per-op "
               f"ranges); {'replay' if graphed else 'eager'} {replay * 1e3:.3f} ms/fwd "
               f"(time_fwd)" if on_card else "host time, no card")
        print(f"net_trace: {self.n_iters} forwards of {pipe.name} "
              f"({self.img} img) -> {len(files)} trace files under "
              f"{self.trace_dir}/ (kinds: {', '.join(kinds)}); {how}")
        if not self.per_op:
            return
        um: dict[str, float] = {}
        per, n_mapped, on_dev = attribute(load_trace(fn), pipe.ops,
                                          unmapped=um if self.unmapped else None)
        wmap = self._wisdom_by_op(pipe, eng) if self.wisdom_fn else {}
        tot = sum(per.values())
        rows = sorted(per.items(), key=lambda kv: -kv[1])
        if self.top_k:
            rows = rows[: self.top_k]
        print(f"per-op {'device' if on_dev else 'host'} time over {self.n_iters} "
              f"forwards ({n_mapped} mapped {'kernels' if on_dev else 'ops'}, "
              f"total {tot:.0f}us):")
        n_rec = 0
        for scope, us in rows:
            line = (f"  {scope:<28} {us / self.n_iters:>10.1f} us/fwd "
                    f"{100.0 * us / max(tot, 1e-9):>5.1f}%")
            if scope in wmap:
                b = wmap[scope]
                ratio = b.secs * 1e6 / max(us / self.n_iters, 1e-9)
                line += (f"  wis {b.secs * 1e6:>8.1f}us "
                         f"[{b.method or 'chain'}] x{ratio:.2f}")
                n_rec += 1
            print(line)
        if self.wisdom_fn:
            # wisdom times are the bare op (no fused epilogue, its own entry
            # layouts); in-net rows hold the fused epilogues: a large ratio
            # says the standalone number does not hold in the net
            print(f"wisdom reconciliation: {n_rec}/{len(rows)} rows matched "
                  f"{os.path.basename(self.wisdom_fn)} "
                  f"(x = standalone wisdom / in-net)")
        _print_unmapped(um, self.unmapped, self.n_iters, "fwd")


@register("mode", "train_trace",
          help="per-op fwd/bwd device-time attribution of a training step")
class TrainTrace(Mode):
    """The train-side counterpart of ``net_trace --per-op``: real
    consecutive training steps under a torch.profiler trace, device time per
    graph op AND per phase (fwd / bwd / loss / update). Defaults are
    boda_tpu's: ResNet-50 b32, momentum 0.9, train-mode BN 0.1. Prints the
    phase rollup with conv TF/s per phase (bwd convs carry 2x the forward's
    FLOPs: dgrad + wgrad), a per-type rollup (BatchNorm rows are the
    batch-statistics cost), and the top-K per-op table."""
    model = Field(str, default="resnet50", help="zoo model")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img = Field(int, default="32", help="batch size")
    lr = Field(float, default="0.01", help="SGD learning rate")
    clip_norm = Field(float, default="1.0", help="global-norm grad clip (0=off)")
    momentum = Field(float, default="0.9", help="SGD momentum (0=plain SGD)")
    bn_momentum = Field(float, default="0.1",
                        help="train-mode BN EMA rate (0=inference-stats BN)")
    weight_decay = Field(float, default="0.0", help="decoupled weight decay")
    master_f32 = Field(bool, default="0",
                       help="f32 master weights (compute in compute_tn)")
    remat = Field(str, default="", help="rematerialization: '' | seg | full | dots")
    compute_tn = Field(str, default="bfloat16",
                       help="weight/activation dtype ('' = f32)")
    n_iters = Field(int, default="4", help="traced steps")
    trace_dir = Field(str, default="trace", help="trace output subdir")
    top_k = Field(int, default="25", help="per-op table rows (0=all)")
    unmapped = Field(int, default="0",
                     help="also list top-N unattributed '(other)' event names")
    kernel_policy = Field(str, default="gen",
                          help="convs and fcs: gen (hand CUDA kernels) | lib (cuDNN/cuBLAS)")
    device = Field(str, default="cuda",
                   help="cuda (the card; raises without one) | cpu (host time)")

    def main(self) -> None:
        from ..ops.kernels.gen_data import gen_data_pattern
        from ..parallel.train import (find_logits_node, is_trainable, make_train_step,
                                      train_device)
        from ..utils.dims import torch_dtype
        if self.n_iters < 1:
            raise ConfigError("train_trace: n_iters must be >= 1")
        dev = train_device(self.device, "train_trace")
        pipe, in_dims = load_net(self.model, self.ptt_fn, "", self.img, 0)
        logits = find_logits_node(pipe)
        cdt = torch_dtype(self.compute_tn) if self.compute_tn else torch.float32
        step = make_train_step(
            pipe, logits, lr=self.lr, clip_norm=self.clip_norm,
            momentum=self.momentum, weight_decay=self.weight_decay,
            bn_momentum=self.bn_momentum,
            compute_dtype=cdt if self.master_f32 and self.compute_tn else None,
            remat=self.remat, kernel_policy=self.kernel_policy,
            cuda_graph=False)  # a replay shows no per-op ranges: trace eagerly
        d = in_dims["data"]
        wdt = torch.float32 if self.master_f32 else cdt
        weights = {k: torch.from_numpy(np.asarray(w.data, np.float32)).to(dev, wdt)
                   for k, w in pipe.weights.items()}
        x = gen_data_pattern(d.shape, d.tn).to(dev, cdt)
        n_cls = int(np.prod(pipe.nodes[logits].dims.shape)) // self.img
        labels = (torch.arange(self.img) % n_cls).to(dev)
        mom = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
               for k, v in weights.items() if is_trainable(k)} \
            if self.momentum > 0 else None

        def one(w, m):
            if m is None:
                loss, w = step(w, {"data": x}, labels)
                return loss, w, None
            return step(w, {"data": x}, labels, m)

        loss, weights, mom = one(weights, mom)  # warm-up, outside the window
        on_card = dev.type == "cuda"
        with _profile(on_card) as prof:
            for _ in range(self.n_iters):
                loss, weights, mom = one(weights, mom)
            # a host read inside the window: the last step's kernels have
            # finished before the profiler stops
            loss_f = float(loss)
        fn, _ = _write_trace(self, prof, self.trace_dir, f"{pipe.name}_train")
        um: dict[str, float] = {}
        per, n_mapped, on_dev = attribute(load_trace(fn), pipe.ops, train=True,
                                          unmapped=um if self.unmapped else None)
        n = self.n_iters
        tot = sum(per.values())
        # -- phase rollup with FLOP bases (bwd convs: dgrad + wgrad = 2x) --
        ctypes = ("Convolution", "InnerProduct")
        conv_fl = sum(pipe.op_flops(o) for o, op in pipe.ops.items() if op.type in ctypes)

        def phase_us(ph):
            return sum(us for s, us in per.items() if s.endswith(f"[{ph}]")) / n

        def conv_us(ph):
            return sum(us for s, us in per.items()
                       if s.endswith(f"[{ph}]") and s[: -len(f" [{ph}]")] in pipe.ops
                       and pipe.ops[s[: -len(f" [{ph}]")]].type in ctypes) / n
        what = "kernels" if on_dev else "ops, host time, no card"
        print(f"train-step phase rollup over {n} steps ({n_mapped} mapped {what}, "
              f"total {tot / n:.0f}us/step, loss {loss_f:.3f}; eager steps, no CUDA "
              f"graph: a replay shows no per-op ranges):")
        for ph, mult in (("fwd", 1.0), ("bwd", 2.0)):
            pus, cus = phase_us(ph), conv_us(ph)
            tfs = conv_fl * mult / (cus * 1e-6) / 1e12 if cus > 0 else 0.0
            print(f"  {ph:<11} {pus:>9.1f} us/step "
                  f"{100.0 * pus * n / max(tot, 1e-9):>5.1f}%   "
                  f"conv {cus:>8.1f} us  {tfs:>6.1f} TF/s "
                  f"({mult:.0f}x-fwd-FLOP basis)")
        upd_us = per.get("__update__", 0.0) / n
        print(f"  {'__update__':<11} {upd_us:>9.1f} us/step "
              f"{100.0 * upd_us * n / max(tot, 1e-9):>5.1f}%")
        oth = per.get("(other)", 0.0) / n
        if oth:
            print(f"  {'(other)':<11} {oth:>9.1f} us/step "
                  f"{100.0 * oth * n / max(tot, 1e-9):>5.1f}%")
        # -- per-type rollup (BatchNorm rows = batch-stats + normalize) --
        bytype: dict[str, float] = {}
        for s, us in per.items():
            base = s.rsplit(" [", 1)[0]
            t = pipe.ops[base].type if base in pipe.ops else base
            bytype[t] = bytype.get(t, 0.0) + us
        print("per-type device time:")
        for t, us in sorted(bytype.items(), key=lambda kv: -kv[1]):
            print(f"  {t:<24} {us / n:>10.1f} us/step "
                  f"{100.0 * us / max(tot, 1e-9):>5.1f}%")
        # -- per-op table: fwd + bwd side by side --
        ops_fb: dict[str, list[float]] = {}
        for s, us in per.items():
            if s.endswith(" [fwd]") or s.endswith(" [bwd]"):
                base, ph = s.rsplit(" [", 1)
                ops_fb.setdefault(base, [0.0, 0.0])[0 if ph.startswith("fwd") else 1] += us
        rows = sorted(ops_fb.items(), key=lambda kv: -sum(kv[1]))
        if self.top_k:
            rows = rows[: self.top_k]
        print("per-op fwd/bwd (us/step):")
        for base, (fus, bus) in rows:
            rat = bus / fus if fus > 0 else float("inf")
            print(f"  {base:<28} fwd {fus / n:>9.1f}  bwd {bus / n:>9.1f}"
                  f"  bwd/fwd {rat:>5.2f}")
        _print_unmapped(um, self.unmapped, n, "step")
