"""cnn_prof / cnn_op_info / net_decomp: per-op FLOPs, AI, runtime, %-peak.

Counterpart of ``boda_tpu/modes/cnn_prof.py``, with its modes, Fields and
output lines. The backends default to the card (``be=cuda``), where the rtc
``conv`` and ``sgemm`` ops run the hand kernels (K1, K2) unless a tune asks
for the library; %-peak is against the card's dense peak for the dtype each
op was timed in (``modes/rtc.py:_default_peak``). ``net_decomp`` times each
suffix subgraph with ``CudaFwd.time_fwd``, so it runs on the card only.
Parity target: ``cnn_op_info_t`` / ``cnn_prof_t`` (ref src/cnn-prof.cc:24,:132
+ pysrc/flops.py): per-op FLOPs, bytes, arithmetic intensity, and — when
``--time=1`` — measured runtime and %-of-peak on the current device, by
running each conv/fc op standalone through the rtc layer.
"""

from __future__ import annotations

import json

from .. import graph  # noqa: F401
from ..config import Field, Mode, register
from ..utils.dims import Dims
from .cnet import gen_data_inputs, load_net
from .rtc import _default_peak


@register("mode", "cnn_prof", help="per-op FLOPs/AI (+optional timed %-peak) table")
class CnnProf(Mode):
    model = Field(str, default="", help="zoo model name")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img = Field(int, default="1", help="batch size")
    in_sz = Field(int, default="0", help="input size override")
    time = Field(bool, default="0", help="run+time each matmul-shaped op on a backend")
    be = Field("be", default="(be=cuda)", help="backend for timing")
    peak_flops = Field(float, default="0", help="peak FLOP/s (0=auto per platform)")
    tune = Field("lexp", default="()", help="op_tune for generated kernels")
    json_out = Field(bool, default="0", help="emit one json line per op")

    def main(self) -> None:
        from ..ops.registry import Codegen
        pipe, in_dims = load_net(self.model, self.ptt_fn, "", self.img, self.in_sz)
        self._cg = Codegen(self.be)
        rows = []
        tot_fl = tot_secs = 0.0
        for op_name in pipe.topo_op_order():
            op = pipe.ops[op_name]
            if op.type not in ("Convolution", "InnerProduct"):
                continue
            fl = pipe.op_flops(op_name)
            byts = sum(pipe.must_dims(b).bytes_sz() for b in op.bots) + \
                sum(pipe.must_dims(t).bytes_sz() for t in op.tops)
            ai = fl / max(byts, 1)
            secs = None
            if self.time:
                secs = self._time_op(pipe, op)
                tot_secs += secs
            tot_fl += fl
            rows.append((op_name, op.type, fl, byts, ai, secs))
        tn = pipe.must_dims(pipe.ops[rows[0][0]].bots[0]).tn if rows else "float32"
        peak = self.peak_flops or _default_peak(
            self.be.get_plat_tag() if self.time else "", tn)
        for name, typ, fl, byts, ai, secs in rows:
            if self.json_out:
                rec = {"op": name, "type": typ, "flops": fl, "bytes": byts,
                       "AI": round(ai, 2)}
                if secs is not None:
                    rec["us"] = round(secs * 1e6, 1)
                    rec["GF/s"] = round(fl / secs / 1e9, 1)
                    if peak:
                        rec["pct_peak"] = round(100 * fl / secs / peak, 2)
                print(json.dumps(rec))
            else:
                line = f"{name:<28} {typ:<13} {fl / 1e6:10.1f}MF {ai:8.1f}AI"
                if secs is not None:
                    line += f" {secs * 1e6:9.1f}us {fl / secs / 1e9:8.1f}GF/s"
                    if peak:
                        line += f" {100 * fl / secs / peak:6.2f}%pk"
                print(line)
        line = f"total: {tot_fl / 1e9:.3f}GF over {len(rows)} matmul-ops"
        if self.time and tot_secs:
            line += (f", {tot_secs * 1e6:.0f}us, {tot_fl / tot_secs / 1e9:.1f}GF/s"
                     f" ({100 * tot_fl / tot_secs / max(peak, 1):.2f}% peak)")
        print(line)

    def _time_op(self, pipe, op) -> float:
        """Time one conv/fc op standalone through the rtc layer."""
        from ..ops.op_base import Op
        from ..ops.tune import OpTune
        from ..rtc.compute import Call
        tune = OpTune.from_lexp(self.tune)
        cg = self._cg
        ind = pipe.must_dims(op.bots[0])
        if op.type == "InnerProduct":
            fd = pipe.must_dims(op.bots[1])
            M, K, N = ind["img"], fd["in_feats"], fd["out_chan"]
            rop = Op("sgemm", {}, {"a": Dims.of(M=M, K=K),
                                   "b": Dims.of(K=K, N=N),
                                   "c": Dims.of(M=M, N=N)})
        else:
            od = pipe.must_dims(op.tops[0])
            fd = pipe.must_dims(op.bots[1])
            rop = Op("conv", {"stride": str(op.stride()[0]),
                              "pad": str(op.pad()[0])},
                     {"in": ind, "filts": fd, "out": od,
                      "biases": Dims.of(out_chan=fd["out_chan"])})
        fi = cg.gen_func(rop, tune)
        for pname in fi.in_names + fi.out_names:
            vn = f"{op.name}.{pname}"
            if not self.be.var_exists(vn):
                self.be.create_var_with_dims(vn, rop.dims(pname))
        cg.compile()
        arg_map = {p: f"{op.name}.{p}" for p, _ in fi.args}
        cg.run_func(fi, arg_map)
        return self.be.time_func(Call(fi.name, arg_map), n_iters=10)


def _sig_mkn(op) -> tuple[int, int, int, int, int]:
    """(M, K, N, flops, bytes) for a conv/sgemm op signature."""
    if op.type == "sgemm":
        a, b, c = op.dims("a"), op.dims("b"), op.dims("c")
        M, K, N = a["M"], a["K"], b["N"]
        byts = a.bytes_sz() + b.bytes_sz() + c.bytes_sz()
    else:
        ind, fd, od = op.dims("in"), op.dims("filts"), op.dims("out")
        M = od["img"] * od["y"] * od["x"]
        K = fd["in_chan"] * fd["y"] * fd["x"]
        N = fd["out_chan"]
        byts = ind.bytes_sz() + fd.bytes_sz() + od.bytes_sz()
        if "biases" in op.dims_vals:
            byts += op.dims("biases").bytes_sz()
    return M, K, N, 2 * M * K * N, byts


def _pp_si(v: float, unit: str) -> str:
    for scale, pre in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k"),
                       (1.0, ""), (1e-3, "m"), (1e-6, "u")):
        if abs(v) >= scale:
            return f"{v / scale:.3g}{pre}{unit}"
    return f"{v:.3g}{unit}"


@register("mode", "cnn_op_info",
          help="op-corpus info/efficiency tables (text/json/latex rows)")
class CnnOpInfo(Mode):
    """Corpus-driven op info + measured efficiency tables.

    Parity target: ``cnn_op_info_t`` (ref src/cnn-prof.cc:24 + the latex row
    emitters in src/latex-util.H:22): for each op signature in a corpus file,
    print kernel/stride/shape info, MxKxN, bytes, FLOPs, AI — and with
    ``--time=1`` the measured runtime, GF/s and %-of-peak on the backend,
    optionally against a comparison tune (speedup column, the
    generated-vs-library framing of doc/sgemm-notes.txt). ``--op-info-tab-fn``
    / ``--op-eff-tab-fn`` write latex table rows (paper-table output;
    ref op_info_tab_fn/op_eff_tab_fn)."""

    ops_fn = Field("filename", req=True, help="op-signature corpus (one lexp/line)")
    be = Field("be", default="(be=cuda)", help="backend for timing")
    time = Field(bool, default="0", help="run+time each op on the backend")
    tune = Field("lexp", default="()", help="op_tune for the primary variant")
    tune_comp = Field("lexp", default="",
                      help="comparison tune (adds runtime + speedup columns)")
    peak_flops = Field(float, default="0", help="peak FLOP/s (0=auto per platform)")
    n_iters = Field(int, default="10", help="timing iterations per op")
    mrd_toler = Field(float, default="2e-4", help="tune-vs-comp output tolerance")
    op_info_tab_fn = Field(str, default="", help="latex info rows output file")
    op_eff_tab_fn = Field(str, default="", help="latex eff rows output file")
    json_out = Field(bool, default="0", help="emit one json line per op")

    def main(self) -> None:
        from ..ops.op_base import load_op_sigs
        from ..ops.registry import Codegen
        from ..ops.tune import OpTune
        from ..prof.opsprof import profile_op
        ops = load_op_sigs(self.ops_fn)
        tunes = [OpTune.from_lexp(self.tune)]
        if str(self.tune_comp):
            tunes.append(OpTune.from_lexp(self.tune_comp))
        cg = Codegen(self.be) if self.time else None
        info_rows, eff_rows = [], []
        for op in ops:
            M, K, N, fl, byts = _sig_mkn(op)
            # the card's peak for the dtype this op is timed in
            peak = self.peak_flops or (_default_peak(
                self.be.get_plat_tag(), op.dims("a" if op.type == "sgemm" else "in").tn)
                if self.time else 0.0)
            ai = fl / max(byts, 1)
            rec = {"op": op.type, "MKN": [M, K, N], "flops": fl,
                   "bytes": byts, "AI": round(ai, 2)}
            desc = f"{M}x{K}x{N}"
            if op.type == "conv":
                ind, od = op.dims("in"), op.dims("out")
                ksz, st = op.dims("filts")["y"], op.ival("stride", 1)
                rec.update(ksz=ksz, stride=st, out_chan=N,
                           inp=f"{ind['img']}x{ind['y']}x{ind['x']}x{ind['chan']}")
                desc = f"k{ksz}s{st} {rec['inp']}->{N}"
                info_rows.append(
                    f"{ksz} & {st} & {N} & {ind['img']} & "
                    f"$ {ind['y']} \\dx {ind['x']} \\dx {ind['chan']} $ & "
                    f"$ {od['y']} \\dx {od['x']} \\dx {od['chan']} $ & "
                    f"$ {M} \\dx {K} \\dx {N} $ & {_pp_si(byts, 'B')} & "
                    f"{_pp_si(fl, 'F')} & {ai:.1f} \\\\")
            else:
                info_rows.append(
                    f"$ {M} \\dx {K} \\dx {N} $ & {_pp_si(byts, 'B')} & "
                    f"{_pp_si(fl, 'F')} & {ai:.1f} \\\\")
            secs = secs_comp = None
            if self.time:
                self.be.release_all_vars()
                wis = profile_op(self.be, cg, op, tunes, n_iters=self.n_iters,
                                 mrd_toler=self.mrd_toler,
                                 log=lambda *_a: None)
                byrun = {r.tune: r.secs for r in wis.runs}
                secs = byrun.get(tunes[0].key())
                if len(tunes) > 1:
                    secs_comp = byrun.get(tunes[1].key())
                if secs is not None:
                    rec["us"] = round(secs * 1e6, 1)
                    rec["GF/s"] = round(fl / secs / 1e9, 1)
                    if peak:
                        rec["pct_peak"] = round(100 * fl / secs / peak, 2)
                if secs_comp is not None:
                    rec["us_comp"] = round(secs_comp * 1e6, 1)
                    rec["speedup_vs_comp"] = round(secs_comp / secs, 2) \
                        if secs else None
                eff = []
                if op.type == "conv":
                    eff.append(f"{rec['ksz']} & {rec['stride']} & {N} & "
                               f"$ {rec['inp']} $ & \\verb|{tunes[0].key()}|")
                else:
                    eff.append(f"$ {M} \\dx {K} \\dx {N} $ & "
                               f"\\verb|{tunes[0].key()}|")
                if secs_comp is not None:
                    eff.append(f"{_pp_si(secs_comp, 's')} & "
                               f"{_pp_si(fl / secs_comp, 'F/s')}")
                if secs is not None:
                    eff.append(f"{_pp_si(secs, 's')} & {_pp_si(fl / secs, 'F/s')}"
                               + (f" & {100 * fl / secs / peak:.1f}\\%"
                                  if peak else ""))
                    if secs_comp is not None:
                        eff.append(f"{secs_comp / secs:.2f}x")
                eff_rows.append(" & ".join(eff) + " \\\\")
            if self.json_out:
                print(json.dumps(rec))
            else:
                line = (f"{desc:<36} {_pp_si(fl, 'F'):>8} {_pp_si(byts, 'B'):>8}"
                        f" {ai:8.1f}AI")
                if secs is not None:
                    line += f" {secs * 1e6:9.1f}us {fl / secs / 1e9:8.1f}GF/s"
                    if peak:
                        line += f" {100 * fl / secs / peak:6.2f}%pk"
                if secs_comp is not None and secs:
                    line += f" comp:{secs_comp * 1e6:.1f}us ({secs_comp / secs:.2f}x)"
                print(line)
        for fn, rows in ((self.op_info_tab_fn, info_rows),
                         (self.op_eff_tab_fn, eff_rows)):
            if fn:
                path = self.out_path(fn)
                with open(path, "w") as f:
                    f.write("\n".join(rows) + "\n")
                print(f"wrote {len(rows)} latex rows to {fn}")


@register("mode", "net_decomp",
          help="in-net stage timing via suffix-subgraph differences")
class NetDecomp(Mode):
    """In-net per-stage timing by suffix subgraphs.

    The reference dumps per-layer times from its replay loop
    (rtc_fwd.cc:560-572); standalone per-op re-timing (per_layer_times)
    leaves out what the ops share in the net. This mode times the FULL
    suffix subgraph from each cut node (the engine prunes ops whose outputs
    are given as inputs; each cut node is its own capture key) with the
    engine's own ``time_fwd``; consecutive differences are in-net stage
    costs, at cut-node granularity.
    """

    model = Field(str, default="", help="zoo model name")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img = Field(int, default="32", help="batch size")
    in_sz = Field(int, default="0", help="input size override")
    conv_fwd = Field("conv_fwd", default="(mode=cuda,compute_tn=bfloat16)",
                     help="forward engine")
    out_node = Field(str, default="", help="output node ('' = last)")
    cuts = Field((list, str), default="()",
                 help="cut node names ('()' = auto: spatial-stage boundaries)")
    n_iters = Field(int, default="24", help="timing iterations per program")
    chain = Field(int, default="8",
                  help="data-chained forwards per dispatch (boda_tpu's; on the "
                       "card each timed forward is one replay of the captured graph)")
    repeats = Field(int, default="3", help="best-of repeats per program")

    def _auto_cuts(self, pipe, in_name: str) -> list[str]:
        """Last node at each spatial resolution (stage boundaries)."""
        cuts, prev_y, prev_node = [], None, None
        for op_name in pipe.topo_op_order():
            for t in pipe.ops[op_name].tops:
                node = pipe.nodes.get(t)
                d = node.dims if node is not None else None
                if d is None or "y" not in d or "img" not in d:
                    continue
                y = d["y"]
                if prev_y is not None and y != prev_y and prev_node:
                    cuts.append(prev_node)
                prev_y, prev_node = y, t
        return [in_name] + cuts

    def main(self) -> None:
        pipe, in_dims = load_net(self.model, self.ptt_fn, "", self.img,
                                 self.in_sz)
        eng = self.conv_fwd
        eng.init(pipe)
        in_name = next(iter(in_dims))
        x = gen_data_inputs(in_dims)[in_name]
        out = self.out_node or pipe.ops[pipe.topo_op_order()[-1]].tops[0]
        cuts = list(self.cuts) or self._auto_cuts(pipe, in_name)
        acts = eng.run_fwd({in_name: x}, [c for c in cuts if c != in_name])
        times = {}
        for cut in cuts:
            ins = {in_name: x} if cut == in_name else {cut: acts[cut]}
            times[cut] = min(eng.time_fwd(ins, [out], n_iters=self.n_iters)
                             for _ in range(self.repeats))
        full = times[cuts[0]]
        print(f"net_decomp: full {full*1e6:.1f} us/fwd "
              f"({self.img/full:.1f} img/s), suffix times + stage diffs:")
        for i, cut in enumerate(cuts):
            stage = ""
            if i + 1 < len(cuts):
                dt = times[cut] - times[cuts[i + 1]]
                stage = (f"  stage ->{cuts[i+1]}: {dt*1e6:8.1f} us "
                         f"({100*dt/full:5.1f}%)")
            print(f"  from {cut:20s} {times[cut]*1e6:10.1f} us{stage}")
        tail = times[cuts[-1]]
        print(f"  tail after {cuts[-1]}: {tail*1e6:.1f} us "
              f"({100*tail/full:.1f}%)")
