"""Profiling/autotuning modes: ops_prof, gen_prof_ops, wis_merge, wis_ana.

Counterpart of ``boda_tpu/modes/prof.py``. Parity targets: ``ops-prof`` (ref
src/rtc_prof.cc:194), ``wis-merge`` (ref src/op-tuner.cc:161), ``wis-ana``
(ref src/op-tuner.cc:204). ``gen_prof_ops`` takes zoo models (``--model``);
the prototxt frontend (boda_tpu's ``--ptt-fn``) is not ported yet.
"""

from __future__ import annotations

import os

from .. import rtc  # noqa: F401  (registers the "be" backends)
from ..config import ConfigError, Field, Mode, register
from ..ops.op_base import load_op_sigs
from ..ops.registry import Codegen
from ..ops.tune import OpTune
from ..prof.opsprof import profile_op
from ..prof.wisdom import merge_wisdom, read_wisdom, write_wisdom


@register("mode", "ops_prof", help="profile ops from a corpus over tunes; emit wisdom")
class OpsProf(Mode):
    be = Field("be", default="(be=cuda)", help="backend to profile on")
    ops_fn = Field("filename", req=True, help="op-signature corpus (one lexp/line)")
    op_tunes = Field((dict, "lexp"), default="(kg=())",
                     help="named tunes; first entry is the known-good anchor")
    wisdom_in_fn = Field("filename", default="", help="input wisdom (digest anchors)")
    wisdom_out_fn = Field("filename", default="%(boda_output_dir)/wisdom.wis",
                          help="output wisdom stream")
    n_iters = Field(int, default="10", help="timing iterations per tune")
    mrd_toler = Field(float, default="2e-4", help="cross-tune output tolerance")
    # timing tier (see prof/opsprof.profile_op): 'ab' times every candidate
    # in turns with the kg incumbent (the default), 'chain' times each tune
    # alone. Records carry the tag either way.
    method = Field(str, default="ab", help="timing method: ab | chain")

    def main(self) -> None:
        import dataclasses
        if self.method not in ("ab", "chain"):
            raise ConfigError(f"ops_prof: unknown method {self.method!r} "
                              f"(expected 'ab' or 'chain')")
        ops = load_op_sigs(self.ops_fn)
        tunes = [OpTune.from_lexp(v) for v in self.op_tunes.values()]
        # which tunes left precision to the default (vs chose it explicitly)
        prec_default = ["precision" not in str(v)
                        for v in self.op_tunes.values()]
        if not tunes:
            raise ConfigError("ops_prof: op_tunes must not be empty")
        kg_map = {}
        if self.wisdom_in_fn:
            kg_map = {w.op.key(): w for w in read_wisdom(self.wisdom_in_fn)}
        out = []
        fn = self.out_path(os.path.basename(self.wisdom_out_fn)) \
            if os.path.dirname(self.wisdom_out_fn) in ("", ".") else self.wisdom_out_fn
        cg = Codegen(self.be)  # one codegen: unique func naming across ops
        for op in ops:
            self.be.release_all_vars()
            # bf16 corpus: follow the engine's rule (executor.op_tune) — bf16
            # compute defaults to precision 'default' unless the tune names a
            # precision itself, so the wisdom keys match the engine's tunes
            op_tunes = tunes
            if any(d.tn == "bfloat16" for d in op.dims_vals.values()):
                op_tunes = [dataclasses.replace(t, precision="default")
                            if dflt else t
                            for t, dflt in zip(tunes, prec_default)]
            w = profile_op(self.be, cg, op, op_tunes,
                           n_iters=self.n_iters, mrd_toler=self.mrd_toler,
                           kg_wisdom=kg_map.get(op.key()),
                           method=self.method)
            out.append(w)
            # incremental write: a killed/timed-out run keeps its finished ops
            write_wisdom(fn, out)
        write_wisdom(fn, out)
        print(f"wrote wisdom for {len(out)} ops to {os.path.basename(fn)}")


@register("mode", "gen_prof_ops", help="emit a net's conv/fc op-signature corpus")
class GenProfOps(Mode):
    """Corpus generator (ref pysrc/to-prof-ops-gen.py + write_sigs flow,
    rtc_fwd.cc:246): every unique matmul-shaped op signature in a net."""
    model = Field(str, default="", help="zoo model name")
    img = Field(int, default="1", help="batch size")
    tn = Field(str, default="", help="override signature dtype (e.g. bfloat16)")
    out_fn = Field(str, default="prof-ops.txt", help="output corpus file")

    def main(self) -> None:
        from ..ops.op_base import save_op_sigs
        from ..ops.sig_of import collect_net_sigs
        from .cnet import load_net
        pipe, _ = load_net(self.model, self.img)
        sigs = collect_net_sigs(pipe)
        if self.tn:
            for s in sigs:
                s.dims_vals = {k: d.with_tn(self.tn)
                               for k, d in s.dims_vals.items()}
        fn = self.out_path(self.out_fn)
        save_op_sigs(fn, sigs)
        print(f"gen_prof_ops: {len(sigs)} unique op sigs from {pipe.name} -> {self.out_fn}")


@register("mode", "wis_merge", help="merge wisdom files (union runs, check digests)")
class WisMerge(Mode):
    srcs = Field((list, "filename"), req=True, help="input wisdom files")
    out_fn = Field("filename", req=True, help="merged output file")

    def main(self) -> None:
        merged = merge_wisdom([read_wisdom(fn) for fn in self.srcs])
        write_wisdom(self.out_fn, merged)
        print(f"merged {len(self.srcs)} files -> {len(merged)} ops in {self.out_fn}")


@register("mode", "wis_ana", help="analyze wisdom: best tune per op per platform")
class WisAna(Mode):
    wisdom_fn = Field("filename", req=True, help="wisdom file to analyze")
    peak_flops = Field(float, default="0", help="peak FLOP/s for %-peak column")

    def main(self) -> None:
        wis = read_wisdom(self.wisdom_fn)
        n_ab = n_chain = 0
        for w in wis:
            plats = sorted({r.plat for r in w.runs})
            print(f"op {w.op.key()}")
            for p in plats:
                b = w.best(p)
                # trust tier (OpRun.method): [ab] = paired A/B vs the
                # incumbent; [chain] = standalone timing
                tier = b.method or "chain"
                print(f"  {p}: best {b.secs * 1e6:.1f}us [{tier}] tune={b.tune}")
            for r in w.runs:
                if r.method == "ab":
                    n_ab += 1
                else:
                    n_chain += 1
        print(f"{len(wis)} ops analyzed "
              f"({n_ab} ab-tier runs, {n_chain} chain/legacy-tier)")
