"""rtc-layer modes: backend smoke test + sgemm runner.

Counterpart of ``boda_tpu/modes/rtc.py``. Parity targets: ``rtc_test`` (ref
src/rtc_compute.cc:135 — compile+run a raw dot-product kernel on a real
backend) and the sgemm profiling flow (ref doc/sgemm-notes.txt). Both
default to the card (``be=cuda``); ``--be=(be=cuda,device=cpu)`` runs the
kernels' plain versions and ``--be=(be=interp)`` the oracle.
"""

from __future__ import annotations

import json
import sys

from .. import rtc  # noqa: F401  (registers the "be" backends)
from ..config import Field, Mode, register
from ..ops.op_base import Op
from ..ops.registry import Codegen
from ..ops.tune import OpTune
from ..utils.digest import comp_vars
from ..utils.dims import Dims


@register("mode", "rtc_test", help="compute-backend smoke test: eltwise-mul kernel")
class RtcTest(Mode):
    be = Field("be", default="(be=cuda)", help="backend to test")
    n = Field(int, default="10000", help="vector length")

    def main(self) -> None:
        cg = Codegen(self.be)
        d = Dims.of(n=self.n)
        gen = cg.gen_func(Op("gen_data", {"mod": "7", "stride": "3"}, {"out": d}))
        gen2 = cg.gen_func(Op("gen_data", {"mod": "11", "stride": "5"}, {"out": d}))
        dot = cg.gen_func(Op("eltwise", {"func": "mul"}, {"a": d, "b": d, "out": d}))
        for vn in ("a", "b", "c"):
            self.be.create_var_with_dims(vn, d)
        cg.compile()
        cg.run_func(gen, {"out": "a"})
        cg.run_func(gen2, {"out": "b"})
        cg.run_func(dot, {"a": "a", "b": "b", "out": "c"})
        self.be.finish_and_sync()
        a = self.be.copy_var_to_nda("a").data
        b = self.be.copy_var_to_nda("b").data
        c = self.be.copy_var_to_nda("c").data
        r = comp_vars(a * b, c, mrd_toler=1e-6)
        ok = r.ok()
        print(f"rtc_test be={self.be.get_plat_tag()} n={self.n}: "
              f"{'PASS' if ok else 'FAIL'} ({r})")
        if not ok:
            sys.exit(1)


@register("mode", "sgemm_run", help="run one sgemm op on a backend; check + time it")
class SgemmRun(Mode):
    be = Field("be", default="(be=cuda)", help="backend")
    M = Field(int, default="1536", help="rows of a/c")
    K = Field(int, default="1536", help="contraction dim")
    N = Field(int, default="1536", help="cols of b/c")
    tn = Field(str, default="float32", help="dtype")
    tune = Field("lexp", default="()", help="op_tune lexp, e.g. (bm=512,bk=1024)")
    n_iters = Field(int, default="10", help="timing iterations")
    check = Field(bool, default="1", help="verify vs a host f32 matmul")
    peak_flops = Field(float, default="0", help="device peak FLOP/s (0: the card's "
                                                "published dense peak)")

    def main(self) -> None:
        import numpy as np
        tune = OpTune.from_lexp(self.tune)
        cg = Codegen(self.be)
        ad = Dims.of(M=self.M, K=self.K, tn=self.tn)
        bd = Dims.of(K=self.K, N=self.N, tn=self.tn)
        cd = Dims.of(M=self.M, N=self.N, tn=self.tn)
        op = Op("sgemm", {}, {"a": ad, "b": bd, "c": cd})
        fi = cg.gen_func(op, tune)
        ga = cg.gen_func(Op("gen_data", {"mod": "13"}, {"out": ad}))
        gb = cg.gen_func(Op("gen_data", {"mod": "17", "stride": "11"}, {"out": bd}))
        for vn, dd in (("a", ad), ("b", bd), ("c", cd)):
            self.be.create_var_with_dims(vn, dd)
        cg.compile()
        cg.run_func(ga, {"out": "a"})
        cg.run_func(gb, {"out": "b"})
        call_args = {"a": "a", "b": "b", "c": "c"}
        cg.run_func(fi, call_args)
        self.be.finish_and_sync()
        if self.check:
            a = self.be.copy_var_to_nda("a").data.astype(np.float32)
            b = self.be.copy_var_to_nda("b").data.astype(np.float32)
            c = self.be.copy_var_to_nda("c").data.astype(np.float32)
            ref = a @ b
            r = comp_vars(ref, c, mrd_toler=1e-5,
                          atol=1e-5 * float(np.abs(ref).max()))
            print(f"check: {'PASS' if r.ok() else 'FAIL'} ({r})")
            if not r.ok():
                sys.exit(1)
        from ..rtc.compute import Call
        secs = self.be.time_func(Call(fi.name, call_args), n_iters=self.n_iters)
        gflops = fi.flops / secs / 1e9
        peak = self.peak_flops or _default_peak(self.be.get_plat_tag(), self.tn)
        frac = fi.flops / secs / peak if peak else 0.0
        print(json.dumps({
            "op": op.key(), "tune": tune.key(), "variant": fi.info,
            "secs": secs, "GF/s": round(gflops, 2),
            "pct_peak": round(100 * frac, 2), "plat": self.be.get_plat_tag(),
        }))


def _default_peak(plat_tag: str, tn: str) -> float:
    """Per-card dense peak FLOP/s for %-of-peak reporting (NVIDIA's data sheet;
    0 where unknown, and on the CPU)."""
    if "H100" in plat_tag:
        # H100 SXM: 989 TFLOP/s bf16 on the tensor cores; f32 on the FMA pipes
        # (the path K1 takes in f32) 67 TFLOP/s
        return 989e12 if tn in ("bfloat16", "float16") else 67e12
    return 0.0
