"""ops-prof: per-op cross-backend/tune profiling + correctness + wisdom emit.

Counterpart of ``boda_tpu/prof/opsprof.py``. Parity target: ``ops_prof_t``
(ref src/rtc_prof.cc:139,:194 and the flow in SURVEY.md section 3.4): for
each op signature in a corpus, for each tune (the first is the known-good
anchor), generate inputs *on device* (gen_data), run, time, compare full
tensors against the kg tune and digests against stored wisdom, and append
runs to a wisdom stream.
"""

from __future__ import annotations

import numpy as np

from ..ops.op_base import Op
from ..ops.registry import Codegen
from ..ops.tune import OpTune
from ..rtc.compute import Backend, Call
from ..utils.digest import NdaDigest, comp_vars
from .wisdom import OpRun, OpWisdom

# per-op-type input/output arg roles (which dims args are inputs to generate)
_GEN_SEEDS = {"mod": (13, 17, 19, 23), "stride": (7, 11, 5, 3)}


def _raw_of(fi):
    """Adapt a FuncInfo to the (weights, inputs)->outs raw-fn shape
    prof/abtime.ab_compare expects (weights unused — kernels take all args
    positionally)."""
    names = list(fi.in_names)

    def raw(weights, xins):
        outs = fi.fn(*[xins[n] for n in names])
        return outs if isinstance(outs, tuple) else (outs,)
    return raw


def profile_op(be: Backend, cg: Codegen, op: Op, tunes: list[OpTune],
               n_iters: int = 10, mrd_toler: float = 2e-4,
               kg_wisdom: OpWisdom | None = None,
               method: str = "ab",
               log=print) -> OpWisdom:
    """Profile one op over a list of tunes on one backend; first tune is kg.

    method='ab' (default): every candidate is timed in turns with the kg
    incumbent (prof/abtime.ab_compare); the kg run records the median of
    its paired readings. method='chain' times each tune alone
    (the backend's time_func). Records are tagged so wis_ana and merges can
    tell the tiers apart (ref op-tuner.cc:68-204 records comparable
    candidate-vs-incumbent runs the same way). Known-good digests of a bf16
    output are made as boda_tpu makes them (its dims name bfloat16, its
    sha256 covers the 2-byte values), so the two packages' wisdom merges."""
    wis = OpWisdom(op.copy())
    fis = [cg.gen_func(op, t) for t in tunes]
    in_names = fis[0].in_names
    out_names = fis[0].out_names

    # on-device deterministic input generation (ref gen_data_*.cucl flow)
    gen_fis = []
    for i, pname in enumerate(in_names):
        d = op.dims(pname)
        gop = Op("gen_data", {"mod": str(_GEN_SEEDS["mod"][i % 4]),
                              "stride": str(_GEN_SEEDS["stride"][i % 4])},
                 {"out": d})
        gen_fis.append(cg.gen_func(gop))
        if not be.var_exists(pname):
            be.create_var_with_dims(pname, d)
    for pname in out_names:
        if not be.var_exists(pname):
            be.create_var_with_dims(pname, op.dims(pname))
    cg.compile()
    for gfi, pname in zip(gen_fis, in_names):
        cg.run_func(gfi, {"out": pname})

    arg_map = {p: p for p, _ in fis[0].args}
    kg_out: dict[str, np.ndarray] = {}
    passed: list[tuple[OpTune, object]] = []  # correctness-ok (tune, fi)
    for t, fi in zip(tunes, fis):
        cg.run_func(fi, arg_map)
        be.finish_and_sync()
        outs = {n: be.copy_var_to_nda(n).data for n in out_names}
        ok = True
        for n, arr in outs.items():
            tn = op.dims(n).tn
            if n in kg_out:
                r = comp_vars(kg_out[n], arr, mrd_toler=mrd_toler,
                              atol=1e-4 * max(1e-30, float(np.abs(kg_out[n]).max())))
                if not r.ok():
                    ok = False
                    log(f"FAIL {op.type} tune={t.key()} out={n}: {r}")
            if kg_wisdom is not None and n in kg_wisdom.kg_digests:
                d = NdaDigest.make(arr, tn=tn)
                mrd = kg_wisdom.kg_digests[n].mrd_comp(d)
                if mrd > mrd_toler:
                    ok = False
                    log(f"FAIL {op.type} tune={t.key()} out={n}: "
                        f"digest mrd {mrd:.3g} vs stored known-good")
        if not kg_out:
            kg_out = outs
            for n, arr in outs.items():
                wis.kg_digests[n] = NdaDigest.make(arr, tn=op.dims(n).tn)
        if not ok:
            continue
        passed.append((t, fi))
    plat = be.get_plat_tag()
    # the ab path calls fi.fn locally and reads local var buffers; remote
    # (ipc) backends register stubs with fn=None and (dims, None) vars, so
    # it falls back to the proxied time_func (chain tier) there
    use_ab = method == "ab" and len(passed) >= 2 and in_names and \
        passed[0][1] is fis[0] and all(fi.fn is not None for _, fi in passed)
    if use_ab:
        from .abtime import ab_compare
        ins = {p: be.get_var_raw(p) for p in in_names}
        kg_t, kg_fi = passed[0]
        kg_reads = []
        for t, fi in passed[1:]:
            ta, tb = ab_compare(_raw_of(kg_fi), _raw_of(fi), {}, ins,
                                n_legs=max(4, n_iters // 2))
            kg_reads.append(ta)
            wis.runs.append(OpRun(t.key(), plat, tb, "ab"))
            gfs = fi.flops / tb / 1e9 if tb > 0 else 0.0
            log(f"ran {op.type} tune={t.key()} [{fi.info}]: {tb * 1e6:.1f}us "
                f"{gfs:.1f}GF/s ({ta / tb:.3f}x vs kg, paired A/B)")
        kg_secs = float(np.median(kg_reads))
        wis.runs.insert(0, OpRun(kg_t.key(), plat, kg_secs, "ab"))
        gfs = kg_fi.flops / kg_secs / 1e9 if kg_secs > 0 else 0.0
        log(f"ran {op.type} tune={kg_t.key()} [{kg_fi.info}]: "
            f"{kg_secs * 1e6:.1f}us {gfs:.1f}GF/s (kg, median of "
            f"{len(kg_reads)} paired reads)")
        return wis
    for t, fi in passed:
        secs = be.time_func(Call(fi.name, arg_map), n_iters=n_iters)
        wis.runs.append(OpRun(t.key(), plat, secs, "chain"))
        gfs = fi.flops / secs / 1e9 if secs > 0 else 0.0
        log(f"ran {op.type} tune={t.key()} [{fi.info}]: {secs * 1e6:.1f}us "
            f"{gfs:.1f}GF/s")
    return wis
