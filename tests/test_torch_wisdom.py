"""The port's wisdom store, ops_prof and the engine's wisdom_fn against
boda_tpu's, on the CPU.

A wisdom file written by either package reads in the other and merges
with the other's (the known-good digests of one signature must agree
within merge_wisdom's 1e-4). ops_prof runs on ``be=cuda,device=cpu`` (the
kernels' plain versions) over a 3-signature mini_resnet corpus; the engine
runs on ``device=cpu``.
"""

import io
from contextlib import redirect_stdout

import ml_dtypes
import numpy as np

import boda_tpu.modes_all  # noqa: F401
import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu import cli as jcli
from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import build_model as jbuild_model
from boda_tpu.prof import wisdom as jwis
from boda_tpu.utils.digest import NdaDigest as JNdaDigest
from boda_tpu_torch import cli
from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.ops.op_base import Op
from boda_tpu_torch.prof.wisdom import (OpRun, OpWisdom, merge_wisdom, read_wisdom,
                                        write_wisdom)
from boda_tpu_torch.utils.digest import NdaDigest
from boda_tpu_torch.utils.lexp import parse_lexp

R50_BF16 = "testdata/wisdom/resnet50-bf16-v5e.wis"
TUNES = "(kg=(use_xla=1),gen=(),s2d=(use_s2d=1))"


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _body(fn):
    """A wisdom file's lines without its toolchain comment."""
    return [ln for ln in open(fn).read().splitlines() if not ln.startswith("# toolchain")]


def test_committed_wisdom_roundtrips_byte_for_byte(tmp_path):
    wis = read_wisdom(R50_BF16)
    assert len(wis) == 21 and wis[0].op.key() == jwis.read_wisdom(R50_BF16)[0].op.key()
    out = str(tmp_path / "w.wis")
    write_wisdom(out, wis)
    assert _body(out) == _body(R50_BF16)
    lines = open(out).read().splitlines()
    assert lines[0] == "boda_tpu wisdom v1" and lines[1].startswith("# toolchain torch=")
    assert [w.op.key() for w in jwis.read_wisdom(out)] == [w.op.key() for w in wis]


def test_bf16_digests_and_merge_across_packages(tmp_path):
    """A bf16 output held as f32 on the port's host digests as boda_tpu
    digests the bf16 array itself; files of both packages merge either way."""
    rng = np.random.RandomState(0)
    vals = rng.randn(4, 6).astype(ml_dtypes.bfloat16)
    d = NdaDigest.make(vals.astype(np.float32), tn="bfloat16")
    jd = JNdaDigest.make(vals)
    assert d.to_lexp_str() == jd.to_lexp_str()
    op = Op.parse("(type=sgemm,a=(M=4,K=8,__tn__=bfloat16),b=(K=8,N=6,__tn__=bfloat16),"
                  "c=(M=4,N=6,__tn__=bfloat16))")
    w = OpWisdom(op, {"c": d}, [OpRun("(precision=default)", "cuda:NVIDIA_H100", 2e-6, "ab")])
    mine, theirs = str(tmp_path / "port.wis"), str(tmp_path / "jax.wis")
    write_wisdom(mine, [w])
    jw = jwis.read_wisdom(mine)[0]
    jw.runs = [jwis.OpRun("(use_halo=1,precision=default)", "tpu:TPU_v5_lite", 3e-6, "ab")]
    jwis.write_wisdom(theirs, [jw])
    for merge, read in ((merge_wisdom, read_wisdom), (jwis.merge_wisdom, jwis.read_wisdom)):
        m = merge([read(mine), read(theirs)])
        assert len(m) == 1 and len(m[0].runs) == 2
        assert m[0].kg_digests["c"].sha256 == jd.sha256
        assert m[0].best("cuda:NVIDIA_H100").secs == 2e-6


def test_ops_prof_mini_corpus_cross_package(tmp_path):
    corpus = tmp_path / "ops.txt"
    ops = [
        "(type=conv,pad=1,stride=1,biases=(out_chan=16),filts=(out_chan=16,in_chan=3,y=3,x=3),"
        "in=(img=2,chan=3,y=32,x=32),out=(img=2,chan=16,y=32,x=32))",
        "(type=conv,pad=1,stride=2,biases=(out_chan=32),filts=(out_chan=32,in_chan=16,y=3,x=3),"
        "in=(img=2,chan=16,y=32,x=32),out=(img=2,chan=32,y=16,x=16))",
        "(type=sgemm,a=(M=2,K=64),b=(K=64,N=16),c=(M=2,N=16))"]
    corpus.write_text("\n".join(ops) + "\n")
    out, jout, again = (str(tmp_path / f) for f in ("port.wis", "jax.wis", "again.wis"))
    rc, log = _run(cli.main, ["ops_prof", "--be=(be=cuda,device=cpu)", f"--ops-fn={corpus}",
                              f"--op-tunes={TUNES}", "--n-iters=2", f"--wisdom-out-fn={out}"])
    assert rc == 0 and "FAIL" not in log, log
    wis = read_wisdom(out)
    assert [w.op.key() for w in wis] == [Op.parse(o).key() for o in ops]
    for w in wis:
        assert [r.tune for r in w.runs] == ["(use_xla=1)", "()", "(use_s2d=1)"]
        assert {r.plat for r in w.runs} == {"cuda:cpu"} and {r.method for r in w.runs} == {"ab"}
        assert set(w.kg_digests) == {"c" if w.op.type == "sgemm" else "out"}
    # the known-good digests anchor a second run, here on the oracle backend
    rc, log = _run(cli.main, ["ops_prof", "--be=(be=interp)", f"--ops-fn={corpus}",
                              "--op-tunes=(kg=())", "--n-iters=2", "--method=chain",
                              f"--wisdom-in-fn={out}", f"--wisdom-out-fn={again}"])
    assert rc == 0 and "FAIL" not in log, log
    # boda_tpu's own ops_prof (its oracle backend) on the same corpus: its
    # digests must merge with the port's
    rc, log = _run(jcli.main, ["ops_prof", "--be=(be=interp)", f"--ops-fn={corpus}",
                               "--op-tunes=(kg=())", "--n-iters=1", "--method=chain",
                               f"--wisdom-out-fn={jout}"])
    assert rc == 0, log
    for merge, read in ((merge_wisdom, read_wisdom), (jwis.merge_wisdom, jwis.read_wisdom)):
        m = merge([read(out), read(jout)])
        assert len(m) == 3 and all(len(w.runs) == 4 for w in m)


def test_wisdom_sig_keys_match_boda_tpu():
    pipe, _ = build_model("mini_resnet", img=2)
    jpipe, _ = jbuild_model("mini_resnet", img=2)
    eng = make("conv_fwd", "cuda", device="cpu", compute_tn="bfloat16")
    jeng = jmake("conv_fwd", "pallas", compute_tn="bfloat16")
    eng.pipe, jeng.pipe = pipe, jpipe
    names = [n for n, o in pipe.ops.items() if o.type in ("Convolution", "InnerProduct")]
    assert len(names) == 16
    for n in names:
        assert eng.wisdom_sig(n).key() == jeng.wisdom_sig(n).key()
    other = next(n for n, o in pipe.ops.items() if o.type == "Pooling")
    assert eng.wisdom_sig(other) is None


def test_engine_picks_wisdom_tune(tmp_path):
    """A per-op tune wins, then wisdom (net runs of this fingerprint, then
    standalone runs on this device, then other platforms' standalone runs);
    the chosen tune decides the op's route."""
    pipe, in_dims = build_model("mini_resnet", img=2)
    probe = make("conv_fwd", "cuda", device="cpu")
    probe.pipe = pipe
    net_plat, plat = probe.wisdom_plats()
    assert plat == "cuda:cpu" and net_plat.startswith("net:cuda:cpu:")
    other = make("conv_fwd", "cuda", device="cpu", fuse_block=True)
    assert other.fusion_fingerprint() != probe.fusion_fingerprint()
    sig = lambda n: probe.wisdom_sig(n)  # noqa: E731

    def rec(name, runs):
        return OpWisdom(sig(name), {}, [OpRun(t, p, s, "ab") for t, p, s in runs])
    wfn = str(tmp_path / "w.wis")
    write_wisdom(wfn, [
        rec("conv1", [("(use_xla=1)", plat, 2.0), ("()", net_plat, 3.0)]),  # net wins
        rec("s1b0_c1", [("(use_xla=1)", plat, 1.0), ("()", plat, 2.0),
                        ("()", "net:cuda:cpu:00000000", 0.5)]),  # other fingerprint
        rec("s2b0_c1", [("(use_halo=1,precision=default)", "tpu:TPU_v5_lite", 1.0),
                        ("(use_xla=1)", "tpu:TPU_v5_lite", 2.0)]),  # last resort
        rec("fc", [("(use_xla=1)", plat, 1.0)])])
    eng = make("conv_fwd", "cuda", device="cpu", wisdom_fn=wfn,
               per_op_tune={"s1b1_c1": parse_lexp("(use_xla=1)")})
    eng.init(pipe)
    log = eng.get_info_log()
    assert f"conv1: wisdom tune () (3000000.0us on {net_plat})" in log
    assert "s1b0_c1: wisdom tune (use_xla=1) (1000000.0us on cuda:cpu)" in log
    assert "s2b0_c1: wisdom tune (use_halo=1,precision=default)" in log
    assert "s2b0_c1: tune knobs with no effect on the card: use_halo" in log
    assert "fc: wisdom tune (use_xla=1)" in log and "fc: nhwc-ip lib" in log
    assert "s1b0_c1: nhwc-lib_conv" in log and "conv1: nhwc-direct_conv" in log
    assert "s1b1_c1: wisdom" not in log and "s1b1_c1: nhwc-lib_conv" in log
    out = eng.run_fwd(gen_data_inputs(in_dims), ["prob"])
    ref = make("conv_fwd", "cuda", device="cpu")
    ref.init(pipe)
    np.testing.assert_allclose(out["prob"].data,
                               ref.run_fwd(gen_data_inputs(in_dims), ["prob"])["prob"].data,
                               rtol=1e-4, atol=1e-6)
