"""int8 activation storage (``act_int8``) against boda_tpu, on the CPU: each
case of tests/test_act_int8.py that the port can run (its batch_split case
is XLA-only, ROADMAP §1 item 11), on mini_resnet with boda_tpu's net_calib
sidecar, the port's engine (``device=cpu``) beside boda_tpu's ``pallas``
engine on the same input: both store the same nodes with the same scales,
so their outputs agree to f32 rounding (comp_vars 1e-5 rel) or, where a
float value sits next to a rounding boundary, by one quant step (the
bound in test_act_int8_top1_and_prob), and each case's own gate holds on
the port."""

import io
from contextlib import redirect_stderr

import numpy as np
import pytest

from boda_tpu.cli import main as jmain
from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.ops.kernels.gen_data import gen_data_pattern as jgen
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu_torch.config import ConfigError
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.autodiff import add_bck_ops
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.dims import NDA as TNDA

TRUNK = ["relu1", "s1b?_relu", "s2b?_relu", "s3b?_relu"]


@pytest.fixture(scope="module")
def calib_fn(tmp_path_factory):
    fn = str(tmp_path_factory.mktemp("calib") / "mini.calib.json")
    assert jmain(["net_calib", "--model=mini_resnet", "--img=4", "--batches=3",
                  f"--out-fn={fn}"]) == 0
    return fn


def _run(img, out=("prob",), feed=None, boda=False, **kw):
    """One forward of mini_resnet (gen data, or ``feed``: node -> array) on
    the port's engine, or boda_tpu's with ``boda``; (outputs, engine)."""
    build, make, NDA = (jbuild, jmake, JNDA) if boda else (tbuild, tmake, TNDA)
    pipe, in_dims = build("mini_resnet", img=img)
    with redirect_stderr(io.StringIO()):
        eng = make("conv_fwd", "pallas", kernel_policy="gen", **kw) if boda else \
            make("conv_fwd", "cuda", device="cpu", **kw)
        eng.init(pipe)
    d = in_dims["data"]
    if feed is None:
        ins = {"data": NDA(d, np.array(jgen(d.shape, d.tn)))}
    else:
        ins = {k: NDA(pipe.must_dims(k), v) for k, v in feed.items()}
    outs = eng.run_fwd(ins, list(out))
    return {k: v.data for k, v in outs.items()}, eng


def _same(a, b):
    r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
    assert r.ok() and r.num_diff == 0, str(r)


def test_act_int8_top1_and_prob(calib_fn):
    """The ReLU-fed trunk stored as uint8 with boda_tpu's scales; prob within
    0.05 of the float engine's with the same top-1. Against boda_tpu: the
    float convs between the stores differ by an f32 ulp, so a value next to
    a rounding boundary may store one quant step apart (found: 1 element of
    s2b1_relu, then 5 and 35 downstream of it, each exactly one step; prob
    6.2e-4 apart). Gate: every stored element equal or one step apart, under
    1% of them apart, prob within 1e-3 with the same top-1."""
    ref, _ = _run(4)
    q, eng = _run(4, act_int8=TRUNK, calib_fn=calib_fn)
    stored = sorted(eng._act_q)
    q, eng = _run(4, out=stored + ["prob"], act_int8=TRUNK, calib_fn=calib_fn)
    jq, jeng = _run(4, out=stored + ["prob"], boda=True, act_int8=TRUNK, calib_fn=calib_fn)
    sel = [ln for ln in eng._info_log if ln.startswith("act_int8 ")]
    assert len(sel) >= 7 and all("uint8" in ln for ln in sel), sel
    assert sel == [ln for ln in jeng._info_log if ln.startswith("act_int8 ")]
    assert eng._act_q == jeng._act_q
    for n in stored:
        d = np.abs(q[n] - jq[n])
        step = eng._act_q[n][1]
        assert float(d.max()) <= step * (1 + 1e-5), n
        assert (d > 1e-5 * step).mean() < 0.01, n
    assert float(np.abs(jq["prob"] - q["prob"]).max()) <= 1e-3
    assert (jq["prob"].argmax(1) == q["prob"].argmax(1)).all()
    assert (ref["prob"].argmax(1) == q["prob"].argmax(1)).all()
    assert float(np.abs(ref["prob"] - q["prob"]).max()) < 0.05


def test_act_int8_node_output_is_dequantized(calib_fn):
    """A stored node asked for as an output comes back dequantized, in its
    logical dtype, within half a quant step of the float engine's."""
    ref, _ = _run(2, out=("s1b0_relu",))
    q, eng = _run(2, out=("s1b0_relu",), act_int8=["s1b0_relu"], calib_fn=calib_fn)
    jq, _ = _run(2, out=("s1b0_relu",), boda=True, act_int8=["s1b0_relu"], calib_fn=calib_fn)
    rv, qv = ref["s1b0_relu"], q["s1b0_relu"]
    assert qv.dtype == rv.dtype
    scale = eng._act_q["s1b0_relu"][1]
    assert float(np.abs(rv - qv).max()) <= 0.5001 * scale + 1e-6
    _same(jq["s1b0_relu"], qv)


def test_act_int8_feed_quantized_node_as_input(calib_fn):
    """A run fed a stored node as a float input is exact: the float passes
    the dequantize untouched."""
    full, _ = _run(2, out=("s1b0_relu", "prob"), act_int8=["s1b0_relu"], calib_fn=calib_fn)
    out2, _ = _run(2, feed={"s1b0_relu": full["s1b0_relu"]}, act_int8=["s1b0_relu"],
                   calib_fn=calib_fn)
    assert np.allclose(out2["prob"], full["prob"], atol=2e-5)


def test_act_int8_errors(calib_fn, tmp_path):
    """boda_tpu's init errors: no calib_fn, a pattern matching no node, a
    node the sidecar has no amax for, a graph with backward ops, and a
    training engine (train=1)."""
    import json
    with pytest.raises(ConfigError, match="calib"):
        _run(2, act_int8=["relu1"])
    with pytest.raises(ConfigError, match="matches no activation node"):
        _run(2, act_int8=["no_such_node*"], calib_fn=calib_fn)
    rec = json.load(open(calib_fn))
    rec["amax"].pop("relu1", None)
    crippled = str(tmp_path / "crippled.json")
    json.dump(rec, open(crippled, "w"))
    with pytest.raises(ConfigError, match="no amax for"):
        _run(2, act_int8=["relu1"], calib_fn=crippled)
    pipe, _ = tbuild("mini_resnet", img=1, in_sz=8)
    add_bck_ops(pipe)
    eng = tmake("conv_fwd", "cuda", device="cpu", act_int8=["relu1"], calib_fn=calib_fn)
    with pytest.raises(ConfigError, match="inference-only"):
        eng.init(pipe)
    eng = tmake("conv_fwd", "cuda", device="cpu", act_int8=["relu1"], calib_fn=calib_fn,
                train=True)
    with pytest.raises(ConfigError, match="inference-only"):
        eng.init(tbuild("mini_resnet", img=1, in_sz=8)[0])


def test_act_int8_changes_fingerprint_and_capture_key(calib_fn):
    pipe, _ = tbuild("mini_resnet", img=2)
    a = tmake("conv_fwd", "cuda", device="cpu")
    b = tmake("conv_fwd", "cuda", device="cpu", act_int8=["relu1"], calib_fn=calib_fn)
    a.init(pipe)
    b.init(pipe)
    assert a.fusion_fingerprint() != b.fusion_fingerprint()
    assert a._graph_key({}, ["prob"]) != b._graph_key({}, ["prob"])


def test_act_int8_direct_feed_into_int8_conv(calib_fn):
    """Engine-wide int8 with act_int8: the stored nodes are signed int8 and
    the int8 convs that read them take the stored value as their operand
    (no dequantize, no quantize); prob as boda_tpu's and within the
    quantization gate of the float engine's."""
    ref, _ = _run(4)
    q, eng = _run(4, act_int8=TRUNK, calib_fn=calib_fn, int8="1")
    jq, jeng = _run(4, boda=True, act_int8=TRUNK, calib_fn=calib_fn, int8="1")
    sel = [ln for ln in eng._info_log if ln.startswith("act_int8 ")]
    assert sel and all("signed for direct int8-conv feed" in ln for ln in sel), sel
    assert eng._q8_direct and eng._q8_direct == jeng._q8_direct
    _same(jq["prob"], q["prob"])
    assert (ref["prob"].argmax(1) == q["prob"].argmax(1)).all()
    assert float(np.abs(ref["prob"] - q["prob"]).max()) < 0.06
