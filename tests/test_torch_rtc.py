"""The port's rtc layer against boda_tpu's on the CPU: var management, call
errors, gen_data, the codegen cache, op signatures and tunes.

The port's ``cuda`` backend runs with ``device=cpu`` (the kernels' plain
versions); boda_tpu's ``interp`` backend is the reference for gen_data.
"""

import numpy as np
import pytest

import boda_tpu.modes_all  # noqa: F401 (registers boda_tpu's backends)
import boda_tpu_torch.modes_all  # noqa: F401 (registers the port's backends)
from boda_tpu.config import make as jmake
from boda_tpu.ops.op_base import Op as JOp
from boda_tpu.ops.registry import Codegen as JCodegen
from boda_tpu.ops.tune import OpTune as JOpTune
from boda_tpu.rtc.compute import Call as JCall
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make
from boda_tpu_torch.ops.op_base import Op, load_op_sigs, save_op_sigs
from boda_tpu_torch.ops.registry import Codegen
from boda_tpu_torch.ops.tune import OpTune
from boda_tpu_torch.rtc.compute import Call, RtcError
from boda_tpu_torch.utils.dims import NDA, Dims


def _be(name):
    return make("be", "cuda", device="cpu") if name == "cuda" else make("be", name)


@pytest.mark.parametrize("name", ["cuda", "interp"])
def test_var_management(name):
    be = _be(name)
    d = Dims.of(y=4, x=8)
    be.create_var_with_dims("v", d)
    assert be.var_exists("v") and be.get_var_dims("v") == d
    out = be.copy_var_to_nda("v")
    assert out.data.shape == (4, 8) and np.all(out.data == 0)
    src = NDA(d, np.arange(32, dtype=np.float32).reshape(4, 8))
    be.copy_nda_to_var("v", src)
    assert np.array_equal(be.copy_var_to_nda("v").data, src.data)
    be.set_var_to_zero("v")
    assert np.all(be.copy_var_to_nda("v").data == 0)
    with pytest.raises(RtcError):
        be.create_var_with_dims("v", d)
    with pytest.raises(RtcError, match="dims mismatch"):
        be.copy_nda_to_var("v", NDA(Dims.of(y=2, x=8), np.zeros((2, 8), np.float32)))
    be.release_var("v")
    assert not be.var_exists("v")
    with pytest.raises(RtcError):
        be.copy_var_to_nda("v")
    # a bf16 var holds bf16 on the device and f32 on the host
    bd = Dims.of(n=5, tn="bfloat16")
    be.create_var_from_nda("h", NDA(bd, np.array([1.0, 1.00390625, -2.5, 0.0, 3.0])))
    assert str(be.get_var_raw("h").dtype) == "torch.bfloat16"
    assert be.copy_var_to_nda("h").data.dtype == np.float32


def test_gen_data_bit_equal_to_jax_interp():
    """The gen_data generator on the port's backend gives boda_tpu's interp
    backend's values bit for bit (f32 and bf16; exact)."""
    for tn in ("float32", "bfloat16"):
        sizes = dict(a=7, b=143)
        sig = {"mod": "13", "stride": "11", "offset": "5", "sub": "6.5", "mul": "0.3"}
        jbe = jmake("be", "interp")
        jfi = JCodegen(jbe).gen_func(JOp("gen_data", sig, {"out": JDims.of(tn=tn, **sizes)}))
        jbe.create_var_with_dims("x", JDims.of(tn=tn, **sizes))
        jbe.compile()
        jbe.run(JCall(jfi.name, {"out": "x"}))
        ref = np.asarray(jbe.copy_var_to_nda("x").data, np.float32)
        be = _be("cuda")
        cg = Codegen(be)
        fi = cg.gen_func(Op("gen_data", sig, {"out": Dims.of(tn=tn, **sizes)}))
        be.create_var_with_dims("x", Dims.of(tn=tn, **sizes))
        cg.compile()
        cg.run_func(fi, {"out": "x"})
        got = be.copy_var_to_nda("x").data
        assert got.dtype == np.float32 and got.shape == (7, 143)
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32)), tn
        assert len(np.unique(got)) == 13


def test_codegen_cache_naming_and_call_errors():
    be = _be("cuda")
    cg = Codegen(be)
    d = Dims.of(M=8, K=8)
    op = Op("sgemm", {}, {"a": d, "b": Dims.of(K=8, N=8), "c": Dims.of(M=8, N=8)})
    f1 = cg.gen_func(op)
    assert cg.gen_func(op.copy()) is f1  # cache hit on an equal signature
    f3 = cg.gen_func(op, OpTune(bm=8))
    assert f3 is not f1 and (f1.name, f3.name) == ("sgemm__0", "sgemm__1")
    with pytest.raises(RtcError, match="no kernel generator"):
        cg.gen_func(Op("nosuch", {}, {}))
    g = cg.gen_func(Op("gen_data", {}, {"out": Dims.of(n=64)}))
    be.create_var_with_dims("x", Dims.of(n=64))
    with pytest.raises(RtcError, match="not compiled"):
        be.run(Call(g.name, {"out": "x"}))
    cg.compile()
    b = be.run(Call(g.name, {"out": "x"}))
    e = be.run(Call(g.name, {"out": "x"}))
    assert be.get_dur(b, e) > 0
    with pytest.raises(RtcError, match="missing arg|missing out arg"):
        be.run(Call(g.name, {}))
    with pytest.raises(RtcError, match="no function named"):
        be.run(Call("nosuch__9", {}))


def test_op_sig_roundtrip_matches_boda_tpu(tmp_path):
    op = Op("sgemm", {"flags": "x,y"},
            {"a": Dims.of(M=4, K=4, tn="bfloat16"), "b": Dims.of(K=4, N=4),
             "c": Dims.of(M=4, N=4)})
    s = op.key()
    op2 = Op.parse(s)
    assert op2 == op and op2.sval("flags") == "x,y"
    assert JOp.parse(s).key() == s  # the same canonical string in boda_tpu
    fn = str(tmp_path / "sigs.txt")
    save_op_sigs(fn, [op, op2])
    assert load_op_sigs(fn) == [op, op]


def test_tune_keys_match_boda_tpu_and_unported_knobs_raise():
    """Every knob of boda_tpu's OpTune parses with the same key; the ones
    with no effect on the card are named; det_top_k, the last knob to be
    ported (the SSD head), parses and has an effect; an unknown knob raises."""
    for s in ("()", "(use_halo=1,precision=default)", "(bm=512,bk=1024,tap_cat=1)",
              "(chunk=4,use_iconv=0,stem_im2col=1,nb=2,pool_shift=1,pool_bview=2,"
              "dimension_semantics=parallel)", "(use_s2d=1,pool_pallas=1,use_xla=1)",
              "(stem_s2d=1,pad_c=16)", "(acc_tn=bfloat16,in_tn=bfloat16)", "(int8=1)"):
        assert OpTune.parse(s).key() == JOpTune.parse(s).key() == s
    assert OpTune.parse("(use_halo=1,precision=default)").no_effect() == ["use_halo"]
    assert OpTune.parse("(use_s2d=1,use_xla=1)").no_effect() == []
    assert OpTune.parse("(stem_s2d=1,pad_c=16)").no_effect() == []
    assert OpTune.parse("(acc_tn=bfloat16,in_tn=bfloat16)").no_effect() == ["acc_tn",
                                                                            "in_tn"]
    assert OpTune.parse("(int8=1)").no_effect() == []
    assert OpTune.parse("(det_top_k=100)").key() == JOpTune.parse("(det_top_k=100)").key() \
        == "(det_top_k=100)"
    assert OpTune.parse("(det_top_k=100)").no_effect() == []
    with pytest.raises(ValueError, match="unknown knob"):
        OpTune.parse("(nosuch=1)")
