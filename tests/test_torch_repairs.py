"""Two repaired faults of the port, on the CPU.

1. The rtc ``conv`` op (ops/kernels/conv.py:gen_conv) must time the kernels
   the engine runs (graph/lowering_nhwc.py:_nhwc_conv). At every conv
   signature of ResNet-50 and each tune, both lowerings are called with the
   kernel entries replaced by spies that record the kernel they lead to
   (K1's ``matmul``; the direct conv of K2/K3 through ``conv2d``,
   ``conv2d_halo`` or ``conv2d_nhwc``; the K4 fold; the library's
   ``F.conv2d``) and stop the call; the two must agree. Before the repair,
   gen_conv sent 15 of the 20 signatures (the 1x1s) to the direct conv or
   the fold, where the engine runs the GEMM.
2. chip_smoke.py's forward gate on ``prob``: the random-weight net's
   softmax is saturated (prob one-hot, so gen and lib agree trivially);
   chip_smoke.py scales fc1000's weights as its gradient phase does. Held
   here on ResNet-50 at batch 2, 64x64, f32, on the library path.
"""

import numpy as np
import pytest
import torch

import boda_tpu_torch.modes_all  # noqa: F401
import chip_smoke
from boda_tpu_torch.config import make
from boda_tpu_torch.graph import lowering_nhwc as low
from boda_tpu_torch.graph.lowering import LowerCtx
from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
from boda_tpu_torch.ops.kernels import conv as kconv
from boda_tpu_torch.ops.op_base import Op
from boda_tpu_torch.ops.registry import Codegen
from boda_tpu_torch.ops.sig_of import rtc_sig_of
from boda_tpu_torch.ops.tune import OpTune

# each entry point -> the kernel it launches
_ENTRIES = {
    (low, "matmul"): "K1 matmul", (kconv, "matmul"): "K1 matmul",
    (low, "conv2d_halo"): "direct conv", (kconv, "conv2d"): "direct conv",
    (kconv, "conv2d_nhwc"): "direct conv",
    (low, "space_to_depth_conv"): "K4 fold", (kconv, "space_to_depth_conv"): "K4 fold",
}
_TUNES = ["()", "(use_s2d=1)", "(use_xla=1)", "(use_k1conv=0)", "(use_k1conv=0,use_s2d=1)"]


class _Picked(Exception):
    pass


def _spy(kernel):
    def fn(*args, **kwargs):
        raise _Picked(kernel)
    return fn


def _picked(fn, *args) -> str:
    with pytest.raises(_Picked) as e:
        fn(*args)
    return str(e.value)


@pytest.fixture(scope="module")
def r50_convs():
    """(graph op, rtc signature) of each distinct conv signature of ResNet-50."""
    pipe, _ = load_net("resnet50", img=1)
    seen = {}
    for name in pipe.topo_op_order():
        op = pipe.ops[name]
        if op.type == "Convolution":
            seen.setdefault(rtc_sig_of(pipe, op).key(), (op, rtc_sig_of(pipe, op)))
    assert len(seen) == 20
    return pipe, list(seen.values())


@pytest.mark.parametrize("tune", _TUNES)
def test_rtc_conv_and_engine_pick_the_same_kernel(monkeypatch, r50_convs, tune):
    pipe, convs = r50_convs
    for (mod, name), kernel in _ENTRIES.items():
        monkeypatch.setattr(mod, name, _spy(kernel))
    monkeypatch.setattr(torch.nn.functional, "conv2d", _spy("library"))
    t = OpTune.parse(tune)
    cg = Codegen(make("be", "cuda", device="cpu"))
    picks = {}
    for op, sig in convs:
        ind, fd = pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1])
        kh, kw = op.kern_sz()
        eng_fn, _ = low.lower_op_nhwc(pipe, op, LowerCtx(), t, [])
        x = torch.zeros((1, ind["y"], ind["x"], ind["chan"]))
        w = torch.zeros((kh, kw, fd["in_chan"], fd["out_chan"]))
        b = torch.zeros((fd["out_chan"],))
        eng = _picked(eng_fn, x, w, b)
        fi = cg.gen_func(Op.parse(sig.key()), t)
        rtc = _picked(fi.fn, x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), b)
        assert eng == rtc, (tune, op.name, sig.key(), eng, rtc, fi.info)
        picks[(kh, op.stride()[0])] = eng
    # the 1x1s take K1 unless the tune turns it off (or asks for the library)
    want_1x1 = {"(use_xla=1)": "library"}.get(tune, "direct conv" if "k1conv=0" in tune
                                                   else "K1 matmul")
    assert picks[(1, 1)] == picks[(1, 2)] == want_1x1, picks


def test_rtc_k1conv_route_computes_the_conv():
    # a strided 1x1 with ReLU through gen_conv's K1 route, f32 on the CPU,
    # against the plain conv (use_ref): 1e-5 of max|ref|
    rng = np.random.RandomState(5)
    n, c, hw, oc, s = 2, 16, 9, 24, 2
    o = (hw - 1) // s + 1
    sig = (f"(type=conv,pad=0,relu=1,stride={s},biases=(out_chan={oc}),"
           f"filts=(out_chan={oc},in_chan={c},y=1,x=1),in=(img={n},chan={c},y={hw},x={hw}),"
           f"out=(img={n},chan={oc},y={o},x={o}))")
    x = torch.from_numpy(rng.randn(n, c, hw, hw).astype(np.float32))
    w = torch.from_numpy((rng.randn(oc, c, 1, 1) / 4).astype(np.float32))
    b = torch.from_numpy((rng.randn(oc) * 0.1).astype(np.float32))
    cg = Codegen(make("be", "cuda", device="cpu"))
    fi = cg.gen_func(Op.parse(sig), OpTune.parse("()"))
    assert fi.info.startswith("cuda:matmul k1conv s=(2, 2)"), fi.info
    ref = torch.relu(torch.nn.functional.conv2d(x, w, b, stride=s))
    got = fi.fn(x, w, b)
    assert got.shape == ref.shape == (n, oc, o, o)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_fc1000_scale_unsaturates_prob():
    pipe, dims = load_net("resnet50", img=2, in_sz=64)
    ins = gen_data_inputs(dims)
    eng = make("conv_fwd", "cuda", kernel_policy="lib", device="cpu")
    eng.init(pipe)
    out = eng.run_fwd(ins, ["prob", "fc1000"])
    assert out["prob"].data.max() > 0.99  # saturated: one-hot
    scale = 1.0 / float(np.abs(out["fc1000"].data).max())
    assert 0 < scale < 1
    chip_smoke.scale_fc1000([pipe], scale)
    eng = make("conv_fwd", "cuda", kernel_policy="lib", device="cpu")
    eng.init(pipe)
    out = eng.run_fwd(ins, ["prob", "fc1000"])
    assert np.abs(out["fc1000"].data).max() == pytest.approx(1.0, rel=1e-5)
    prob = out["prob"].data
    assert np.allclose(prob.sum(axis=1), 1.0, atol=1e-5)
    assert prob.max() < 0.01 and prob.min() > 1e-4  # logits in [-1, 1]
