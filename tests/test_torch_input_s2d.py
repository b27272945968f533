"""bench.py's host-folded stem in the port: ``input_s2d``, ``input_pad_c``
and the ``stem_s2d`` rule, against boda_tpu's, on the CPU, f32.

boda_tpu runs its ``pallas`` engine with the same Fields (its stem_s2d conv
is XLA under every policy; the rest of the net under ``gen`` in interpret
mode); the port runs its ``cuda`` engine with ``device=cpu``, where every
kernel wrapper takes its plain PyTorch version. The net is the fused test
net (tests/test_torch_engine_fused.py): the ResNet stem (7x7 s2 p3, C=3) on
a 32x32 input, so that the stem qualifies for the fold, then a pool, two
bottlenecks, an avg pool and an fc. Gate per node: comp_vars(mrd_toler=1e-5,
atol=1e-5 * max|ref|) with num_diff == 0. The validation errors and the
skips mirror tests/test_input_s2d.py:76-134; the weight gradient through
the folded stem mirrors tests/test_stem_s2d.py:82.
"""

import numpy as np
import pytest
from test_torch_engine_fused import _net

from boda_tpu.config import make as jmake
from boda_tpu.graph.autodiff import softmax_to_loss as jsoftmax_to_loss
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.parallel.train import build_net_fn
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu.utils.lexp import parse_lexp as jparse
from boda_tpu_torch.config import ConfigError
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.autodiff import add_bck_ops
from boda_tpu_torch.graph.pipe import PipeError
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu_torch.utils.lexp import parse_lexp as tparse

_NODES = ["prob", "fc", "pool5", "res2b_relu", "res2a_relu", "pool1", "conv1_relu"]
_FUSED = "(use_s2d=1,pool_pallas=1)"
# policy -> (boda_tpu's pallas Fields, the port's cuda Fields)
_POLICIES = {
    "lib": (dict(kernel_policy="lib"), dict(kernel_policy="lib")),
    "gen": (dict(kernel_policy="gen"), dict(kernel_policy="gen")),
    "fused": (dict(kernel_policy="gen", fuse_block=True, tune=jparse(_FUSED)),
              dict(kernel_policy="gen", fuse_block=True, tune=tparse(_FUSED))),
}


@pytest.fixture(scope="module")
def nets():
    jp, tp = _net(JNetBuilder, JDims), _net(TNetBuilder, TDims)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    x = np.random.RandomState(7).randn(*jp.nodes["data"].dims.shape).astype(np.float32)
    return dict(jp=jp, tp=tp, x=x, xh=np.ascontiguousarray(x.transpose(0, 2, 3, 1)))


def _folded(nda, dims_cls, xf):
    return nda(dims_cls.of(img=xf.shape[0], y=xf.shape[1], x=xf.shape[2],
                           chan=xf.shape[3]), xf)


def _check(jr, tr, nodes):
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert a.shape == b.shape, (n, a.shape, b.shape)
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
        assert r.ok() and r.num_diff == 0, f"{n}: {r}"


@pytest.mark.parametrize("policy", sorted(_POLICIES))
def test_input_s2d_per_node_against_boda_tpu(nets, policy):
    """input_pad_c 0 and 16: the host folds are bit-equal, every node agrees
    with boda_tpu's engine on the folded input, and the same engine still
    takes the logical NCHW input (folded on the device)."""
    jkw, tkw = _POLICIES[policy]
    for pad in (0, 16):
        je = jmake("conv_fwd", "pallas", input_s2d=True, input_pad_c=pad, **jkw)
        je.init(nets["jp"])
        te = tmake("conv_fwd", "cuda", device="cpu", input_s2d=True, input_pad_c=pad, **tkw)
        te.init(nets["tp"])
        log = te.get_info_log()
        assert "conv1: input_s2d on 'data'" in log and "conv1: nhwc-stem_s2d" in log, log
        jf, tf = je.host_input_s2d("data", nets["xh"]), te.host_input_s2d("data", nets["xh"])
        assert tf.shape == (2, 19, 19, max(pad, 12)) and np.array_equal(tf, jf)
        jr = je.run_fwd({"data": _folded(JNDA, JDims, jf)}, _NODES)
        _check(jr, te.run_fwd({"data": _folded(TNDA, TDims, tf)}, _NODES), _NODES)
        logical = TNDA(nets["tp"].nodes["data"].dims, nets["x"])
        _check(jr, te.run_fwd({"data": logical}, _NODES), _NODES)


def test_input_s2d_stem_takes_the_padded_hand_conv(nets):
    """Under gen the stem's conv runs on channels padded to a multiple of 8
    (12 -> 16, wgmma's rows), under lib on the exact fold; input_pad_c and
    input_s2d reach the wisdom fingerprint, as in boda_tpu."""
    fps = set()
    for pol, pad, want in (("gen", 0, "c=16 conv2d_nhwc"), ("gen", 16, "c=16 conv2d_nhwc"),
                           ("lib", 0, "c=12 lib"), ("lib", 16, "c=16 lib")):
        te = tmake("conv_fwd", "cuda", device="cpu", kernel_policy=pol, input_s2d=True,
                   input_pad_c=pad)
        te.init(nets["tp"])
        assert f"conv1: nhwc-stem_s2d s=2 k=7 m=4 {want}" in te.get_info_log()
        assert te.op_tune("conv1").stem_s2d == 1 and te.op_tune("conv1").pad_c == pad
        fps.add(te.fusion_fingerprint())
    plain = tmake("conv_fwd", "cuda", device="cpu")
    plain.init(nets["tp"])
    assert plain.fusion_fingerprint() not in fps and len(fps) == 4
    assert "nhwc-stem_s2d" not in plain.get_info_log()


def test_input_s2d_validation_and_skips():
    """tests/test_input_s2d.py:76-134 in the port: input_pad_c needs
    input_s2d and at least the folded channels; a multi-consumer input and a
    stride-1 stem take no fold (and host_input_s2d says so)."""
    def stem_net():
        b = TNetBuilder("s2dstem")
        t = b.input("data")
        t = b.conv("conv1", t, 16, 7, stride=2, pad=3, in_chans=3, relu=True)
        t = b.fc("fc", t, 10, in_feats=16 * 16 * 16)
        b.softmax("prob", t)
        return b.done({"data": TDims.of(img=2, chan=3, y=32, x=32)})
    with pytest.raises(ConfigError, match="requires input_s2d"):
        tmake("conv_fwd", "cuda", device="cpu", input_pad_c=32).init(stem_net())
    with pytest.raises(ConfigError, match="input_pad_c=4 < folded channels"):
        tmake("conv_fwd", "cuda", device="cpu", input_s2d=True, input_pad_c=4).init(stem_net())
    b = TNetBuilder("twoheads")
    t = b.input("data")
    b.conv("conv1", t, 8, 7, stride=2, pad=3, in_chans=3, relu=True)
    b.conv("conv2", t, 8, 7, stride=2, pad=3, in_chans=3, relu=True)
    two = b.done({"data": TDims.of(img=1, chan=3, y=16, x=16)})
    b = TNetBuilder("s1stem")
    t = b.input("data")
    b.conv("conv1", t, 8, 3, stride=1, pad=1, in_chans=3, relu=True)
    s1 = b.done({"data": TDims.of(img=1, chan=3, y=16, x=16)})
    for pipe in (two, s1):
        eng = tmake("conv_fwd", "cuda", device="cpu", input_s2d=True)
        eng.init(pipe)
        assert "input_s2d" not in eng.get_info_log()
        with pytest.raises(PipeError, match="no input_s2d fold"):
            eng.host_input_s2d("data", np.zeros((1, 16, 16, 3), np.float32))
    # a gradient graph takes no input fold (boda_tpu's guard: not bck_added)
    pipe = stem_net()
    add_bck_ops(pipe)
    eng = tmake("conv_fwd", "cuda", device="cpu", input_s2d=True)
    eng.init(pipe)
    assert "input_s2d" not in eng.get_info_log()


@pytest.mark.parametrize("policy", ["gen", "lib"])
def test_stem_s2d_weight_grads_match_jax_grad(policy):
    """The Bck lowering through the folded stem: its weight gradient comes
    back in the logical OIHW layout, equal to jax.grad of boda_tpu's net
    function (tests/test_stem_s2d.py:82's gate, comp_vars 1e-4)."""
    def net(builder, dims):
        b = builder("stemtiny")
        t = b.input("data")
        t = b.conv("conv1", t, 8, 7, stride=2, pad=3, in_chans=3, relu=True)
        t = b.fc("fc1", t, 5, in_feats=8 * 8 * 8)
        b.softmax("prob", t)
        return b.done({"data": dims.of(img=2, chan=3, y=16, x=16)})
    jp, tp = net(JNetBuilder, JDims), net(TNetBuilder, TDims)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    add_bck_ops(tp)
    eng = tmake("conv_fwd", "cuda", device="cpu", kernel_policy=policy,
                tune=tparse("(stem_s2d=1)"))
    eng.init(tp)
    assert "conv1: nhwc-stem_s2d" in eng.get_info_log()
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 16, 16).astype(np.float32)
    labels = np.array([1, 3], dtype=np.float32)
    want = {w: (w if tp.nodes.get(w) is not None and tp.nodes[w].dims is not None
                else f"{w}__p0") for w in ("conv1__filts__grad", "conv1__biases__grad")}
    outs = eng.run_fwd({"data": TNDA(tp.nodes["data"].dims, x),
                        "label": TNDA(TDims.of(img=2), labels)}, list(want.values()))
    import jax
    import jax.numpy as jnp
    jsoftmax_to_loss(jp)
    net_fn = build_net_fn(jp, ["prob_loss"])

    def loss(ws):
        return jnp.sum(net_fn(ws, {"data": x, "label": labels})["prob_loss"])
    g = jax.grad(loss)({k: w.data for k, w in jp.weights.items()})
    for w, node in want.items():
        got, ref = outs[node].data, np.asarray(g[w.replace("__grad", "")])
        assert got.shape == ref.shape, (w, got.shape, ref.shape)
        r = comp_vars(ref, got, mrd_toler=1e-4, atol=1e-4 * float(np.abs(ref).max()))
        assert r.ok(), f"{w}: {r}"
