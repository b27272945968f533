"""The engine's CUDA-graph capture (``cuda_graph=1``) on the card: each replay
is bit-equal to an eager forward of the same engine (``cuda_graph=0``) and
launches the same kernels, for a gen and a fused net in bf16 and for a gen
gradient graph, and a second batch of the same key replays the same graph
and follows its input; the graph is dropped on init() and on a new key; a lowering
that a capture cannot record raises, naming its op, and runs no forward; a
graph freed by Python's cyclic collector does not break another capture.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. On the
machine with the card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_graph.py``.
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.config import make
from boda_tpu_torch.graph.autodiff import add_bck_ops
from boda_tpu_torch.models.zoo import NetBuilder, build_model
from boda_tpu_torch.ops.kernels import block, conv, pool, sgemm
from boda_tpu_torch.utils.dims import NDA, Dims
from boda_tpu_torch.utils.lexp import parse_lexp

pytestmark = pytest.mark.cuda

_COUNTERS = (sgemm.matmul, conv.conv2d, conv.conv2d_nhwc, conv.space_to_depth_conv,
             block.bottleneck, pool.pool2d)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _fused_net():
    """The ResNet stem, pool1, a downsampling and an identity bottleneck at
    C = 256, K = 64 (K6's wgmma route), avg pool, fc."""
    b = NetBuilder("graphnet")
    t = b.input("data")
    t = b.conv("conv1", t, 64, 7, stride=2, pad=3, in_chans=3)
    t = b.bn_scale("bn_conv1", t, 64)
    t = b.relu("conv1_relu", t)
    t = b.pool("pool1", t, kern=3, stride=2)
    in_c = 64
    for tag in ("res2a", "res2b"):
        sc = t
        if tag == "res2a":
            sc = b.conv(f"{tag}_branch1", t, 256, 1, in_chans=in_c)
            sc = b.bn_scale(f"bn{tag[3:]}_branch1", sc, 256)
        u = b.conv(f"{tag}_branch2a", t, 64, 1, in_chans=in_c, relu=True)
        u = b.conv(f"{tag}_branch2b", u, 64, 3, pad=1, in_chans=64, relu=True)
        u = b.conv(f"{tag}_branch2c", u, 256, 1, in_chans=64)
        t = b.eltwise(tag, [sc, u], relu=True)
        in_c = 256
    t = b.pool("pool5", t, kern=8, stride=1, avg=True, global_pool=True)
    t = b.fc("fc", t, 10, in_feats=256)
    b.softmax("prob", t)
    return b.done({"data": Dims.of(img=4, chan=3, y=64, x=64)})


def _ins(pipe, names=("data",), seed=5):
    rng = np.random.RandomState(seed)
    out = {n: NDA(pipe.nodes[n].dims, rng.randn(*pipe.nodes[n].dims.shape)
                  .astype(np.float32)) for n in names}
    if "label" in pipe.nodes:
        n = pipe.nodes["data"].dims["img"]
        out["label"] = NDA(pipe.nodes["label"].dims,
                           ((np.arange(n) + seed) % 7).astype(np.float32))
    return out


def _counted(run):
    for f in _COUNTERS:
        f.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, [f.launches for f in _COUNTERS]


def _replay_vs_eager(eng, ins, ins2, outs):
    """The capture against eager on ``ins``, then a second batch ``ins2`` of
    the same key through the same graph: the replay must follow its input."""
    eng.cuda_graph = False
    eager, n_eager = _counted(lambda: eng.run_fwd(ins, outs))
    eng.cuda_graph = True
    eng.prepare(ins, outs)
    graph, n_graph = _counted(lambda: eng.run_fwd(ins, outs))
    g = eng._graph
    assert g is not None and n_graph == n_eager and sum(n_graph) > 0
    again, n_again = _counted(lambda: eng.run_fwd(ins, outs))  # replay only
    assert sum(n_again) == 0
    eng.cuda_graph = False
    eager2 = eng.run_fwd(ins2, outs)
    eng.cuda_graph = True
    replay2, n_replay2 = _counted(lambda: eng.run_fwd(ins2, outs))
    assert eng._graph is g and sum(n_replay2) == 0  # the same graph, replayed
    for n in outs:
        assert np.array_equal(graph[n].data, eager[n].data), n
        assert np.array_equal(again[n].data, eager[n].data), n
        assert np.array_equal(replay2[n].data, eager2[n].data), n
    assert not np.array_equal(eager2[outs[0]].data, eager[outs[0]].data)


@pytest.mark.parametrize("fused", [False, True])
def test_replay_bit_equal_to_eager(dev, fused):
    pipe = _fused_net()
    kw = dict(fuse_block=True, tune=parse_lexp("(use_s2d=1,pool_pallas=1)")) if fused else {}
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16", **kw)
    eng.init(pipe)
    if fused:
        assert "block-fused bottleneck" in eng.get_info_log()
    _replay_vs_eager(eng, _ins(pipe), _ins(pipe, seed=6), ["prob", "fc"])


@pytest.mark.parametrize("tune", ["()", "(pool_pallas=1)"])
def test_gradient_graph_replay_bit_equal_to_eager(dev, tune):
    """gen's gradient graph: every Bck op's recompute and autograd.grad and
    the hand dgrads and wgrads inside one capture; with pool_pallas, the
    avg pool's recompute on K8 and its backward (the autograd of the
    library pool, on autograd's thread, with the cached divisor). The
    strided convs' backward is cuDNN's, whose default f32 algorithms are
    not deterministic (two eager passes differ in the last bits); the test
    asks for its deterministic algorithms, so that what differs is the
    capture alone."""
    pipe, _ = build_model("mini_resnet", img=2, num_cls=8, in_sz=16)
    add_bck_ops(pipe)
    eng = make("conv_fwd", "cuda", tune=parse_lexp(tune))
    eng.init(pipe)
    assert "bck-conv" in eng.get_info_log()
    want = ["prob_loss", "data__grad__p0"] + [
        n for n in pipe.nodes if pipe.nodes[n].dims is not None and
        any(n.startswith(w + "__grad") for w in pipe.weights)]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _replay_vs_eager(eng, _ins(pipe), _ins(pipe, seed=6), want)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_graph_dropped_on_init_and_on_a_new_key(dev):
    pipe, dims = build_model("mini_resnet", img=2, num_cls=8, in_sz=16)
    eng = make("conv_fwd", "cuda")
    eng.init(pipe)
    ins = _ins(pipe)
    eng.run_fwd(ins, ["prob"])
    g = eng._graph
    assert g is not None and g.key[1] == ("prob",)
    eng.run_fwd(ins, ["prob"])
    assert eng._graph is g  # the same key replays the same graph
    eng.run_fwd(ins, ["fc", "prob"])
    assert eng._graph is not g and eng._graph.key[1] == ("fc", "prob")
    eng.init(pipe)
    assert eng._graph is None


def test_capture_illegal_lowering_raises(dev):
    """A lowering that reads a value back to the host (legal eagerly, not in
    a capture) makes run_fwd raise, naming the op; nothing runs eagerly in
    its place and no graph is kept."""
    pipe, _ = build_model("mini_resnet", img=2, num_cls=8, in_sz=16)
    eng = make("conv_fwd", "cuda")
    eng.init(pipe)
    eng._lowered["prob"] = lambda x: (x * float(x.abs().sum().item()),)
    with pytest.raises(RuntimeError, match="capture failed at op 'prob'"):
        eng.run_fwd(_ins(pipe), ["prob"])
    assert eng._graph is None
    torch.cuda.synchronize()


def test_capture_survives_a_graph_freed_by_the_collector(dev):
    """An engine's captured graph lives in a reference cycle (the engine and
    its net closure), so only Python's cyclic collector frees it, whenever an
    allocation next starts it. Freeing a graph while another capture runs
    invalidates that capture; the port's captures (rtc/backends.py:capture,
    used by graph_time and the engine) hold the collector off. Here the
    engine turns to garbage inside a capture whose allocations start a full
    collection at once."""
    import gc

    from boda_tpu_torch.rtc.backends import graph_time
    pipe, in_dims = build_model("mini_resnet", img=2)
    ins = {"data": NDA(in_dims["data"], np.random.RandomState(3).randn(
        *in_dims["data"].shape).astype(np.float32))}
    x = torch.full((64, 64), 0.5, device=dev)  # no device RNG: a capture test before
    old = gc.get_threshold()                      # may leave its state mid-capture
    try:
        for what in ("graph_time", "engine"):
            e = make("conv_fwd", "cuda")
            e.init(pipe)
            e.run_fwd(ins, ["prob"])
            assert e._graph is not None
            held = [e]
            del e

            def run_once():
                if torch.cuda.is_current_stream_capturing() and held:
                    held.clear()  # the engine and its graph: garbage, in a cycle
                    gc.set_threshold(1, 1, 1)
                    _ = [[] for _ in range(1000)]
                return x @ x
            if what == "graph_time":
                assert graph_time(run_once, 4) > 0
            else:
                e2 = make("conv_fwd", "cuda")
                e2.init(pipe)
                lowered = e2._lowered["prob"]
                e2._lowered["prob"] = lambda *a: (run_once(), lowered(*a))[1]
                out = e2.run_fwd(ins, ["prob"])["prob"].data
                assert np.isfinite(out).all()
            gc.set_threshold(*old)
            gc.collect()
    finally:
        gc.set_threshold(*old)
