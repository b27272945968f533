"""The fused configuration (``fuse_block=1, tune=(use_s2d=1,pool_pallas=1)``)
of the port's engine against boda_tpu's, on the CPU, f32.

A small net built the same way in both packages: the ResNet stem (7x7 s2 p3
-> BN/Scale/ReLU -> max pool 3x3 s2), one downsampling and one identity
bottleneck at C=128, avg pool, fc. Its 32x32 input makes the stem's output
16 wide, so boda_tpu's folded stem runs K3 (its block plan needs a width
that is a multiple of 8), its identity block K6 and its pools K8, all in
interpret mode; the port runs its kernels' plain versions (``device=cpu``).
Gate per node: comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|) with
num_diff == 0, the tests/test_block_fuse.py bar.
"""

import contextlib
import io

import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu.utils.lexp import parse_lexp as jparse
from boda_tpu_torch import cli
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.autodiff import add_bck_ops
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.ops.kernels import block as tblock
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu_torch.utils.lexp import parse_lexp as tparse

_TUNE = "(use_s2d=1,pool_pallas=1)"
_NODES = ["prob", "fc", "pool5", "res2b_relu", "res2a_relu", "pool1", "conv1_relu"]


def _net(builder, dims):
    b = builder("fusednet")
    t = b.input("data")
    t = b.conv("conv1", t, 16, 7, stride=2, pad=3, in_chans=3)
    t = b.bn_scale("bn_conv1", t, 16)
    t = b.relu("conv1_relu", t)
    t = b.pool("pool1", t, kern=3, stride=2)
    in_c = 16
    for tag in ("res2a", "res2b"):
        sc = t
        if tag == "res2a":
            sc = b.conv(f"{tag}_branch1", t, 128, 1, in_chans=in_c)
            sc = b.bn_scale(f"bn{tag[3:]}_branch1", sc, 128)
        u = b.conv(f"{tag}_branch2a", t, 32, 1, in_chans=in_c)
        u = b.bn_scale(f"bn{tag[3:]}_branch2a", u, 32)
        u = b.relu(f"{tag}_branch2a_relu", u)
        u = b.conv(f"{tag}_branch2b", u, 32, 3, pad=1, in_chans=32)
        u = b.bn_scale(f"bn{tag[3:]}_branch2b", u, 32)
        u = b.relu(f"{tag}_branch2b_relu", u)
        u = b.conv(f"{tag}_branch2c", u, 128, 1, in_chans=32)
        u = b.bn_scale(f"bn{tag[3:]}_branch2c", u, 128)
        t = b.eltwise(tag, [sc, u], relu=True)
        in_c = 128
    t = b.pool("pool5", t, kern=8, stride=1, avg=True, global_pool=True)
    t = b.fc("fc", t, 10, in_feats=128)
    b.softmax("prob", t)
    return b.done({"data": dims.of(img=2, chan=3, y=32, x=32)})


@pytest.fixture(scope="module")
def nets():
    jp, tp = _net(JNetBuilder, JDims), _net(TNetBuilder, TDims)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    x = np.random.RandomState(7).randn(*jp.nodes["data"].dims.shape).astype(np.float32)
    je = jmake("conv_fwd", "pallas", kernel_policy="gen", fuse_block="1",
               tune=jparse(_TUNE))
    je.init(jp)
    return dict(jp=jp, tp=tp, x=x, je=je)


def _port(net, **kw):
    kw = {"fuse_block": "1", "tune": tparse(_TUNE), **kw}
    te = tmake("conv_fwd", "cuda", device="cpu", **kw)
    te.init(net["tp"])
    return te


def _run(eng, net, nodes):
    """One forward of either package's engine on the seeded input."""
    if eng.__module__.startswith("boda_tpu_torch"):
        x = TNDA(net["tp"].nodes["data"].dims, net["x"])
    else:
        x = JNDA(net["jp"].nodes["data"].dims, net["x"])
    return eng.run_fwd({"data": x}, nodes)


def _check(want, got, nodes):
    for n in nodes:
        a, b = want[n].data, got[n].data
        assert a.shape == b.shape, n
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
        assert r.num_diff == 0, f"node {n}: {r}"


@pytest.fixture
def block_calls(monkeypatch):
    """Counts the port's bottleneck runs on the CPU (its plain version)."""
    calls = []
    plain = tblock.bottleneck_plain
    monkeypatch.setattr(tblock, "bottleneck_plain",
                        lambda *a, **k: calls.append(a[0].shape) or plain(*a, **k))
    return calls


def test_fused_engine_matches_boda_tpu(nets, block_calls):
    te = _port(nets)
    got = _run(te, nets, _NODES)
    want = _run(nets["je"], nets, _NODES)
    _check(want, got, _NODES)
    assert block_calls == [(2, 8, 8, 128)]
    for log in (nets["je"].get_info_log(), te.get_info_log()):
        assert "res2b_branch2a: block-fused bottleneck (+res2b_branch2b,res2b_branch2c)" in log
        assert "conv1: nhwc-s2d_conv s=(2, 2)" in log
        assert "pool1: nhwc-pool_pallas k=(3, 3) s=(2, 2) avg=False" in log
        assert "pool5: nhwc-pool_pallas k=(8, 8) s=(1, 1) avg=True" in log
    assert te._blocks.keys() == nets["je"]._blocks.keys() == {"res2b_branch2a"}
    assert te._chains == nets["je"]._chains


def test_requested_intermediate_unfuses_the_block(nets, block_calls):
    """Asking for a value inside the block runs it unfused for that call
    (B and C still fuse on their own chains); every node still matches."""
    nodes = ["res2b_branch2a_relu", "res2b_branch2b_relu", "res2b_relu", "prob"]
    te = _port(nets)
    _check(_run(nets["je"], nets, nodes), _run(te, nets, nodes), nodes)
    assert block_calls == []
    _run(te, nets, ["prob"])  # the next call fuses again
    assert len(block_calls) == 1


def test_lib_policy_fuses_blocks_too(nets, block_calls):
    """Under kernel_policy=lib the convs run on the library, their weights
    in its OHWI layout, and the block kernel still runs (as in boda_tpu,
    executor.py:527-529) on the weights turned to HWIO."""
    te = _port(nets, kernel_policy="lib")
    got = _run(te, nets, _NODES)
    _check(_run(nets["je"], nets, _NODES), got, _NODES)
    assert block_calls == [(2, 8, 8, 128)]
    assert "nhwc-lib_conv" in te.get_info_log()


def test_no_block_fusion_in_a_backward_graph(nets):
    pipe = _net(TNetBuilder, TDims)
    add_bck_ops(pipe)
    te = tmake("conv_fwd", "cuda", device="cpu", fuse_block="1", tune=tparse(_TUNE))
    te.init(pipe)
    assert te._blocks == {} and "block-fused" not in te.get_info_log()


def test_resnet50_finds_the_same_12_blocks():
    jp, _ = jbuild("resnet50", img=1)
    tp, _ = tbuild("resnet50", img=1)
    je = jmake("conv_fwd", "pallas", fuse_block="1", compute_tn="bfloat16")
    je.init(jp)
    te = tmake("conv_fwd", "cuda", device="cpu", fuse_block="1", compute_tn="bfloat16")
    te.init(tp)
    assert len(te._blocks) == 12
    assert te._blocks == je._blocks
    assert te._chains == je._chains


def test_run_cnet_fused_cli():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run_cnet", "--model=mini_resnet",
                       f"--conv-fwd=(mode=cuda,device=cpu,fuse_block=1,tune={_TUNE})"])
    out = buf.getvalue()
    assert rc == 0 and "out prob dims=(img=1,chan=16)" in out
    # mini_resnet has no 1x1 bottleneck; its strided 3x3s take the fold
    assert "s2b0_c1: nhwc-s2d_conv" in out and "gap: nhwc-pool_pallas" in out
