"""The port's forward slice against boda_tpu's, node by node, on the CPU.

boda_tpu runs its ``pallas`` engine under ``kernel_policy=gen`` (Pallas in
interpret mode, as its own tests run it); the port runs its ``cuda`` engine
with ``device=cpu``, where every kernel wrapper takes its plain PyTorch
version. Weights are carried from boda_tpu's pipe with weights_from_numpy,
inputs are numpy from a seed. Gate per node, f32: comp_vars(mrd_toler=1e-5,
atol=1e-5 * max|ref|) with num_diff == 0 (the JAX package's own cross-engine
bar; the atol absorbs summation-order noise on near-zero elements).
"""

import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA

_NETS = {"mini_resnet": {}, "resnet50": {"img": 1, "in_sz": 64}}


def _nodes(pipe, types):
    return [o.tops[0] for o in pipe.ops.values() if o.type in types]


@pytest.fixture(scope="module")
def nets():
    """name -> dict: both pipes (weights carried), the seeded input, and
    boda_tpu's run of every conv/pool/fc node and prob (one interpret-mode
    run per net serves every test: a node's value does not depend on which
    other nodes are requested)."""
    out = {}
    for name, kw in _NETS.items():
        jp, jd = jbuild(name, **kw)
        tp, td = tbuild(name, **kw)
        weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
        d = jd["data"]
        x = np.random.RandomState(len(name)).randn(*d.shape).astype(np.float32)
        je = jmake("conv_fwd", "pallas", kernel_policy="gen")
        je.init(jp)
        every = ["prob"] + _nodes(jp, ("Convolution", "Pooling", "InnerProduct"))
        jr = je.run_fwd({"data": JNDA(d, x)}, every)
        out[name] = dict(jp=jp, tp=tp, in_dims=td, x=x, je=je, jr=jr)
    return out


def _port(net, outs, **kw):
    te = tmake("conv_fwd", "cuda", device="cpu", **kw)
    te.init(net["tp"])
    return te.run_fwd({"data": TNDA(net["in_dims"]["data"], net["x"])}, outs), te


def _check(jr, tr, nodes):
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert tr[n].dims.shape == jr[n].dims.shape == a.shape == b.shape, n
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
        assert r.num_diff == 0, f"node {n}: {r}"


def _dispatch(info_log: str) -> dict[str, set]:
    """op name -> the conv/fc variants an engine's info log names for it."""
    out: dict[str, set] = {}
    for line in info_log.splitlines():
        name, _, rest = line.partition(": ")
        kind = rest.split(" ")[0]
        if kind.startswith("nhwc-"):
            out.setdefault(kind[5:], set()).add(name)
    return out


@pytest.mark.parametrize("name", sorted(_NETS))
def test_slice_fused_matches(nets, name):
    """Chains fused (no intermediate requested): pools, fc and prob."""
    net = nets[name]
    nodes = ["prob"] + _nodes(net["jp"], ("Pooling", "InnerProduct"))
    tr, te = _port(net, nodes)
    assert te._fn_key == tuple(nodes)
    _check(net["jr"], tr, nodes)
    probs = tr["prob"].data
    assert np.all(np.isfinite(probs))
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    # the dispatch: the port's GEMM takes exactly boda_tpu's k1conv convs;
    # its direct conv takes every other conv, including the strided and
    # stem convs boda_tpu leaves to XLA; nothing goes to the library
    je = net["je"]
    jd, td = _dispatch(je.get_info_log()), _dispatch(te.get_info_log())
    assert td["k1conv"] == jd["k1conv"] and td["k1conv"]
    assert td["direct_conv"] == jd["pallas_conv"] | jd.get("xla_conv", set())
    assert "lib_conv" not in td
    assert td["ip"] == jd["ip"]
    assert len(te._chains) == len(je._chains)
    assert te._chains == je._chains


@pytest.mark.parametrize("name", sorted(_NETS))
def test_slice_every_conv_matches(nets, name):
    """Every conv output requested: chains unfused for this call."""
    net = nets[name]
    nodes = ["prob"] + _nodes(net["jp"], ("Convolution",))
    tr, _ = _port(net, nodes)
    _check(net["jr"], tr, nodes)


def test_requested_intermediate_unfuses_its_chain(nets):
    """A branch2c-style conv output (mid-chain: conv -> eltwise -> relu) is
    still right when requested alone: its chain runs unfused for this call
    while the other chains stay fused."""
    net = nets["mini_resnet"]
    tr, te = _port(net, ["s2b1_c2", "prob"])
    assert te._chains["s2b1_c2"][-2:] == ["s2b1", "s2b1_relu"]
    _check(net["jr"], tr, ["s2b1_c2", "prob"])


def test_lib_policy_matches_gen(nets):
    net = nets["mini_resnet"]
    res = {}
    for pol in ("gen", "lib"):
        res[pol], te = _port(net, ["prob", "fc"], kernel_policy=pol)
        if pol == "lib":
            kinds = _dispatch(te.get_info_log())
            assert "k1conv" not in kinds and "direct_conv" not in kinds
            assert kinds["lib_conv"]
    for n in ("prob", "fc"):
        a = res["gen"][n].data
        r = comp_vars(a, res["lib"][n].data, mrd_toler=1e-5,
                      atol=1e-5 * float(np.abs(a).max()))
        assert r.num_diff == 0, f"{n}: {r}"


def test_prefold_off_matches_on(nets):
    net = nets["mini_resnet"]
    res = []
    for pf in (True, False):
        out, te = _port(net, ["prob"], prefold=pf)
        assert bool(te._prefold_plan) == pf
        res.append(out["prob"].data)
    np.testing.assert_allclose(res[0], res[1], rtol=1e-5, atol=1e-7)
