"""The port's backward graphs against boda_tpu's, node by node, on the CPU.

add_bck_ops builds the same graph in both packages. boda_tpu runs it on its
``pallas`` engine under ``kernel_policy=gen`` (the explicit Pallas backward
conv in interpret mode, the vjp of the XLA lowering elsewhere); the port
runs it on its ``cuda`` engine with ``device=cpu``, under ``gen`` (the hand
backward kernels' plain versions for every eligible conv, autograd
elsewhere) and under ``lib`` (autograd everywhere). Weights are carried from
boda_tpu's pipe; inputs and labels are numpy from a seed. Gate on every
node, forward and gradient: comp_vars(mrd_toler=1e-4, atol=1e-5 *
max|ref|), the bar of boda_tpu's own graph-autodiff tests
(tests/test_autodiff.py).
"""

import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.graph.autodiff import add_bck_ops as j_add_bck_ops
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.autodiff import add_bck_ops as t_add_bck_ops
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims


def _bk_net(NetBuilder, Dims):
    """boda_tpu's test_pallas_bck_conv_kernels_selected_and_match net."""
    b = NetBuilder("bk")
    t = b.input("data")
    t = b.conv("conv1", t, 32, 3, pad=1, in_chans=64)
    t = b.relu("r1", t)
    t = b.conv("conv2", t, 16, 1, in_chans=32)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=2, chan=64, y=8, x=8)}
    return b.done(in_dims), in_dims


_NETS = {
    "mini_resnet": (lambda: jbuild("mini_resnet", img=2, in_sz=8),
                    lambda: tbuild("mini_resnet", img=2, in_sz=8)),
    "bconv_strides": (lambda: jbuild("bconv_strides", img=2),
                      lambda: tbuild("bconv_strides", img=2)),
    "bk": (lambda: _bk_net(JNetBuilder, JDims), lambda: _bk_net(TNetBuilder, TDims)),
}


def _check_nodes(pipe):
    """test_compute's node set: every computed node that is not a weight."""
    return [n for n, node in pipe.nodes.items()
            if node.dims is not None and n not in pipe.weights and node.top_for]


def _ops_logged(info_log: str, tag: str) -> set:
    return {ln.split(":")[0] for ln in info_log.splitlines() if f": {tag}" in ln}


@pytest.fixture(scope="module", params=sorted(_NETS))
def net(request):
    """Both pipes with backward ops (weights carried), the seeded inputs and
    boda_tpu's run of every node."""
    jb, tb = _NETS[request.param]
    (jp, jd), (tp, td) = jb(), tb()
    j_add_bck_ops(jp)
    t_add_bck_ops(tp)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    d = jd["data"]
    rng = np.random.RandomState(len(request.param))
    x = rng.randn(*d.shape).astype(np.float32)
    labels = rng.randint(0, 4, size=d["img"]).astype(np.float32)
    labels[-1] = 1000.0  # past the last class: both packages clip it
    nodes = _check_nodes(jp)
    je = jmake("conv_fwd", "pallas", kernel_policy="gen")
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(d, x), "label": JNDA(JDims.of(img=d["img"]), labels)},
                    nodes)
    # a saturated softmax would pass no gradient: every gradient node carries one
    dead = [n for n in nodes if "__grad" in n and not np.abs(jr[n].data).max() > 0]
    assert not dead, dead
    return dict(name=request.param, jp=jp, tp=tp, td=td, x=x, labels=labels,
                nodes=nodes, jr=jr, jlog=je.get_info_log())


@pytest.mark.parametrize("policy", ["gen", "lib"])
def test_bck_graph_matches_boda_tpu(net, policy):
    tp, td = net["tp"], net["td"]
    assert _check_nodes(tp) == net["nodes"]
    te = tmake("conv_fwd", "cuda", device="cpu", kernel_policy=policy)
    te.init(tp)
    d = td["data"]
    tr = te.run_fwd({"data": TNDA(d, net["x"]),
                     "label": TNDA(TDims.of(img=d["img"]), net["labels"])},
                    net["nodes"])
    for n in net["nodes"]:
        a, b = net["jr"][n].data, tr[n].data
        assert a.shape == b.shape == tp.must_dims(n).shape, n
        r = comp_vars(a, b, mrd_toler=1e-4, atol=1e-5 * float(np.abs(a).max()))
        assert r.ok(), f"{net['name']} {policy} node {n}: {r}"
    # the backward-conv route: boda_tpu takes it where its Mosaic block plan
    # fits; the port under gen takes it on every eligible conv, under lib on
    # none
    eligible = {f"{o.name}__bck" for o in tp.ops.values()
                if o.type == "Convolution" and o.stride() == (1, 1)}
    jsel = _ops_logged(net["jlog"], "pallas-bck-conv")
    tsel = _ops_logged(te.get_info_log(), "bck-conv")
    if policy == "gen":
        assert tsel == eligible and jsel <= tsel
        assert bool(jsel) == (net["name"] != "bconv_strides")
    else:
        assert not tsel
