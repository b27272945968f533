"""Caffe nets through the port's engine against boda_tpu's NHWC engine, on the
CPU: the trained testdata nets (shapesnet, shapesnet2, shapesnet3 with their
caffemodels) and tinynet (seeded weights; it holds the LRN), read by each
package's own frontend, every node under gen, lib and the fused tune; LRN
and Concat alone in f32 and bf16; and GoogLeNet's gradient graph
(testdata/test_all.xml:15: googlenet_conv, in_sz 96, add_bck_ops).

boda_tpu runs its ``pallas`` engine under ``kernel_policy=gen`` (Pallas in
interpret mode, as its own tests run it); the port its ``cuda`` engine with
``device=cpu``, where every kernel wrapper takes its plain version. Gates:
f32, every node comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|) with no
element over (boda_tpu's cross-engine bar), and the same top-1; bf16, every
node within 2e-2 of max|ref| (the two engines round each op's output to
bf16 at the same points, but their f32 sums differ in order, so an element
may round one bf16 ulp, 2^-8, apart, and LRN's output takes that from its
input and from its scale); the gradient graph under test_compute's 1e-3."""

import os

import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
from boda_tpu.graph.autodiff import add_bck_ops as j_add_bck_ops
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt as tfrom
from boda_tpu_torch.graph.autodiff import add_bck_ops as t_add_bck_ops
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu_torch.utils.lexp import parse_lexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "testdata", "nets")
_TRAINED = ("shapesnet", "shapesnet2", "shapesnet3")
_POLICIES = {"gen": {}, "lib": {"kernel_policy": "lib"},
             "fused": {"fuse_block": True, "tune": parse_lexp("(use_s2d=1,pool_pallas=1)")}}
BF16_TOL = 2e-2


def _nodes(pipe):
    """test_compute's node set: every computed node that is not a weight."""
    return [n for n, node in pipe.nodes.items()
            if node.dims is not None and n not in pipe.weights and node.top_for]


def _gate(jr, tr, nodes, mrd=1e-5):
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert a.shape == b.shape, n
        r = comp_vars(a, b, mrd_toler=mrd, atol=mrd * float(np.abs(a).max()))
        assert r.ok() and r.num_diff == 0, f"node {n}: {r}"


@pytest.fixture(scope="module")
def caffe_nets():
    """name -> both pipes (each package's frontend), the seeded input and
    boda_tpu's run of every node."""
    out = {}
    for name in _TRAINED + ("tinynet",):
        ptt = os.path.join(NETS, f"{name}.prototxt")
        cm = os.path.join(NETS, f"{name}.caffemodel") if name in _TRAINED else ""
        (jp, jd), (tp, td) = jfrom(ptt, cm), tfrom(ptt, cm)
        d = jd["data"]
        x = np.random.RandomState(len(name)).rand(*d.shape).astype(np.float32)
        je = jmake("conv_fwd", "pallas", kernel_policy="gen")
        je.init(jp)
        nodes = _nodes(jp)
        out[name] = dict(tp=tp, td=td, x=x, nodes=nodes,
                         jr=je.run_fwd({"data": JNDA(d, x)}, nodes))
    return out


@pytest.mark.parametrize("name", _TRAINED + ("tinynet",))
def test_caffe_net_matches_boda_tpu(caffe_nets, name):
    net = caffe_nets[name]
    for policy, kw in sorted(_POLICIES.items()):
        te = tmake("conv_fwd", "cuda", device="cpu", **kw)
        te.init(net["tp"])
        tr = te.run_fwd({"data": TNDA(net["td"]["data"], net["x"])}, net["nodes"])
        _gate(net["jr"], tr, net["nodes"])
        prob = [o.tops[-1] for o in net["tp"].ops.values() if o.type == "Softmax"][-1]
        assert np.array_equal(np.argmax(net["jr"][prob].data.reshape(len(net["x"]), -1), 1),
                              np.argmax(tr[prob].data.reshape(len(net["x"]), -1), 1)), policy
        if policy == "fused":  # the pools on the pooling kernel
            assert "nhwc-pool_pallas" in te.get_info_log()


def _lrn_concat_net(NetBuilder, Dims, beta):
    """conv -> LRN -> four branches (1x1, 3x3, 5x5, pool+1x1) -> Concat ->
    LRN -> a fire-style two-branch Concat -> avg pool -> fc."""
    b = NetBuilder("lrncat")
    t = b.input("data")
    t = b.conv("conv1", t, 24, 3, pad=1, in_chans=3, relu=True)
    t = b.lrn("norm1", t, beta=beta)
    p1 = b.conv("b1", t, 16, 1, in_chans=24, relu=True)
    p2 = b.conv("b3", t, 24, 3, pad=1, in_chans=24, relu=True)
    p3 = b.conv("b5", t, 8, 5, pad=2, in_chans=24, relu=True)
    p4 = b.pool("bp", t, kern=3, stride=1, pad=1)
    p4 = b.conv("bp_proj", p4, 8, 1, in_chans=24, relu=True)
    t = b.concat("cat1", [p1, p2, p3, p4])
    t = b.lrn("norm2", t, local_size=3, alpha=1e-2, beta=beta)
    s = b.conv("sq", t, 16, 1, in_chans=56, relu=True)
    e1 = b.conv("e1", s, 32, 1, in_chans=16, relu=True)
    e3 = b.conv("e3", s, 32, 3, pad=1, in_chans=16, relu=True)
    t = b.concat("cat2", [e1, e3])
    t = b.pool("gap", t, avg=True, global_pool=True)
    t = b.fc("fc", t, 10, in_feats=64)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=2, chan=3, y=12, x=12)}
    return b.done(in_dims), in_dims


@pytest.mark.parametrize("compute_tn", ["", "bfloat16"])
def test_lrn_concat_match_boda_tpu(compute_tn):
    """LRN in each of boda_tpu's forms (beta 0.75 and 0.5 by roots, else
    pow) and Concat of four and of two branches, every node."""
    for beta in (0.75, 0.5, 1.0):
        _lrn_concat_case(beta, compute_tn)


def _lrn_concat_case(beta, compute_tn):
    (jp, jd), (tp, td) = (_lrn_concat_net(JNetBuilder, JDims, beta),
                          _lrn_concat_net(TNetBuilder, TDims, beta))
    d = jd["data"]
    x = np.random.RandomState(5).randn(*d.shape).astype(np.float32) * 3
    nodes = _nodes(jp)
    je = jmake("conv_fwd", "pallas", kernel_policy="gen", compute_tn=compute_tn)
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(d, x)}, nodes)
    te = tmake("conv_fwd", "cuda", device="cpu", compute_tn=compute_tn)
    te.init(tp)
    tr = te.run_fwd({"data": TNDA(td["data"], x)}, nodes)
    assert tr["cat1"].data.shape == (2, 56, 12, 12) and tr["cat2"].data.shape == (2, 64, 12, 12)
    if not compute_tn:
        _gate(jr, tr, nodes)
        return
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        err = float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)
        assert err <= BF16_TOL, f"beta {beta} node {n}: {err:.3g}"


def test_googlenet_grad_matches_boda_tpu():
    """testdata/test_all.xml:15's gradient config (googlenet_conv, b1, 96x96,
    add_bck_ops) through both packages, weights carried: the loss, the
    input gradient and every weight gradient under test_compute's 1e-3, on
    the port's gen (the hand backward kernels' plain versions) and lib."""
    (jp, jd), (tp, td) = (jbuild("googlenet_conv", img=1, in_sz=96),
                          tbuild("googlenet_conv", img=1, in_sz=96))
    # logits in a range where the loss passes a gradient
    for p in (jp, tp):
        p.weights["loss3/classifier__filts"].data *= np.float32(0.05)
    j_add_bck_ops(jp)
    t_add_bck_ops(tp)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    d = jd["data"]
    x = np.random.RandomState(9).randn(*d.shape).astype(np.float32)
    lab = np.array([3.0], np.float32)
    grads = ["prob_loss", "data__grad__p0"] + [
        n for n in jp.nodes if jp.nodes[n].dims is not None
        and any(n.startswith(w + "__grad") for w in jp.weights)]
    je = jmake("conv_fwd", "xla")
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(d, x), "label": JNDA(JDims.of(img=1), lab)}, grads)
    assert float(np.abs(jr["data__grad__p0"].data).max()) > 0
    for policy in ("gen", "lib"):
        te = tmake("conv_fwd", "cuda", device="cpu", kernel_policy=policy)
        te.init(tp)
        tr = te.run_fwd({"data": TNDA(td["data"], x), "label": TNDA(TDims.of(img=1), lab)},
                        grads)
        _gate(jr, tr, grads, mrd=1e-3)
