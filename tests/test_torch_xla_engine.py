"""The port's ``xla`` engine (graph/lowering.py's logical-layout rules and
graph/ssd_ops.py's six) against boda_tpu's ``xla`` engine, on the CPU: the
same seeded numpy inputs and the same weights (the zoo's are bit-identical
across the packages; the Caffe nets are read by each package's frontend),
every node compared with boda_tpu's ``comp_vars``.

Gates: f32, every node within mrd 1e-5 and atol 1e-5 * max|ref| with no
element over; bf16, every node within 2e-2 of max|ref| (both engines
round each op's output to bf16 at the same points, but their f32 sums run
in other orders, so an element may round one bf16 ulp, 2^-8, apart and
carry it to the next op); gradient graphs (``add_bck_ops``) within
test_compute's 1e-3. The explicit backward ops and the remaining rules run
in hand-built graphs under ``train=1``, Dropout with boda_tpu's own
``jax.random`` mask injected through ``lowering_nhwc.DROPOUT_MASK_HOOK``.
The mesh: (dp=2), (dp=2,tp=4) and (tp=8) on the CPU's logical devices
against no mesh."""

import os

import jax
import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
from boda_tpu.graph.autodiff import add_bck_ops as j_add_bck_ops
from boda_tpu.graph.pipe import ConvOp as JOp
from boda_tpu.graph.pipe import ConvPipe as JPipe
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt as tfrom
from boda_tpu_torch.graph import lowering, lowering_nhwc
from boda_tpu_torch.graph.autodiff import add_bck_ops as t_add_bck_ops
from boda_tpu_torch.graph.pipe import ConvOp as TOp
from boda_tpu_torch.graph.pipe import ConvPipe as TPipe
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "testdata", "nets")
BF16_TOL = 2e-2
GRAD_TOL = 1e-3
# the nets: tinynet (LRN, pools), mini_resnet (BN/Scale, Eltwise, avg
# pool), a small googlenet_conv (LRN, Concat, ceil-mode pools), tinyssd
# (the six SSD rules)
NETS_ = {"tinynet": "tinynet.prototxt", "mini_resnet": dict(img=2),
         "googlenet_conv": dict(img=1, in_sz=64), "tinyssd": "tinyssd.prototxt"}


def build_pair(name, bck=False):
    """(boda_tpu pipe, its dims, port pipe, its dims) of a zoo net or a
    Caffe net of testdata/nets, with the gradient ops if asked."""
    spec = NETS_.get(name, name)
    if isinstance(spec, str):
        fn = os.path.join(NETS, spec)
        (jp, jd), (tp, td) = jfrom(fn, ""), tfrom(fn, "")
    else:
        (jp, jd), (tp, td) = jbuild(name, **spec), tbuild(name, **spec)
    if bck:
        j_add_bck_ops(jp)
        t_add_bck_ops(tp)
        for bn in jp.bots():
            if bn not in jd and jp.nodes[bn].dims is not None:
                jd[bn], td[bn] = jp.nodes[bn].dims, tp.nodes[bn].dims
    return jp, jd, tp, td


def seeded_inputs(dims, seed=0):
    rng = np.random.RandomState(seed)
    return {k: ((np.arange(d.shape[0]) % 5).reshape(d.shape).astype(np.float32)
                if k == "label" else rng.randn(*d.shape).astype(np.float32))
            for k, d in dims.items()}


def nodes_of(pipe):
    """test_compute's node set: every computed node that is not a weight."""
    return [n for n, node in pipe.nodes.items()
            if node.dims is not None and n not in pipe.weights and node.top_for]


def run_both(jp, jd, tp, td, mode, ins, nodes, jkw=None, tkw=None):
    je = jmake("conv_fwd", mode, **(jkw or {}))
    je.init(jp)
    jr = je.run_fwd({k: JNDA(jd[k], v) for k, v in ins.items()}, nodes)
    te = tmake("conv_fwd", mode, platform="cpu", **(tkw if tkw is not None else jkw or {}))
    te.init(tp)
    tr = te.run_fwd({k: TNDA(td[k], v) for k, v in ins.items()}, nodes)
    return je, jr, te, tr


def gate(jr, tr, nodes, tol=1e-5, exact_count=True):
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert a.shape == b.shape, n
        r = comp_vars(a, b, mrd_toler=tol, atol=tol * float(np.abs(a).max()))
        assert r.ok() and (r.num_diff == 0 or not exact_count), f"node {n}: {r}"


def bf16_gate(jr, tr, nodes):
    for n in nodes:
        a, b = jr[n].data.astype(np.float64), tr[n].data
        scale = max(float(np.abs(a).max()), 1e-30)
        assert float(np.abs(a - b).max()) <= BF16_TOL * scale, n


@pytest.mark.parametrize("name", sorted(NETS_))
def test_logical_rules_match_boda_tpu(name):
    """Every node of the xla engine in f32; in bf16 too for the zoo nets."""
    jp, jd, tp, td = build_pair(name)
    nodes, ins = nodes_of(jp), seeded_inputs(jd)
    _, jr, te, tr = run_both(jp, jd, tp, td, "xla", ins, nodes)
    gate(jr, tr, nodes)
    assert not te._weight_preps and te.get_info_log() == ""  # no rewrite, no route
    if name in ("mini_resnet", "googlenet_conv"):
        _, jr, _, tr = run_both(jp, jd, tp, td, "xla", ins, nodes,
                                {"compute_tn": "bfloat16"})
        bf16_gate(jr, tr, nodes)


def test_gradient_graphs_match_boda_tpu():
    """add_bck_ops graphs of mini_resnet, tinynet and googlenet_conv: every
    forward and gradient node against boda_tpu's xla engine, gradients in
    the logical layout (test_all.xml's gradient suites' 1e-3)."""
    for name in ("mini_resnet", "tinynet", "googlenet_conv"):
        jp, jd, tp, td = build_pair(name, bck=True)
        nodes = nodes_of(jp)
        _, jr, _, tr = run_both(jp, jd, tp, td, "xla", seeded_inputs(jd), nodes)
        gate(jr, tr, nodes, GRAD_TOL, exact_count=False)
        assert any(n.endswith("__filts__grad__p0") for n in nodes)


def _explicit_pipe(Pipe, Op, Dims, NDA):
    """The rules no zoo net reaches: Deconvolution (grouped, strided),
    Sigmoid, TanH, Dropout in training, Eltwise prod, max and sum with
    coeffs, Reduce, Accuracy, SoftmaxWithLoss, and the explicit backward
    ops Spreading (max and avg), ZeroIfNonPos, BckLRN and BckDropout; the
    weights seeded."""
    p = Pipe("explicit")
    rng = np.random.RandomState(3)
    for name, dims in (("dc__filts", Dims.of(out_chan=4, in_chan=2, y=4, x=4)),
                       ("dc__biases", Dims.of(out_chan=4)),
                       ("fc__filts", Dims.of(out_chan=6, in_feats=144)),
                       ("fc__biases", Dims.of(out_chan=6))):
        p.weights[name] = NDA(dims, (rng.randn(*dims.shape) * 0.3).astype(np.float32))
    ops = [
        ("dc", "Deconvolution", {"kern_sz": (4, 4), "stride": (2, 2), "pad": (1, 1),
                                 "groups": 2}, ["x", "dc__filts", "dc__biases"]),
        ("sg", "Sigmoid", {}, ["dc"]), ("th", "TanH", {}, ["dc"]),
        ("drop1", "Dropout", {"dropout_ratio": 0.3}, ["th"]),
        ("pr", "Eltwise", {"eltwise_op": "prod"}, ["sg", "drop1"]),
        ("mx", "Eltwise", {"eltwise_op": "max"}, ["sg", "drop1"]),
        ("cf", "Eltwise", {"eltwise_op": "sum", "coeffs": [0.5, -2.0]}, ["pr", "mx"]),
        ("rd", "Reduce", {}, ["pr", "mx", "cf"]),
        ("pool", "Pooling", {"kern_sz": (3, 3), "stride": (2, 2), "pad": (0, 0)}, ["rd"]),
        ("sp", "Spreading", {"kern_sz": (3, 3), "stride": (2, 2), "pad": (0, 0)},
         ["pool", "og", "rd"]),
        ("apool", "Pooling", {"kern_sz": (3, 3), "stride": (2, 2), "pad": (1, 1),
                              "avg_pool": True}, ["rd"]),
        ("asp", "Spreading", {"kern_sz": (3, 3), "stride": (2, 2), "pad": (1, 1),
                              "avg_pool": True}, ["apool", "ag", "rd"]),
        ("zn", "ZeroIfNonPos", {}, ["sp", "cf"]),
        ("lrn", "LRN", {"local_size": 3, "alpha": 0.5, "beta": 0.75}, ["rd"]),
        ("blrn", "BckLRN", {"local_size": 3, "alpha": 0.5, "beta": 0.75},
         ["rd", "lrn", "sp"]),
        ("drop1__bck", "BckDropout", {"dropout_ratio": 0.3}, ["zn"]),
        ("fc", "InnerProduct", {}, ["pool", "fc__filts", "fc__biases"]),
        ("acc", "Accuracy", {"top_k": 2}, ["fc", "label"]),
        ("loss", "SoftmaxWithLoss", {}, ["fc", "label"]),
    ]
    for name, typ, params, bots in ops:
        tops = [name] if typ != "SoftmaxWithLoss" else ["loss", "loss_prob"]
        p.add_op(Op(name, typ, dict(params), list(bots), tops))
    dims = {"x": Dims.of(img=2, chan=4, y=6, x=6), "og": Dims.of(img=2, chan=4, y=6, x=6),
            "ag": Dims.of(img=2, chan=4, y=7, x=7), "label": Dims.of(img=2)}
    p.calc_dims(dict(dims))
    return p, dims


def test_explicit_backward_ops_match_boda_tpu():
    jp, jd = _explicit_pipe(JPipe, JOp, JDims, JNDA)
    tp, td = _explicit_pipe(TPipe, TOp, TDims, TNDA)
    ins = seeded_inputs(jd, seed=4)
    nodes = nodes_of(jp)
    seen = {}

    def hook(name, seed, shape, keep):
        seen[name] = seed
        return np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), keep, shape))
    old, lowering_nhwc.DROPOUT_MASK_HOOK = lowering_nhwc.DROPOUT_MASK_HOOK, hook
    try:
        _, jr, te, tr = run_both(jp, jd, tp, td, "xla", ins, nodes,
                                 {"train": True, "det_drop_seed": 7})
    finally:
        lowering_nhwc.DROPOUT_MASK_HOOK = old
    gate(jr, tr, nodes)
    assert set(seen) == {"drop1"}  # the backward draws the forward's mask
    assert 0 < tr["acc"].data.sum() <= 2 and tr["drop1"].data.std() > 0
    # a graph that runs autograd inside its forward runs under no_grad
    assert {o.type for o in tp.ops.values()} & set(lowering.AUTOGRAD_RULES)


def test_mesh_matches_no_mesh():
    """The xla engine's mesh on the CPU's logical devices: dp slices the
    img, tp splits every groups-1 conv's and the fc's out_chan (OIHW axis
    0, outputs gathered on NCHW's channel axis); every node as without a
    mesh, f32 to 1e-5 (a tp slice's conv sums in the same order; the
    library may block a smaller batch differently)."""
    tp, td = tbuild("mini_resnet", img=4)
    ins = {"data": TNDA(td["data"], seeded_inputs(td)["data"])}
    nodes = nodes_of(tp)
    ref = tmake("conv_fwd", "xla", platform="cpu")
    ref.init(tp)
    want = ref.run_fwd(ins, nodes)
    for mesh in ("(dp=2)", "(dp=2,tp=4)", "(tp=8)"):
        from boda_tpu_torch.utils.lexp import parse_lexp
        e = tmake("conv_fwd", "xla", platform="cpu", mesh=parse_lexp(mesh))
        e.init(tp)
        got = e.run_fwd(ins, nodes)
        gate(want, got, nodes, exact_count=False)
        if "tp" in mesh:
            assert "__tp__" in e._weights_dev and e._weights_dev["__tp__"].parts
