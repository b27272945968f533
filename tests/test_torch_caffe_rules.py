"""The last four Caffe rules against boda_tpu, on the CPU: Deconvolution
(strided, and grouped, each with its filters read from a caffemodel blob in
Caffe's (in_c, out_c/g, kh, kw) order), Sigmoid and TanH, each from a
prototxt read by each package's own frontend, and Reduce (an n-ary sum,
which no prototxt names: both packages build it as an op), every node of
the port's ``cuda`` engine (``device=cpu``) against boda_tpu's ``pallas``
engine. Gates: f32 comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|) with no
element over, as tests/test_torch_engine_caffe.py; bf16 every node within
5e-2 of max|ref| (each op rounds its output to bf16 once; sigmoid and tanh
compute in f32 inside both libraries)."""

import os

import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
from boda_tpu.graph.pipe import ConvOp as JConvOp
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.frontend import pipe_builder as tpb
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt as tfrom
from boda_tpu_torch.frontend.surgery import write_caffemodel
from boda_tpu_torch.graph.lowering_nhwc import _NHWC_RULES
from boda_tpu_torch.graph.pipe import ConvOp as TConvOp
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims

BF16_TOL = 5e-2
_HEAD = 'name: "{name}"\ninput: "data"\ninput_shape {{ dim: 2 dim: 4 dim: 7 dim: 7 }}\n'
_CONV = ('layer {{ name: "{n}" type: "{t}" bottom: "{b}" top: "{n}" convolution_param '
         '{{ num_output: {o} kernel_size: {k} stride: {s} pad: {p} group: {g} }} }}\n')
# name -> layers after the input (4 channels, 7x7)
_NETS = {
    "deconv_s2": _CONV.format(n="up", t="Deconvolution", b="data", o=6, k=4, s=2, p=1, g=1)
    + 'layer { name: "up_relu" type: "ReLU" bottom: "up" top: "up" }\n'
    + _CONV.format(n="up2", t="Deconvolution", b="up", o=3, k=3, s=3, p=0, g=1),
    "deconv_grouped": _CONV.format(n="c1", t="Convolution", b="data", o=8, k=3, s=1, p=1, g=1)
    + _CONV.format(n="up", t="Deconvolution", b="c1", o=6, k=3, s=1, p=1, g=2)
    + _CONV.format(n="up2", t="Deconvolution", b="up", o=4, k=2, s=2, p=0, g=2),
    "sigmoid_tanh": _CONV.format(n="c1", t="Convolution", b="data", o=8, k=3, s=1, p=1, g=1)
    + 'layer { name: "sig" type: "Sigmoid" bottom: "c1" top: "sig" }\n'
    + _CONV.format(n="c2", t="Convolution", b="sig", o=5, k=3, s=2, p=0, g=1)
    + 'layer { name: "th" type: "TanH" bottom: "c2" top: "th" }\n',
}


def _nodes(pipe):
    return [n for n, node in pipe.nodes.items()
            if node.dims is not None and n not in pipe.weights and node.top_for]


def _prototxt(tmp_path, name):
    """The net's prototxt, and a caffemodel for it written from the port's
    seeded weights, so that a Deconvolution's filters are read from a blob
    (in_c != out_c: a flat reshape would scramble them)."""
    fn = tmp_path / f"{name}.prototxt"
    fn.write_text(_HEAD.format(name=name) + _NETS[name])
    cm = tmp_path / f"{name}.caffemodel"
    write_caffemodel(str(cm), tfrom(str(fn))[0])
    return str(fn), str(cm)


def _reduce_net(NetBuilder, Dims, ConvOp):
    b = NetBuilder("reduce3")
    t = b.input("data")
    a = b.conv("a", t, 6, 3, pad=1, in_chans=4)
    c = b.conv("c", t, 6, 1, in_chans=4, relu=True)
    d = b.conv("d", t, 6, 3, pad=1, in_chans=4)
    b.pipe.add_op(ConvOp("red", "Reduce", {}, bots=[a, c, d], tops=["red"]))
    b.relu("red_relu", "red")
    in_dims = {"data": Dims.of(img=2, chan=4, y=7, x=7)}
    return b.done(in_dims), in_dims


def _compare(jpair, tpair, compute_tn):
    (jp, jd), (tp, td) = jpair, tpair
    d = jd["data"]
    x = np.random.RandomState(3).randn(*d.shape).astype(np.float32) * 2
    nodes = _nodes(jp)
    je = jmake("conv_fwd", "pallas", kernel_policy="gen", compute_tn=compute_tn)
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(d, x)}, nodes)
    te = tmake("conv_fwd", "cuda", device="cpu", compute_tn=compute_tn)
    te.init(tp)
    tr = te.run_fwd({"data": TNDA(td["data"], x)}, nodes)
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert a.shape == b.shape, n
        if compute_tn:
            err = float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)
            assert err <= BF16_TOL, f"node {n}: {err:.3g}"
        else:
            r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
            assert r.ok() and r.num_diff == 0, f"node {n}: {r}"
    return tr


@pytest.mark.parametrize("name", sorted(_NETS))
def test_rule_matches_boda_tpu(tmp_path, name):
    """Each net, read with its caffemodel, every node in f32 and bf16; the
    shapes are Caffe's (a deconv's (i - 1) * s + k - 2p)."""
    ptt, cm = _prototxt(tmp_path, name)
    for ctn in ("", "bfloat16"):
        tr = _compare(jfrom(ptt, cm), tfrom(ptt, cm), ctn)
    if name == "deconv_s2":
        assert tr["up"].data.shape == (2, 6, 14, 14) and tr["up2"].data.shape == (2, 3, 42, 42)


def test_reduce_matches_boda_tpu():
    """Reduce of three inputs, summed in input order, then ReLU."""
    for ctn in ("", "bfloat16"):
        _compare(_reduce_net(JNetBuilder, JDims, JConvOp),
                 _reduce_net(TNetBuilder, TDims, TConvOp), ctn)


def test_frontend_reads_the_rules_as_boda_tpu(tmp_path):
    """Both frontends give the same ops and weights for the three prototxts
    with their caffemodels (the deconv blob transposed on load; a grouped
    blob of the filters' size read as it is, as boda_tpu reads it), raise the
    same error for a deconv blob of the wrong size, and the port has an op
    rule and an NHWC rule for every layer type its frontend reads, the SSD
    head's included."""
    for name in sorted(_NETS):
        ptt, cm = _prototxt(tmp_path, name)
        (jp, _), (tp, _) = jfrom(ptt, cm), tfrom(ptt, cm)
        assert [(o.type, o.params, o.bots, o.tops) for o in jp.ops.values()] == \
            [(o.type, o.params, o.bots, o.tops) for o in tp.ops.values()]
        assert sorted(jp.weights) == sorted(tp.weights)
        for k, w in jp.weights.items():
            assert np.array_equal(w.data, tp.weights[k].data), (name, k)
    shaper = tpb._deconv_winit_shaper(TDims.of(out_chan=6, in_chan=4, y=3, x=3), 4, 1, 36)
    with pytest.raises(tpb.FrontendError, match="deconv blob size 10 != expected 4x6x3x3"):
        shaper(np.zeros(10, np.float32))
    assert not hasattr(tpb, "NOT_PORTED")
    for ltype in ("Permute", "Flatten", "Reshape", "Normalize", "PriorBox",
                  "DetectionOutput", "Deconvolution", "Sigmoid", "TanH"):
        assert ltype in tpb.OP_INFOS and ltype in _NHWC_RULES, ltype
