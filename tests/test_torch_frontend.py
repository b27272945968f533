"""The port's Caffe frontend against boda_tpu's, on the CPU: every prototxt
in testdata/nets gives the same pipe in both packages (op names, types,
params, bots, tops, every node's dims) and bit-equal weights, read from the
net's caffemodel or seeded, also with the input overridden; the V1
upgrade; the SSD head's layer types (tinyssd and one-layer nets); and the
same error texts."""

import os

import numpy as np
import pytest

from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
from boda_tpu_torch.frontend import caffemodel as tcm
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt as tfrom

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NETS = os.path.join(REPO, "testdata", "nets")


def _net(name):
    return os.path.join(NETS, name)


def _same_pipe(jp, tp):
    assert (jp.name, list(jp.ops), list(jp.op_order)) == (tp.name, list(tp.ops),
                                                           list(tp.op_order))
    for k, a in jp.ops.items():
        b = tp.ops[k]
        assert (a.type, a.params, a.bots, a.tops) == (b.type, b.params, b.bots, b.tops), k
    assert sorted(jp.nodes) == sorted(tp.nodes)
    for n, node in jp.nodes.items():
        da, db = node.dims, tp.nodes[n].dims
        assert (da is None) == (db is None), n
        if da is not None:
            assert (da.names, da.sizes, da.tn) == (db.names, db.sizes, db.tn), n
        assert (node.top_for, node.bot_for) == (tp.nodes[n].top_for, tp.nodes[n].bot_for), n
    assert sorted(jp.weights) == sorted(tp.weights)
    for k, w in jp.weights.items():
        assert np.array_equal(w.data, tp.weights[k].data), k
        assert tp.weights[k].data.dtype == np.float32, k


# prototxt -> its caffemodel, or '' for boda_tpu's seeded weights.
# tinynet.caffemodel is a wire-format fixture of another net (conv1 with 4
# outputs, a V1 fc1): neither package can load it into tinynet (see below).
_NETS_CM = {"shapesnet": "shapesnet.caffemodel", "shapesnet2": "shapesnet2.caffemodel",
            "shapesnet3": "shapesnet3.caffemodel", "tinynet": "", "tinynet_v1": ""}


@pytest.mark.parametrize("name", sorted(_NETS_CM))
def test_prototxt_pipes_identical(name):
    """The net as written, and with its input overridden: --img=3, and with
    seeded weights also --in-sz=40 (a caffemodel's fc fixes the size)."""
    ptt, cm = _net(f"{name}.prototxt"), _NETS_CM[name]
    for img, in_sz in ((0, 0), (3, 0 if cm else 40)):
        kw = dict(weights_fn=_net(cm) if cm else "", img=img, in_sz=in_sz)
        (jp, jd), (tp, td) = jfrom(ptt, **kw), tfrom(ptt, **kw)
        _same_pipe(jp, tp)
        assert {k: d.sizes for k, d in jd.items()} == {k: d.sizes for k, d in td.items()}
        d = td["data"]
        assert d["img"] == (img or d["img"]) and d["y"] == d["x"] == (in_sz or d["y"])
    if cm:  # every weight the caffemodel holds is the one read
        blobs = tcm.read_caffemodel(_net(cm))
        for lname, bl in blobs.items():
            for blob, suffix in zip(bl, ("__filts", "__biases")):
                if lname + suffix in tp.weights:
                    assert np.array_equal(tp.weights[lname + suffix].data.ravel(),
                                          blob.data.ravel()), lname
    if name == "tinynet_v1":  # V1 enum types come out canonical, as upgraded
        assert [o.type for o in tp.ops.values()] == [
            "Convolution", "ReLU", "Pooling", "InnerProduct", "Softmax"]


_UNPORTED = {
    "Permute": "permute_param { order: 0 order: 2 order: 3 order: 1 }",
    "Flatten": "",
    "Normalize": "",
}


def test_unported_layer_types_raise(tmp_path):
    """The SSD head's layer types, which the port refused until it had their
    op rules (ROADMAP §1 item 6), now build to boda_tpu's pipe: tinyssd, and
    one-layer nets of Permute, Flatten and Normalize (its seeded scale blob
    included); no layer type of these files raises."""
    cases = [_net("tinyssd.prototxt")]
    for ltype, param in sorted(_UNPORTED.items()):
        fn = str(tmp_path / f"{ltype}.prototxt")
        with open(fn, "w") as f:
            f.write('name: "u"\ninput: "data"\ninput_shape { dim: 1 dim: 3 dim: 8 dim: 8 }\n'
                    f'layer {{ name: "l" type: "{ltype}" bottom: "data" top: "l" {param} }}\n')
        cases.append(fn)
    for fn in cases:
        _same_pipe(jfrom(fn)[0], tfrom(fn)[0])


_ERRORS = {
    "bad_syntax": ("bad_syntax.prototxt", ""),
    "no_prototxt": ("nosuch.prototxt", ""),
    "no_caffemodel": ("tinynet.prototxt", "nosuch.caffemodel"),
    "caffemodel_of_another_net": ("tinynet.prototxt", "tinynet.caffemodel"),
}


def test_errors_identical():
    for case, (ptt, cm) in sorted(_ERRORS.items()):
        msgs = []
        for fn in (jfrom, tfrom):
            with pytest.raises(ValueError) as e:
                fn(_net(ptt), weights_fn=_net(cm) if cm else "")
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1], case
        if case == "bad_syntax":
            assert msgs[1] == "bad_syntax.prototxt:1: expected ':' or '{' after field 'type'"
