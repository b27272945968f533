"""add_bck_ops and softmax_to_loss build boda_tpu's graph, op for op and
node for node: the same op list (names, types, params, inputs, outputs),
the same node names (``X__grad``, ``X__grad__pN``) and the same dims."""

import pytest

from boda_tpu.graph.autodiff import add_bck_ops as j_add_bck_ops
from boda_tpu.graph.autodiff import softmax_to_loss as j_softmax_to_loss
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.graph.autodiff import add_bck_ops as t_add_bck_ops
from boda_tpu_torch.graph.autodiff import softmax_to_loss as t_softmax_to_loss
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.dims import Dims as TDims


def _small(NetBuilder, Dims):
    """conv -> ReLU -> pool -> fc -> softmax (no LRN: not ported)."""
    b = NetBuilder("small")
    t = b.input("data")
    t = b.conv("conv1", t, 8, 3, pad=1, in_chans=3, relu=True)
    t = b.pool("pool1", t, kern=2, stride=2)
    t = b.fc("fc1", t, 6, in_feats=8 * 4 * 4)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=2, chan=3, y=8, x=8)}
    return b.done(in_dims), in_dims


_NETS = {
    "mini_resnet": (lambda: jbuild("mini_resnet", img=2, in_sz=8),
                    lambda: tbuild("mini_resnet", img=2, in_sz=8)),
    "bconv_strides": (lambda: jbuild("bconv_strides"), lambda: tbuild("bconv_strides")),
    "small": (lambda: _small(JNetBuilder, JDims), lambda: _small(TNetBuilder, TDims)),
}


def _graph(pipe):
    ops = [(o.name, o.type, sorted((k, repr(v)) for k, v in o.params.items()),
            list(o.bots), list(o.tops)) for o in (pipe.ops[n] for n in pipe.op_order)]
    nodes = {n: (str(nd.dims), sorted(nd.top_for), sorted(nd.bot_for))
             for n, nd in pipe.nodes.items()}
    return ops, nodes, pipe.topo_op_order(), sorted(pipe.bots())


@pytest.mark.parametrize("name", sorted(_NETS))
def test_add_bck_ops_builds_boda_tpus_graph(name):
    jb, tb = _NETS[name]
    (jp, _), (tp, _) = jb(), tb()
    j_add_bck_ops(jp)
    t_add_bck_ops(tp)
    assert tp.bck_added and jp.bck_added
    jg, tg = _graph(jp), _graph(tp)
    assert tg[0] == jg[0]   # ops, in order
    assert tg[1] == jg[1]   # nodes: dims, producers, consumers
    assert tg[2:] == jg[2:]
    assert any(o.type == "GradAccum" for o in tp.ops.values())
    assert "data__grad" in tp.nodes or "data__grad__p0" in tp.nodes
    t_add_bck_ops(tp)       # a second call adds nothing
    assert _graph(tp) == tg


def test_softmax_to_loss_matches():
    (jp, _), (tp, _) = _small(JNetBuilder, JDims), _small(TNetBuilder, TDims)
    assert t_softmax_to_loss(tp) == j_softmax_to_loss(jp) == "prob_loss"
    assert _graph(tp) == _graph(jp)
    assert tp.ops["prob"].type == "SoftmaxWithLoss"
    assert tp.must_dims("prob_loss").shape == tp.must_dims("label").shape == (2,)
    assert t_softmax_to_loss(tp) == "prob_loss"  # already converted: found again
