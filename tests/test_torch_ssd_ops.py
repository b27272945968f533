"""The SSD head's six op rules in the port against boda_tpu's, on the CPU.

Permute, Flatten, Reshape, Normalize, PriorBox and DetectionOutput, each on
canonical (img, chan, y, x) inputs, which the engines hold physically NHWC,
and on inputs of another dim order, which they hold logically: every node of
the port's ``cuda`` engine (``device=cpu``) against boda_tpu's ``pallas``
engine at comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|), with no element
over. Then the prior-box table bit-equal to ``_compute_priors``; the greedy
NMS keep masks equal to boda_tpu's loop on its own chain-regime inputs
(tests/test_ssd_ops.py), the port's fixpoint equal to its loop, all rows in
one batched call; planted ties resolved lower index first, as
``lax.top_k``; ``det_top_k``; and ``share_location=false`` refused with
boda_tpu's error.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from boda_tpu.config import make as jmake
from boda_tpu.graph import ssd_ops as jssd
from boda_tpu.graph.pipe import ConvOp as JConvOp
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu.utils.lexp import parse_lexp as jparse
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt as tfrom
from boda_tpu_torch.graph import ssd_ops as tssd
from boda_tpu_torch.graph.pipe import ConvOp as TConvOp
from boda_tpu_torch.graph.pipe import PipeError
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu_torch.utils.lexp import parse_lexp as tparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINYSSD = os.path.join(REPO, "testdata", "nets", "tinyssd.prototxt")


def _nodes(pipe):
    return [n for n, node in pipe.nodes.items()
            if node.dims is not None and n not in pipe.weights and node.top_for]


def _det_op(ConvOp, loc, conf, pri, code, bg, keep):
    return ConvOp("det", "DetectionOutput", {
        "num_classes": 3, "share_location": True, "background_label_id": bg,
        "nms_threshold": 0.45, "top_k": 20, "code_type": code, "keep_top_k": keep,
        "confidence_threshold": 0.01}, bots=[loc, conf, pri], tops=["det"])


def _rules_net(NetBuilder, Dims, ConvOp, canonical: bool):
    """Every rule of the head on 2 images of 10x10: conv outputs (canonical)
    into Normalize, Permute, Flatten, Reshape and DetectionOutput's loc, or
    the same rules after a Permute (another dim order: the Normalize then
    reduces logical axis 1, the Flatten starts at axis 2); a loc/conf/prior
    head of 4 priors per location and 3 classes, decoded CENTER_SIZE with
    background 0 (canonical) or CORNER with no background and padded
    keep_top_k rows (the other order)."""
    b = NetBuilder("ssd_rules")
    d = b.input("data")
    c = b.conv("c", d, 8, 3, stride=2, pad=1, in_chans=6, relu=True)   # (2, 8, 5, 5)
    if canonical:
        nm = b.normalize("nm", c, 8, scale=3.0)
        b.permute("perm", nm, [0, 2, 3, 1])
        b.flatten("flat", nm)
        b.reshape("resh", nm, [0, -1, 10])
    else:
        p1 = b.permute("p1", c, [0, 2, 3, 1])                          # (img, y, x, chan)
        p2 = b.permute("perm", p1, [0, 2, 1, 3])                       # (img, x, y, chan)
        nm = b.normalize("nm", p2, 5, scale=3.0)
        fl = b.flatten("flat", nm, axis=2)
        b.reshape("resh", fl, [0, -1, 5])
        # back to (img, chan, y, x), which the engines hold physically NHWC:
        # a Permute and a Reshape there, each read by a conv
        back = b.permute("back", p2, [0, 3, 2, 1])
        b.conv("back_conv", back, 4, 3, pad=1, in_chans=8)
        br = b.reshape("back_resh", back, [0, 0, 0, 0])
        b.conv("back_resh_conv", br, 4, 1, in_chans=8)
    loc = b.conv("loc", c, 16, 3, pad=1, in_chans=8)
    cf = b.conv("conf", c, 12, 3, pad=1, in_chans=8)
    cf = b.flatten("conf_flat", b.permute("conf_perm", cf, [0, 2, 3, 1]))
    cf = b.flatten("conf_sm_flat", b.softmax_axis(
        "conf_sm", b.reshape("conf_resh", cf, [0, -1, 3]), axis=2))
    pri = b.priorbox("pri", c, d, [3.0], [6.0], [2.0])
    if canonical:
        b.pipe.add_op(_det_op(ConvOp, loc, cf, pri, "CENTER_SIZE", 0, 30))
    else:
        loc = b.flatten("loc_flat", b.permute("loc_perm", loc, [0, 2, 3, 1]))
        b.pipe.add_op(_det_op(ConvOp, loc, cf, pri, "CORNER", -1, 70))
    in_dims = {"data": Dims.of(img=2, chan=6, y=10, x=10)}
    return b.done(in_dims), in_dims


# nodes that boda_tpu's NHWC engine gets wrong (a Permute or Reshape back to
# canonical dims comes out logical there, and a conv on it fails; ROADMAP §3):
# held to its NCHW (xla) engine instead
_BACK = ("back", "back_conv", "back_resh", "back_resh_conv")


@pytest.mark.parametrize("canonical", [True, False], ids=["canonical", "other_order"])
def test_rules_match_boda_tpu(canonical):
    (jp, jd), (tp, td) = (_rules_net(JNetBuilder, JDims, JConvOp, canonical),
                          _rules_net(TNetBuilder, TDims, TConvOp, canonical))
    nodes = _nodes(jp)
    for n in jp.nodes:
        a, b = jp.nodes[n].dims, tp.nodes[n].dims
        assert (a is None) == (b is None) and (a is None or (a.names, a.sizes) ==
                                               (b.names, b.sizes)), n
    for k, w in jp.weights.items():
        assert np.array_equal(w.data, tp.weights[k].data), k
    x = np.random.RandomState(7).randn(*jd["data"].shape).astype(np.float32)
    je = jmake("conv_fwd", "pallas")
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(jd["data"], x)}, [n for n in nodes if n not in _BACK])
    if not canonical:  # boda_tpu's NHWC engine: "back" transposed, its convs refuse it
        jx = jmake("conv_fwd", "xla")
        jx.init(jp)
        jr.update(jx.run_fwd({"data": JNDA(jd["data"], x)}, list(_BACK)))
        wrong = je.run_fwd({"data": JNDA(jd["data"], x)}, ["back"])["back"].data
        assert not np.array_equal(wrong, jr["back"].data)
    te = tmake("conv_fwd", "cuda", device="cpu")
    te.init(tp)
    tr = te.run_fwd({"data": TNDA(td["data"], x)}, nodes)
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert a.shape == b.shape, n
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
        assert r.ok() and r.num_diff == 0, f"node {n}: {r}"
    det = tr["det"].data.reshape(-1, 7)
    assert np.array_equal(det[:, :2], jr["det"].data.reshape(-1, 7)[:, :2])
    valid = det[:, 1] >= 0
    assert valid.sum() > 0 and set(det[:, 0]) == {0.0, 1.0}
    if not canonical:  # keep_top_k past 3 classes x top_k 20: padded rows
        assert (det[:, 1].reshape(2, 70)[:, 60:] == -1).all()


def test_priors_table_equal():
    """ssd300's six PriorBox tables and tinyssd's (no flip, its own
    variances), bit for bit, and a clipped one with explicit steps."""
    jp, _ = jbuild("ssd300", img=1)
    tp, _ = tbuild("ssd300", img=1)
    from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
    pairs = [(jp, tp), (jfrom(TINYSSD)[0], tfrom(TINYSSD)[0])]
    n = 0
    for j, t in pairs:
        for name, op in j.ops.items():
            if op.type != "PriorBox":
                continue
            top = t.ops[name]
            want = jssd._compute_priors(op, j.must_dims(op.bots[0]), j.must_dims(op.bots[1]))
            got = tssd._compute_priors(top, t.must_dims(top.bots[0]), t.must_dims(top.bots[1]))
            assert got.dtype == np.float32 and np.array_equal(got, want), name
            n += 1
            if name == "fc7_mbox_priorbox":
                kw = dict(op.params, clip=True, step=14.0, offset=0.25)
                got = tssd._compute_priors(TConvOp("v", "PriorBox", kw, top.bots, top.tops),
                                           t.must_dims(top.bots[0]), t.must_dims(top.bots[1]))
                want = jssd._compute_priors(JConvOp("v", "PriorBox", kw, op.bots, op.tops),
                                            j.must_dims(op.bots[0]), j.must_dims(op.bots[1]))
                assert np.array_equal(got, want) and got.min() >= 0 and got.max() <= 1
    assert n == 7
    assert tp.nodes["mbox_priorbox"].dims.sizes == (1, 2, 8732 * 4)


def test_greedy_nms_keep_masks_match_boda_tpu():
    """boda_tpu's fixpoint-vs-loop inputs (8 trials of 200 boxes, the even
    ones sliding along a line: long suppression chains), k 32 and 128: all
    8 rows in one batched call of the port's loop give boda_tpu's loop keep
    masks and scores per row, and the port's fixpoint gives its loop's."""
    rng = np.random.RandomState(0)
    scores, boxes = [], []
    for trial in range(8):
        p = 200
        scores.append(rng.rand(p).astype(np.float32))
        ctr = rng.rand(p, 2) * 0.5
        if trial % 2 == 0:
            ctr = np.stack([np.linspace(0, 1, p), np.full(p, 0.5)], axis=1) \
                + rng.randn(p, 2) * 0.01
        wh = 0.1 + rng.rand(p, 2) * 0.1
        boxes.append(np.concatenate([ctr - wh / 2, ctr + wh / 2], axis=1).astype(np.float32))
    ts, tb = torch.from_numpy(np.stack(scores)), torch.from_numpy(np.stack(boxes))
    for k in (32, 128):
        sc, b, keep = tssd._greedy_nms(ts, tb, k, 0.45, 0.1)
        _, _, keep_fp = tssd._greedy_nms(ts, tb, k, 0.45, 0.1, method="fixpoint")
        assert torch.equal(keep, keep_fp)
        for r in range(8):
            jsc, jb, jkeep = jssd._greedy_nms(jnp.asarray(scores[r]), jnp.asarray(boxes[r]), k,
                                              0.45, 0.1)
            np.testing.assert_array_equal(keep[r].numpy(), np.asarray(jkeep))
            np.testing.assert_array_equal(sc[r].numpy(), np.asarray(jsc))
            np.testing.assert_array_equal(b[r].numpy(), np.asarray(jb))
        assert 0 < int(keep.sum()) < keep.numel()
    with pytest.raises(ValueError, match="unknown method"):
        tssd._greedy_nms(ts, tb, 8, 0.45, 0.1, method="nosuch")


def test_planted_ties_resolve_lower_index_first():
    """Scores from three levels only: the top-k order is lax.top_k's (the
    lower index first among equal scores), so are the NMS keep masks, and a
    whole DetectionOutput on confidences with ties across priors and
    classes gives boda_tpu's rows: image, label and score equal, boxes
    within 1e-6 of max|box|."""
    rng = np.random.RandomState(4)
    s = rng.choice(np.float32([0.9, 0.5, 0.3]), size=(6, 150))
    v, i = tssd._top_k(torch.from_numpy(s), 40)
    jv, ji = lax.top_k(jnp.asarray(s), 40)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert torch.equal(tssd._top_k(torch.zeros(1, 9), 9)[1][0], torch.arange(9))
    ctr = rng.rand(150, 2) * 0.6
    bx = np.concatenate([ctr, ctr + 0.3], axis=1).astype(np.float32)
    _, _, keep = tssd._greedy_nms(torch.from_numpy(s), torch.from_numpy(bx)[None].expand(6, 150, 4),
                                  40, 0.45, 0.01)
    for r in range(6):
        jkeep = jssd._greedy_nms(jnp.asarray(s[r]), jnp.asarray(bx), 40, 0.45, 0.01)[2]
        np.testing.assert_array_equal(keep[r].numpy(), np.asarray(jkeep))
    # DetectionOutput: 2 images, 60 priors, 3 classes; confidences on a grid
    op_j = _det_op(JConvOp, "l", "c", "p", "CENTER_SIZE", 0, 25)
    op_t = _det_op(TConvOp, "l", "c", "p", "CENTER_SIZE", 0, 25)
    loc = (rng.randn(2, 240) * 0.5).astype(np.float32)
    conf = rng.choice(np.float32([0.6, 0.25, 0.125]), size=(2, 180))
    pb = np.concatenate([ctr[:60], ctr[:60] + 0.2], axis=1).reshape(-1)
    pri = np.stack([pb, np.tile(np.float32([0.1, 0.1, 0.2, 0.2]), 60)])[None].astype(np.float32)
    want = np.asarray(jssd._detection_output_fn(op_j, 3)(
        jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(pri))[0]).reshape(-1, 7)
    got = tssd._detection_output_fn(op_t, 3, 2, "cpu")(
        torch.from_numpy(loc), torch.from_numpy(conf), torch.from_numpy(pri))[0] \
        .numpy().reshape(-1, 7)
    np.testing.assert_array_equal(got[:, :3], want[:, :3])
    assert np.abs(got[:, 3:] - want[:, 3:]).max() <= 1e-6 * np.abs(want[:, 3:]).max()
    sc = got[got[:, 1] >= 0, 2]
    assert len(sc) > len(set(sc.tolist()))  # ties among the kept rows


def test_det_top_k():
    """det_top_k=400 (ssd300's own top_k) bit-equal to the default, 64
    keeps 0 < valid <= the default's with the same top score, and logs
    boda_tpu's line; on tinyssd, det_top_k=16 gives boda_tpu's rows."""
    pipe, dims = tbuild("ssd300", img=1)
    from boda_tpu_torch.modes.cnet import gen_data_inputs
    ins = gen_data_inputs(dims)

    def run(k=None):
        kw = {"per_op_tune": {"detection_out": tparse(f"(det_top_k={k})")}} if k else {}
        e = tmake("conv_fwd", "cuda", device="cpu", **kw)
        e.init(pipe)
        return e.run_fwd(ins, ["detection_out"])["detection_out"].data.reshape(-1, 7), e
    base, _ = run()
    same, _ = run(400)
    np.testing.assert_array_equal(base, same)
    small, e = run(64)
    assert "detection_out: det_top_k=64 (serving latency knob; caffe parity uses " \
        "the prototxt top_k)" in e.get_info_log()
    vb, vs = base[base[:, 1] >= 0], small[small[:, 1] >= 0]
    assert 0 < len(vs) <= len(vb)
    assert np.isfinite(vs[:, 2]).all() and (vs[:, 2] >= 0).all() and (vs[:, 2] <= 1).all()
    assert abs(vs[:, 2].max() - vb[:, 2].max()) < 1e-6
    from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
    (jp, jd), (tp, td) = jfrom(TINYSSD), tfrom(TINYSSD)
    x = np.random.RandomState(2).randn(*jd["data"].shape).astype(np.float32) * 20
    je = jmake("conv_fwd", "pallas", per_op_tune={"detection_out": jparse("(det_top_k=16)")})
    je.init(jp)
    te = tmake("conv_fwd", "cuda", device="cpu",
               per_op_tune={"detection_out": tparse("(det_top_k=16)")})
    te.init(tp)
    a = je.run_fwd({"data": JNDA(jd["data"], x)}, ["detection_out"])["detection_out"].data
    b = te.run_fwd({"data": TNDA(td["data"], x)}, ["detection_out"])["detection_out"].data
    np.testing.assert_array_equal(b[..., :2], a[..., :2])
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * np.abs(a).max())
    assert (b.reshape(-1, 7)[:, 1] >= 0).sum() > 0


def test_share_location_false_refused():
    """boda_tpu's error, word for word, from the rule and at the engine's
    init."""
    msgs = []
    for ConvOp, fn in ((JConvOp, lambda op: jssd._detection_output_fn(op, 3)),
                       (TConvOp, lambda op: tssd._detection_output_fn(op, 3, 1, "cpu"))):
        op = _det_op(ConvOp, "l", "c", "p", "CENTER_SIZE", 0, 10)
        op.params["share_location"] = False
        with pytest.raises(ValueError) as e:
            fn(op)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "op 'det': share_location=false unsupported"
    tp, _ = tfrom(TINYSSD)
    tp.ops["detection_out"].params["share_location"] = False
    with pytest.raises(PipeError, match="share_location=false unsupported"):
        tmake("conv_fwd", "cuda", device="cpu").init(tp)
