"""Backward-graph rules where PyTorch's defaults differ from boda_tpu's, and
the weight-layout repairs of the backward pass, on the CPU against
boda_tpu.

* ReLU at exact zeros: ``jnp.maximum(x, 0)`` sends half the cotangent
  through at x == 0; ``torch.relu`` sends none and ``torch.clamp_min`` all.
* Max pool over tied (all-zero) windows: both route to the first maximum.
* A weight gradient leaves the engine through the inverse of its upload
  prep (the fc's NHWC-flatten permutation and transpose, the conv's HWIO).
* Under ``kernel_policy=gen`` a strided conv runs the hand conv forward on
  HWIO weights and its backward as the autograd of the library conv, which
  wants OHWI: the backward converts inside, and the upload stays HWIO.

Gate: comp_vars(mrd_toler=1e-4, atol=1e-5 * max|ref|), as in
tests/test_torch_engine_bck.py.
"""

import numpy as np
import torch

from boda_tpu.config import make as jmake
from boda_tpu.graph.autodiff import add_bck_ops as j_add_bck_ops
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.autodiff import add_bck_ops as t_add_bck_ops
from boda_tpu_torch.graph.lowering_nhwc import HWIO, OHWI
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims


def _grad_name(pipe, n):
    g = f"{n}__grad"
    return g if g in pipe.nodes and pipe.nodes[g].dims is not None else f"{g}__p0"


def _grad_name_t(res, n):
    return next(k for k in res if k.startswith(f"{n}__grad"))


def _both(build, x, want, policy="gen"):
    """Build the net in both packages, add backward ops, run boda_tpu's
    pallas engine (gen) and the port's cuda engine (device=cpu, `policy`) on
    the same x and labels; return (boda_tpu's, the port's, the port engine)."""
    (jp, jd), (tp, td) = build(JNetBuilder, JDims), build(TNetBuilder, TDims)
    j_add_bck_ops(jp)
    t_add_bck_ops(tp)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    want = [_grad_name(jp, n) if not n.endswith("_loss") else n for n in want]
    labels = np.arange(x.shape[0], dtype=np.float32) % 3
    je = jmake("conv_fwd", "pallas", kernel_policy="gen")
    je.init(jp)
    n_img = x.shape[0]
    jr = je.run_fwd({"data": JNDA(jd["data"], x),
                     "label": JNDA(JDims.of(img=n_img), labels)}, want)
    te = tmake("conv_fwd", "cuda", device="cpu", kernel_policy=policy)
    te.init(tp)
    tr = te.run_fwd({"data": TNDA(td["data"], x),
                     "label": TNDA(TDims.of(img=n_img), labels)}, want)
    for n in want:
        a, b = jr[n].data, tr[n].data
        r = comp_vars(a, b, mrd_toler=1e-4, atol=1e-5 * float(np.abs(a).max()))
        assert r.ok(), f"{n}: {r}"
    return jr, tr, te


def test_relu_tie_at_zero_matches_jax():
    def build(NetBuilder, Dims):
        b = NetBuilder("relu0")
        t = b.input("data")
        t = b.relu("r0", t)
        t = b.fc("fc", t, 5, in_feats=4 * 3 * 3)
        b.softmax("prob", t)
        in_dims = {"data": Dims.of(img=2, chan=4, y=3, x=3)}
        return b.done(in_dims), in_dims
    rng = np.random.RandomState(7)
    x = rng.randn(2, 4, 3, 3).astype(np.float32)
    x[:, :2] = 0.0  # half the input exactly at the kink
    jr, tr, _ = _both(build, x, ["data", "r0"])
    g_in = tr[_grad_name_t(tr, "data")].data
    g_out = tr[_grad_name_t(tr, "r0")].data
    zero = x == 0.0
    assert zero.sum() == 36 and np.abs(g_out[zero]).max() > 0
    np.testing.assert_allclose(g_in[zero], 0.5 * g_out[zero], rtol=1e-6)


def test_maxpool_tied_windows_match_jax():
    def build(NetBuilder, Dims):
        b = NetBuilder("pool0")
        t = b.input("data")
        t = b.pool("p", t, kern=2, stride=2)
        t = b.fc("fc", t, 5, in_feats=3 * 3 * 3)
        b.softmax("prob", t)
        in_dims = {"data": Dims.of(img=2, chan=3, y=5, x=5)}  # ceil-mode edge
        return b.done(in_dims), in_dims
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 5, 5).astype(np.float32)
    x[0] = 0.0                 # every window of image 0 tied at zero
    x[1, :, :2, :2] = 1.5      # one tied nonzero window per channel
    jr, tr, _ = _both(build, x, ["data"])
    g = tr[_grad_name_t(tr, "data")].data
    # each window's whole cotangent goes to its first (top-left) element
    assert np.count_nonzero(g[0]) <= 9 * 3
    assert np.all(g[0][:, 1::2, :] == 0) and np.all(g[0][:, :, 1::2] == 0)


def test_weight_grads_leave_through_the_prep_inverse():
    def build(NetBuilder, Dims):
        b = NetBuilder("inv")
        t = b.input("data")
        t = b.conv("c", t, 6, 3, pad=1, in_chans=3)
        t = b.relu("r", t)
        t = b.fc("fc", t, 5, in_feats=6 * 2 * 3)  # fc on (2,3) spatial: NCHW flatten
        b.softmax("prob", t)
        in_dims = {"data": Dims.of(img=2, chan=3, y=2, x=3)}
        return b.done(in_dims), in_dims
    x = np.random.RandomState(9).randn(2, 3, 2, 3).astype(np.float32)
    for policy in ("gen", "lib"):
        _, tr, te = _both(build, x, ["c__filts", "fc__filts", "fc__biases", "data"],
                          policy)
        assert tr[_grad_name_t(tr, "c__filts")].data.shape == (6, 3, 3, 3)
        assert tr[_grad_name_t(tr, "fc__filts")].data.shape == (5, 36)
        for w, prep in te._weight_preps.items():
            logical = te.pipe.weights[w].data
            t = torch.from_numpy(logical)
            assert tuple(prep.prep(t).shape) == tuple(te._weights_dev[w].shape)
            assert np.array_equal(prep.inv(prep.prep(t)).numpy(), logical), w


def test_strided_conv_gen_forward_lib_backward_keeps_hwio():
    def build(NetBuilder, Dims):
        b = NetBuilder("strided")
        t = b.input("data")
        t = b.conv("cs", t, 8, 3, stride=2, pad=1, in_chans=4, relu=True)
        t = b.conv("c1", t, 6, 3, pad=1, in_chans=8)
        b.softmax("prob", t)
        in_dims = {"data": Dims.of(img=2, chan=4, y=6, x=6)}
        return b.done(in_dims), in_dims
    x = np.random.RandomState(10).randn(2, 4, 6, 6).astype(np.float32)
    _, tr, te = _both(build, x, ["cs__filts", "cs__biases", "c1__filts", "data"])
    log = te.get_info_log()
    assert "cs: nhwc-direct_conv" in log          # the hand conv forward
    assert "cs: nhwc-lib_conv" in log             # its Bck's library recompute
    assert "cs__bck: bck-conv" not in log and "c1__bck: bck-conv" in log
    assert te._weight_preps["cs__filts"] is HWIO  # no second prep registered
    assert tuple(te._weights_dev["cs__filts"].shape) == (3, 3, 4, 8)
    assert OHWI.layout != HWIO.layout


def test_eltwise_max_tie_matches_jax():
    def build(NetBuilder, Dims):
        b = NetBuilder("emax")
        t = b.input("data")
        u = b.relu("r", t)
        t = b.eltwise("e", [t, u], op="max")  # max(x, relu(x)): tied where x >= 0
        t = b.fc("fc", t, 5, in_feats=2 * 3 * 3)
        b.softmax("prob", t)
        in_dims = {"data": Dims.of(img=2, chan=2, y=3, x=3)}
        return b.done(in_dims), in_dims
    x = np.random.RandomState(11).randn(2, 2, 3, 3).astype(np.float32)
    x[:, 0, 0, 0] = 0.0
    _both(build, x, ["data", "e"])
