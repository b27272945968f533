"""The port's training-side autograd Functions (boda_tpu_torch/graph/
train_ops.py) against boda_tpu's custom VJPs and ``jax.grad`` of the stock
ops they replace, channels-last against NCHW, inputs numpy from a seed.

Gates: max pool values bit-equal and gradients within 1e-6 (boda_tpu's own
bar in tests/test_train_ops.py: where windows overlap, an input's gradient
sums the same cotangents in another order), ties routed to the first max as
SelectAndScatter does; the 1x1 conv and BN within 1e-5 (f32) of max|ref|
or 1e-2 (bf16); one training step with the three Functions on
(BODA_TRAIN_VJP=1 in both packages) within 1e-5 of boda_tpu's.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import lax

from boda_tpu.graph import train_ops as jops
from boda_tpu_torch.graph import train_ops as tops


def _nhwc(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32).transpose(0, 2, 3, 1)))


def _nchw(t):
    return t.detach().float().permute(0, 3, 1, 2).numpy()


def _ref_maxpool(x, k, s, pad_y, pad_x):
    return lax.reduce_window(
        x.astype(jnp.float32), -jnp.inf, lax.max,
        window_dimensions=(1, 1, k[0], k[1]), window_strides=(1, 1, s[0], s[1]),
        padding=((0, 0), (0, 0), pad_y, pad_x)).astype(x.dtype)


def _pool_geom(iy, ix, k, s, p):
    oy = -(-(iy + 2 * p[0] - k[0]) // s[0]) + 1
    ox = -(-(ix + 2 * p[1] - k[1]) // s[1]) + 1
    return oy, ox, (p[0], max(0, (oy - 1) * s[0] + k[0] - iy - p[0])), \
        (p[1], max(0, (ox - 1) * s[1] + k[1] - ix - p[1]))


def _pool_case(x_np, ct_np, geom, ref_custom: bool):
    """(port out, port grad, jax out, jax grad) for one geometry; the jax
    gradient from boda_tpu's custom VJP or from jax.grad of reduce_window."""
    iy, ix, k, s, p = geom
    oy, ox, pad_y, pad_x = _pool_geom(iy, ix, k, s, p)
    xj, ctj = jnp.asarray(x_np), jnp.asarray(ct_np)
    if ref_custom:
        jpool = jops.make_maxpool_vjp(k, s, pad_y, pad_x, iy, ix, oy, ox)
    else:
        def jpool(a):
            return _ref_maxpool(a, k, s, pad_y, pad_x)
    gj = jax.jit(jax.grad(lambda a: jnp.sum(jpool(a) * ctj)))(xj)
    tpool = tops.make_maxpool_vjp(k, s, pad_y, pad_x, iy, ix, oy, ox)
    xt = _nhwc(x_np).requires_grad_()
    out = tpool(xt)
    (gt,) = torch.autograd.grad((out * _nhwc(ct_np)).sum(), xt)
    return _nchw(out), _nchw(gt), np.asarray(jax.jit(jpool)(xj)), np.asarray(gj)


GEOMS = [  # boda_tpu's tests/test_train_ops.py geometries
    (14, 14, (3, 3), (2, 2), (0, 0)),
    (13, 15, (3, 3), (2, 2), (0, 0)),
    (8, 8, (2, 2), (2, 2), (0, 0)),
    (9, 9, (3, 3), (1, 1), (1, 1)),
    (7, 7, (7, 7), (1, 1), (0, 0)),
    (12, 10, (3, 2), (2, 3), (1, 0)),
]


@pytest.mark.parametrize("case", ["geoms", "ties", "window12"])
def test_maxpool_vjp_matches(case):
    rng = np.random.default_rng(7)
    if case == "geoms":  # distinct values: boda_tpu's custom VJP and reduce_window
        for geom in GEOMS:
            iy, ix, k, s, p = geom
            oy, ox, _, _ = _pool_geom(iy, ix, k, s, p)
            x = rng.standard_normal((2, 3, iy, ix)).astype(np.float32)
            ct = rng.standard_normal((2, 3, oy, ox)).astype(np.float32)
            for ref_custom in (True, False):
                out, g, jout, jg = _pool_case(x, ct, geom, ref_custom)
                np.testing.assert_array_equal(out, jout)
                np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)
    elif case == "ties":  # post-ReLU zeros and a constant plane: the first max
        geom = (10, 10, (3, 3), (2, 2), (0, 0))
        oy, ox, _, _ = _pool_geom(*geom)
        x = np.maximum(rng.standard_normal((2, 4, 10, 10)), 0).astype(np.float32)
        x[1, 2] = 1.5
        ct = rng.standard_normal((2, 4, oy, ox)).astype(np.float32)
        for ref_custom in (True, False):
            out, g, jout, jg = _pool_case(x, ct, geom, ref_custom)
            np.testing.assert_array_equal(out, jout)
            np.testing.assert_allclose(g, jg, rtol=0, atol=1e-6)
    else:
        # 144 taps: boda_tpu's int8 index plane wraps past tap 127
        # (boda_tpu/graph/train_ops.py:98); the port's int16 plane does not,
        # so its gradient is held to jax.grad of reduce_window
        geom = (24, 24, (12, 12), (12, 12), (0, 0))
        x = rng.standard_normal((2, 3, 24, 24)).astype(np.float32)
        ct = rng.standard_normal((2, 3, 2, 2)).astype(np.float32)
        out, g, jout, jg = _pool_case(x, ct, geom, ref_custom=False)
        np.testing.assert_array_equal(out, jout)
        np.testing.assert_array_equal(g, jg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conv1x1_explicit_matches(dtype):
    """Forward and both gradients against boda_tpu's conv1x1_explicit."""
    tol = 1e-5 if dtype == "float32" else 1e-2
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    for s, iy, ix in [((1, 1), 8, 8), ((2, 2), 8, 8), ((2, 2), 9, 7), ((3, 3), 10, 10)]:
        x = rng.standard_normal((2, 16, iy, ix)).astype(np.float32)
        w = rng.standard_normal((8, 16, 1, 1)).astype(np.float32)
        jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
        jf = jops.conv1x1_explicit(s, lax.Precision.HIGHEST)
        jout = jf(jx, jw)
        ct = rng.standard_normal(jout.shape).astype(np.float32)
        jgx, jgw = jax.grad(lambda a, b: jnp.sum(jf(a, b) * jnp.asarray(ct)),
                            argnums=(0, 1))(jx, jw)
        tx = _nhwc(x).to(tdt).requires_grad_()
        tw = torch.from_numpy(w).to(tdt).permute(2, 3, 1, 0).contiguous().requires_grad_()
        tout = tops.conv1x1_explicit(s)(tx, tw)
        gx, gw = torch.autograd.grad((tout * _nhwc(ct)).sum(), (tx, tw))
        assert gx.dtype == tdt and gw.dtype == tdt
        for got, ref in ((_nchw(tout), jout), (_nchw(gx), jgx),
                         (gw.detach().float().permute(3, 2, 0, 1).numpy(), jgw)):
            ref = np.asarray(ref, np.float32)
            assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), (s, dtype)


def test_bn_train_matches():
    """Forward (xhat, mean, var) and the fused backward, with cotangents on
    all three outputs, against boda_tpu's make_bn_train and jax.grad."""
    eps = 1e-5
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4, 6, 5, 5)) * 2 + 1).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    cm, cv = (rng.standard_normal(6).astype(np.float32) for _ in range(2))
    jf = jops.make_bn_train(eps)

    def jloss(a):
        o, m, v = jf(a)
        return jnp.sum(o * ct) + jnp.sum(m * cm) + jnp.sum(v * cv)
    jo, jm, jv = jf(jnp.asarray(x))
    jg = jax.grad(jloss)(jnp.asarray(x))
    xt = _nhwc(x).requires_grad_()
    o, m, v = tops.make_bn_train(eps)(xt)
    loss = (o * _nhwc(ct)).sum() + (m * torch.from_numpy(cm)).sum() + \
        (v * torch.from_numpy(cv)).sum()
    (g,) = torch.autograd.grad(loss, xt)
    for got, ref in ((_nchw(o), jo), (m.detach().numpy(), jm), (v.detach().numpy(), jv),
                     (_nchw(g), jg)):
        ref = np.asarray(ref)
        assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_step_with_train_vjps(monkeypatch):
    """BODA_TRAIN_VJP=1 in both packages: one momentum + train-mode BN step
    on mini_resnet (its strided 1x1 shortcuts on conv1x1_explicit under
    lib, BN on the fused backward) and on a net with max pools, both kernel
    policies, against boda_tpu's step."""
    from boda_tpu.models.zoo import NetBuilder as JNB
    from boda_tpu.models.zoo import build_model as jbuild
    from boda_tpu.parallel.train import make_train_step as jmake
    from boda_tpu.utils.dims import Dims as JDims
    from boda_tpu_torch.models.zoo import NetBuilder as TNB
    from boda_tpu_torch.models.zoo import build_model as tbuild
    from boda_tpu_torch.parallel.train import make_train_step as tmake
    from boda_tpu_torch.utils.carry import weights_from_numpy
    from boda_tpu_torch.utils.dims import Dims as TDims
    monkeypatch.setenv("BODA_TRAIN_VJP", "1")
    assert tops.enabled() and jops.enabled()

    def pool_net(NB, Dims):
        b = NB("poolnet")
        t = b.input("data")
        t = b.conv("conv1", t, 8, 3, pad=1, in_chans=3)
        t = b.relu("relu1", t)
        t = b.pool("pool1", t, kern=3, stride=2)
        t = b.conv("conv2", t, 8, 1, in_chans=8)
        t = b.pool("pool2", t, kern=2, stride=2)
        t = b.fc("fc", t, 5, in_feats=8 * 4 * 4)
        b.softmax("prob", t)
        return b.done({"data": Dims.of(img=2, chan=3, y=17, x=17)})

    nets = [("mini_resnet", jbuild("mini_resnet", img=2, in_sz=16)[0],
             tbuild("mini_resnet", img=2, in_sz=16)[0], 16),
            ("poolnet", pool_net(JNB, JDims), pool_net(TNB, TDims), 17)]
    rng = np.random.default_rng(5)
    for name, jp, tp, hw in nets:
        W = {k: np.asarray(v.data, np.float32) for k, v in jp.weights.items()}
        weights_from_numpy(tp, W)
        x = rng.standard_normal((2, 3, hw, hw)).astype(np.float32)
        y = np.array([1, 3], np.int32)
        kw = dict(lr=0.05, momentum=0.9, clip_norm=1.0, bn_momentum=0.1)
        jstep = jax.jit(jmake(jp, "fc", **kw))
        jl, jw, jm = jstep({k: jnp.asarray(v) for k, v in W.items()},
                           {"data": jnp.asarray(x)}, jnp.asarray(y))
        for pol in ("gen", "lib"):
            step = tmake(tp, "fc", kernel_policy=pol, **kw)
            tl, tw, tm = step({k: torch.from_numpy(v.copy()) for k, v in W.items()},
                              {"data": torch.from_numpy(x)}, torch.from_numpy(y))
            assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl)), (name, pol)
            log = "\n".join(step.info_log)
            if pol == "lib" and name == "mini_resnet":
                assert "conv1x1_explicit s=(2, 2)" in log
            # a bias ahead of train-mode BN has a zero gradient: its step is
            # rounding noise, held to the step's largest update
            upd = max(np.abs(np.asarray(jw[k]) - W[k]).max() for k in W)
            mmax = max(np.abs(np.asarray(v)).max() for v in jm.values())
            for k in W:
                ref = np.asarray(jw[k])
                err = np.abs(tw[k].numpy() - ref).max()
                assert err <= 1e-5 * max(np.abs(ref).max(), upd), (name, pol, k, err)
            for k in jm:
                ref = np.asarray(jm[k])
                assert np.abs(tm[k].numpy() - ref).max() <= 1e-5 * mmax, (name, pol, k)
