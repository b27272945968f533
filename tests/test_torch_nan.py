"""NaN at ReLU and at max-pool: the port's plain versions against boda_tpu's
Pallas kernels on input with NaN planted, on the CPU.

boda_tpu takes ``jnp.maximum`` for every ReLU and max, so a NaN propagates;
the port's plain versions (``torch.clamp_min``, ``F.max_pool2d``) must do the
same, and chip_smoke.py's nan phase (tests/test_torch_cuda_nan.py on the card)
holds each hand kernel against them. boda_tpu's kernels run in interpret mode,
as its own tests run them. NaN is compared equal: ``assert_allclose`` fails
unless both sides hold NaN at the same elements. Tolerances: max pools exact;
the rest 1e-5 of max|ref| (f32, summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.kernels import stem as jstem
from boda_tpu.ops.kernels.block import pallas_bottleneck
from boda_tpu.ops.kernels.pool import pallas_pool
from boda_tpu.ops.kernels.sgemm import pallas_matmul
from boda_tpu_torch.graph.lowering_nhwc import host_stem_s2d, stem_s2d_geom
from boda_tpu_torch.ops.kernels.block import bottleneck_plain
from boda_tpu_torch.ops.kernels.common import epilogue
from boda_tpu_torch.ops.kernels.pool import pool2d_plain
from boda_tpu_torch.ops.kernels.stem import (fold_stem_weights_dx, host_stem_dxfold,
                                             stem_fused_plain)


def _randn(rng, shape, scale=1.0, nan=()):
    v = (rng.standard_normal(shape) * scale).astype(np.float32)
    for idx in nan:
        v[idx] = np.nan
    return v


def _same(got, ref, atol):
    assert np.isnan(ref).any() and not np.isnan(ref).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)  # NaN where ref has NaN


def test_epilogue_keeps_nan_as_pallas_matmul():
    rng = np.random.default_rng(1)
    M, K, N = 37, 150, 70
    a = _randn(rng, (M, K), nan=[(3, 7)])
    b = _randn(rng, (K, N), K ** -0.5)
    bias = _randn(rng, (N,), 0.1)
    res = _randn(rng, (M, N), nan=[(20, 5), (M - 1, N - 1)])
    ref = np.asarray(pallas_matmul(jnp.asarray(a), jnp.asarray(b), jnp.asarray(bias),
                                   bm=16, bn=128, bk=128, relu=True, interpret=True,
                                   residual=jnp.asarray(res)))
    got = epilogue(torch.from_numpy(a) @ torch.from_numpy(b), torch.from_numpy(bias),
                   torch.from_numpy(res), True, torch.float32).numpy()
    assert np.isnan(got[3]).all() and (got[~np.isnan(got)] >= 0).all()
    _same(got, ref, 1e-5 * np.nanmax(np.abs(ref)))


# (iy, c, k, s): pool1's class (3x3 s2, the ceil-mode last window clipped) and
# pool5's (a 7x7 global window)
@pytest.mark.parametrize("iy,c,k,s", [(15, 8, 3, 2), (7, 16, 7, 1)])
def test_pool2d_plain_keeps_nan_as_pallas_pool(iy, c, k, s):
    rng = np.random.default_rng(iy)
    oy = -(-(iy - k) // s) + 1
    pad = (0, max(0, (oy - 1) * s + k - iy))
    x = _randn(rng, (2, iy, iy, c), nan=[(0, 0, 0, 1), (1, iy - 1, iy - 1, c - 1)])
    args = ((k, k), (s, s), pad, pad, oy, oy, False)
    ref = np.asarray(pallas_pool(jnp.asarray(x), *args, interpret=True))
    got = pool2d_plain(torch.from_numpy(x), *args).numpy()
    _same(got, ref, 0)


def test_stem_fused_plain_keeps_nan_as_pallas_stem_fused():
    rng = np.random.default_rng(2)
    c, kk, s, p, hw, oc = 3, 7, 2, 3, 32, 16
    o = (hw + 2 * p - kk) // s + 1
    geom = stem_s2d_geom({"chan": c, "y": hw, "x": hw}, {"y": o, "x": o}, (s, s), (p, p),
                         (kk, kk), (1, 1), 1)
    m = geom["m"]
    w = _randn(rng, (oc, c, kk, kk), 0.1)
    wh = np.pad(w.transpose(2, 3, 1, 0), ((0, m * s - kk), (0, m * s - kk), (0, 0), (0, 0)))
    wf = wh.reshape(m, s, m, s, c, oc).transpose(0, 2, 1, 3, 4, 5).reshape(m, m, s * s * c, oc)
    x6 = host_stem_dxfold(host_stem_s2d(_randn(rng, (1, hw, hw, c)), geom), m, o)
    x6[0, 5, 3, 2] = x6[0, -1, -1, 0] = np.nan
    w2, b = fold_stem_weights_dx(wf), _randn(rng, (oc,), 0.1)
    pooled = -(-(o - 3) // 2) + 1
    ref = np.asarray(jstem.pallas_stem_fused(
        jnp.asarray(x6), jnp.asarray(w2), jnp.asarray(b), kh=m, poh=pooled, pow_=pooled,
        relu=True, precision="highest", interpret=True))
    got = stem_fused_plain(torch.from_numpy(x6), torch.from_numpy(w2), torch.from_numpy(b),
                           kh=m, poh=pooled, pow_=pooled, relu=True).numpy()
    _same(got, ref, 1e-5 * np.nanmax(np.abs(ref)))


def test_bottleneck_plain_keeps_nan_as_pallas_bottleneck():
    rng = np.random.default_rng(3)
    n, h, c, k = 2, 8, 128, 32
    ops = [_randn(rng, (n, h, h, c), nan=[(0, 0, 0, 5), (1, 4, 3, c - 1)]),
           _randn(rng, (c, k), c ** -0.5), _randn(rng, (k,), 0.1),
           _randn(rng, (3, 3, k, k), (9 * k) ** -0.5), _randn(rng, (k,), 0.1),
           _randn(rng, (k, c), k ** -0.5), _randn(rng, (c,), 0.1)]
    ref = np.asarray(pallas_bottleneck(*map(jnp.asarray, ops), precision="highest",
                                       interpret=True))
    got = bottleneck_plain(*map(torch.from_numpy, ops)).numpy()
    _same(got, ref, 1e-5 * np.nanmax(np.abs(ref)))
