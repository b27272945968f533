"""K7, the fused stem (dx-folded conv + bias/ReLU + 3x3 s2 max pool), and
its host folds against boda_tpu's on the CPU.

boda_tpu's ``pallas_stem_fused`` runs in interpret mode, as its own tests
run it (tests/test_stem_fused.py); the port's ``stem_fused_plain`` on the
same folds of the same seeded input, at a 32x32 image (a 16x16 conv, pooled
to 8x8), with and without ReLU. Tolerance: 1e-5 of max|ref| (f32, summation
order only). The folds are numpy in both packages and must agree exactly.
K7's plan (route, bands, ring) is held by shape: the CUDA kernel itself runs
on the card only (tests/test_torch_cuda_stem.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.graph import lowering_nhwc as jlow
from boda_tpu.ops.kernels import stem as jstem
from boda_tpu_torch.graph.lowering_nhwc import host_stem_s2d, stem_s2d_geom
from boda_tpu_torch.ops.kernels.stem import (BLOCK_SMEM, SM_SMEM, fold_stem_weights_dx,
                                             host_stem_dxfold, plan, stem_dxfold_cp,
                                             stem_fused, stem_fused_plain)

C, KK, S, P = 3, 7, 2, 3


def _case(n, hw, oc, seed):
    rng = np.random.RandomState(seed)
    o = (hw + 2 * P - KK) // S + 1
    geom = stem_s2d_geom({"chan": C, "y": hw, "x": hw}, {"y": o, "x": o}, (S, S),
                         (P, P), (KK, KK), (1, 1), 1)
    m = geom["m"]
    x = rng.randn(n, hw, hw, C).astype(np.float32)
    w = (rng.randn(oc, C, KK, KK) * 0.1).astype(np.float32)
    b = (rng.randn(oc) * 0.1).astype(np.float32)
    wh = np.pad(w.transpose(2, 3, 1, 0), ((0, m * S - KK), (0, m * S - KK), (0, 0), (0, 0)))
    wf = wh.reshape(m, S, m, S, C, oc).transpose(0, 2, 1, 3, 4, 5).reshape(m, m, S * S * C, oc)
    return x, wf, b, geom, o


def test_host_folds_match_boda_tpu():
    x, wf, _, geom, o = _case(2, 32, 16, 0)
    jgeom = jlow.stem_s2d_geom({"chan": C, "y": 32, "x": 32}, {"y": o, "x": o}, (S, S),
                               (P, P), (KK, KK), (1, 1), 1)
    assert geom == jgeom
    assert stem_s2d_geom({"chan": 17, "y": 32, "x": 32}, {"y": o, "x": o}, (S, S),
                         (P, P), (KK, KK), (1, 1), 1) is None  # C*s*s > 64
    xsd = host_stem_s2d(x, geom)
    assert np.array_equal(xsd, jlow.host_stem_s2d(x, geom))
    m = geom["m"]
    assert stem_dxfold_cp(m, 12) == jstem.stem_dxfold_cp(m, 12) == 48
    for cp in (None, 64):
        assert np.array_equal(host_stem_dxfold(xsd, m, o, cp=cp),
                              jstem.host_stem_dxfold(xsd, m, o, cp=cp))
        assert np.array_equal(fold_stem_weights_dx(wf, cp=cp),
                              jstem.fold_stem_weights_dx(wf, cp=cp))


@pytest.mark.parametrize("relu", [True, False])
def test_stem_fused_plain_vs_jax_pallas(relu):
    x, wf, b, geom, o = _case(1, 32, 16, 3 + relu)
    m = geom["m"]
    pooled = -(-(o - 3) // 2) + 1
    x6 = host_stem_dxfold(host_stem_s2d(x, geom), m, o)
    w2 = fold_stem_weights_dx(wf)
    ref = np.asarray(jstem.pallas_stem_fused(
        jnp.asarray(x6), jnp.asarray(w2), jnp.asarray(b), kh=m, poh=pooled, pow_=pooled,
        relu=relu, precision="highest", interpret=True))
    got = stem_fused_plain(torch.from_numpy(x6), torch.from_numpy(w2), torch.from_numpy(b),
                           kh=m, poh=pooled, pow_=pooled, relu=relu).numpy()
    assert got.shape == ref.shape == (1, pooled, pooled, 16)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_stem_fused_on_cpu_runs_the_plain_version():
    x, wf, b, geom, o = _case(1, 26, 8, 5)  # a 13-wide conv: odd rows and columns
    m = geom["m"]
    pooled = -(-(o - 3) // 2) + 1
    ops = [torch.from_numpy(a) for a in (host_stem_dxfold(host_stem_s2d(x, geom), m, o),
                                         fold_stem_weights_dx(wf), b)]
    before = stem_fused.launches
    out = stem_fused(*ops, kh=m, poh=pooled, pow_=pooled)
    assert stem_fused.launches == before
    assert torch.equal(out, stem_fused_plain(*ops, kh=m, poh=pooled, pow_=pooled))
    # the right-clipped last window: the plain pool against a direct max
    acc = torch.cat([ops[0][:, ky:ky + o] for ky in range(m)], -1) @ ops[1] + ops[2]
    acc = torch.clamp_min(acc, 0.0)
    assert torch.equal(out[0, -1, -1], acc[0, 2 * (pooled - 1):, 2 * (pooled - 1):]
                       .amax(dim=(0, 1)))
    with pytest.raises(ValueError, match="cannot pool"):
        stem_fused(*ops, kh=m, poh=pooled + 2, pow_=pooled)


def test_stem_plan_bands_cover_every_pooled_row_once_and_fit():
    """The mma route at the ResNet-50 b32 stem (x6 32x115x112x48, OC 64: two
    blocks per SM, 8 bands of 7 pooled rows, 256 blocks on 132 SMs, a ring of
    KH + 1 = 5 rows) and at the card tests' other shapes; each plan's bands cover the
    pooled rows once, its blocks come to about one wave, and it fits shared
    memory (two blocks an SM up to OC = 64, one past it)."""
    for n, oc, xs_h, ow, poh in ((32, 64, 115, 112, 56), (1, 64, 115, 112, 56),
                                 (3, 64, 115, 112, 56), (2, 16, 115, 112, 56),
                                 (2, 128, 115, 112, 56), (2, 32, 35, 32, 16),
                                 (200, 64, 115, 112, 56)):
        p = plan(n, xs_h, ow, 48, 4, oc, poh, poh, torch.bfloat16)
        assert p.route == "mma", (n, oc, p)
        assert p.bands * p.band >= poh > (p.bands - 1) * p.band, p
        per_sm = 2 if oc <= 64 else 1
        wave = 132 * per_sm
        # the narrowest band whose blocks fit one wave (one band per image past it)
        assert p.band == 1 or n * -(-poh // (p.band - 1)) > wave, p
        assert n * p.bands <= wave or p.bands == 1, p
        assert p.slots == 5 and p.smem <= min(BLOCK_SMEM, SM_SMEM // per_sm - 1024), p
    assert plan(32, 115, 112, 48, 4, 64, 56, 56, torch.bfloat16)[:4] == ("mma", 7, 8, 5)


def test_stem_plan_route_by_shape():
    """fma for f32, for OW, CP or OC off the multiples of 16, OW > 128,
    OC > 128 and misaligned operands; its bands of at most 2 pooled rows,
    fewer where the conv rows do not fit."""
    bf, f32 = torch.bfloat16, torch.float32
    for args, dt, aligned in (((32, 115, 112, 48, 4, 64, 56, 56), f32, True),
                              ((2, 35, 31, 48, 4, 64, 16, 16), bf, True),
                              ((2, 35, 32, 40, 4, 64, 16, 16), bf, True),
                              ((2, 35, 32, 48, 4, 72, 16, 16), bf, True),
                              ((2, 35, 144, 48, 4, 64, 16, 16), bf, True),
                              ((2, 35, 32, 48, 4, 144, 16, 16), bf, True),
                              ((32, 115, 112, 48, 4, 64, 56, 56), bf, False)):
        p = plan(*args, dt, aligned)
        assert p.route == "fma" and p.slots == 0 and p.smem <= BLOCK_SMEM, (args, p)
        assert p.bands * p.band >= args[6] > (p.bands - 1) * p.band, p
    assert plan(32, 115, 112, 48, 4, 64, 56, 56, f32)[:3] == ("fma", 2, 28)
    assert plan(2, 67, 64, 48, 4, 128, 32, 32, f32).band == 1  # 2 pooled rows do not fit
