"""K7 (csrc/stem.cu) on its mma route: input rows staged by bulk copy, each
conv row computed once per band, products on mma.sync, the pool on the
accumulators; against the plain version on the card, at the ResNet-50 b32
stem with the plan the wrapper takes, and with other plans (bands that do
not divide the pooled rows, N = 1, OC = 16 and 128, deeper rings, KH 3 and
CP 32) launched through the C entry point on outputs filled with NaN
beforehand: an output that no block wrote fails, so these cases hold the
split of a plan.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on
the machine with the card from the repo root with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_stem.py``.
Tolerance: 1e-2 of max|ref| in bf16 (one rounding of an f32 sum taken in
another order), 1e-5 in f32.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from boda_tpu_torch.ops.kernels import build
from boda_tpu_torch.ops.kernels.common import sm_count
from boda_tpu_torch.ops.kernels.stem import ROUTES, plan, stem_fused, stem_fused_plain

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _err(out, ref):
    return float((out.float() - ref.float()).abs().max()) / \
        max(float(ref.float().abs().max()), 1e-30)


def _launch(x6, w2, bias, kh, pooled, p, relu=True):
    """One K7 launch through the C entry point with plan ``p``, on an output
    filled with NaN."""
    n, xs_h, ow, cp = x6.shape
    oc = w2.shape[1]
    out = torch.full((n, pooled, pooled, oc), float("nan"), dtype=x6.dtype, device=x6.device)
    rc = build.load().lib.boda_stem(
        x6.data_ptr(), w2.data_ptr(), bias.float().contiguous().data_ptr(), out.data_ptr(), n,
        xs_h, ow, cp, kh, oc, pooled, pooled, int(relu), 1 if x6.dtype == BF16 else 0,
        ROUTES.index(p.route), p.band, p.bands, p.slots, build.stream_ptr(x6))
    build.check(rc, f"boda_stem {p}")
    torch.cuda.synchronize()
    return out


def test_b32_stem_on_mma(dev):
    (x6, w2, sb), _, _, kh, pooled = chip_smoke.stem_inputs(32, 224, 64, BF16,
                                                            np.random.default_rng(0), dev)
    kw = dict(kh=kh, poh=pooled, pow_=pooled)
    before = dict(stem_fused.paths)
    out = stem_fused(x6, w2, sb, **kw)
    ref = stem_fused_plain(x6, w2, sb, **kw)
    p = stem_fused.last_plan
    assert stem_fused.paths["mma"] == before["mma"] + 1
    assert (p.route, p.band, p.bands) == ("mma", 7, 8) or sm_count(dev) != 132, p
    assert out.shape == (32, 56, 56, 64) and _err(out, ref) <= 1e-2
    filled = _launch(x6, w2, sb, kh, pooled, p)
    assert not torch.isnan(filled).any() and torch.equal(filled, out)


def _pooled(v):
    return -(-(v - 3) // 2) + 1


# ((N, XS_H, OW, CP, KH, OC), band, slots, relu); None: the plan's own. The
# first four at the ResNet-50 stem's fold (KH 4, CP 48), the last at KH 3,
# CP 32, whose product loop takes its depth at run time
_CASES = [((1, 115, 112, 48, 4, 64), None, None, True),   # N = 1: bands of one pooled row
          ((3, 115, 112, 48, 4, 64), 5, None, True),      # bands of 5 of 56: the last has 1
          ((2, 115, 112, 48, 4, 16), 9, 6, False),        # OC = 16, a ring of KH + 2
          ((2, 115, 112, 48, 4, 128), 13, None, True),    # OC = 128
          ((2, 35, 32, 32, 3, 64), 3, 16, True)]          # a 32-wide conv, the deepest ring


@pytest.mark.parametrize("shape,band,slots,relu", _CASES)
def test_mma_plans_vs_plain(dev, shape, band, slots, relu):
    n, xs_h, ow, cp, kh, oc = shape
    rng = np.random.default_rng(sum(shape))
    x6, w2, bias = (torch.from_numpy((rng.standard_normal(sh) * sc).astype(np.float32)).to(dev, BF16)
                    for sh, sc in (((n, xs_h, ow, cp), 1.0), ((kh * cp, oc), (kh * cp) ** -0.5),
                                   ((oc,), 0.1)))
    poh, pow_ = _pooled(xs_h - kh + 1), _pooled(ow)
    assert poh == pow_, shape
    p = plan(n, xs_h, ow, cp, kh, oc, poh, pow_, BF16, True, sm_count(dev))
    assert p.route == "mma", p
    if band is not None:
        p = p._replace(band=band, bands=-(-poh // band))
    if slots is not None:
        p = p._replace(slots=slots)
    out = _launch(x6, w2, bias, kh, poh, p, relu)
    ref = stem_fused_plain(x6, w2, bias, kh=kh, poh=poh, pow_=pow_, relu=relu)
    assert not torch.isnan(out).any(), p
    assert _err(out, ref) <= 1e-2, (p, _err(out, ref))
