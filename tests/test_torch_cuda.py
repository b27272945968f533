"""The port's hand kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on
the machine with the card from the repo root with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py`` (the
repo's conftest.py configures JAX, which that machine does not have).
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.ops.kernels.bconv import (conv2d_bck_filts,
                                              conv2d_bck_filts_plain, conv2d_bck_in,
                                              conv2d_bck_in_plain, matmul_atb,
                                              matmul_atb_plain)
from boda_tpu_torch.ops.kernels.block import bottleneck, bottleneck_plain
from boda_tpu_torch.ops.kernels.block import plan as block_plan
from boda_tpu_torch.ops.kernels.conv import (conv2d, conv2d_plain,
                                             space_to_depth_conv)
from boda_tpu_torch.ops.kernels.pool import pool2d, pool2d_plain
from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    # the plain versions in full f32 (cuDNN convs default to TF32); only the
    # fp32_precision settings, which recent torch will not mix with the
    # legacy allow_tf32 flags
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


def _t(rng, shape, dt, dev, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale)
                            .astype(np.float32)).to(dev, dt)


# f32 runs full-precision FMA in another summation order than cuBLAS/cuDNN:
# 1e-5 of max|ref|. bf16: both round the f32 sum to bf16 once; one bf16 ulp
# is 2^-8 of a value, so 1e-2 of max|ref| covers it.
_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _err(out, ref):
    return float((out.float() - ref.float()).abs().max()) / \
        max(float(ref.float().abs().max()), 1e-30)


_GEMM_CASES = [
    (77, 147, 100, True, True, True),      # ragged everywhere
    (256, 64, 256, True, False, True),     # aligned
    (32, 2048, 1000, True, False, False),  # fc1000 at batch 32
    (1000, 40, 24, False, False, False),   # no epilogue
]
_CONV_CASES = [
    (2, 13, 3, 20, 7, 2, 3, False, True),    # stem-like, ragged
    (2, 9, 24, 40, 3, 1, 1, True, True),     # residual + ReLU
    (1, 11, 16, 136, 3, 2, 1, False, False),  # strided, OC past one tile
    (2, 14, 64, 64, 3, 1, 1, False, True),
]


def test_matmul_vs_plain(dev):
    for dt in (torch.float32, torch.bfloat16):
        for M, K, N, bias, res, relu in _GEMM_CASES:
            rng = np.random.default_rng(M + K + N)
            a = _t(rng, (M, K), dt, dev)
            b = _t(rng, (K, N), dt, dev, K ** -0.5)
            bb = _t(rng, (N,), dt, dev, 0.1) if bias else None
            rr = _t(rng, (M, N), dt, dev) if res else None
            before = matmul.launches
            out = matmul(a, b, bb, relu=relu, residual=rr)
            torch.cuda.synchronize()
            assert matmul.launches == before + 1
            ref = matmul_plain(a, b, bb, relu=relu, residual=rr)
            assert out.dtype == dt and out.shape == (M, N)
            assert _err(out, ref) <= _TOL[dt], (dt, M, K, N)


def test_conv_vs_plain(dev):
    for dt in (torch.float32, torch.bfloat16):
        for n, h, c, oc, k, s, p, res, relu in _CONV_CASES:
            rng = np.random.default_rng(n + h + c + oc)
            x = _t(rng, (n, h, h, c), dt, dev)
            w = _t(rng, (k, k, c, oc), dt, dev, (k * k * c) ** -0.5)
            b = _t(rng, (oc,), dt, dev, 0.1)
            oh = (h + 2 * p - k) // s + 1
            rr = _t(rng, (n, oh, oh, oc), dt, dev) if res else None
            before = conv2d.launches
            out = conv2d(x, w, b, stride=(s, s), pad=(p, p), relu=relu, residual=rr)
            torch.cuda.synchronize()
            assert conv2d.launches == before + 1
            ref = conv2d_plain(x, w, b, stride=(s, s), pad=(p, p), relu=relu,
                               residual=rr)
            assert out.shape == ref.shape == (n, oh, oh, oc)
            assert _err(out, ref) <= _TOL[dt], (dt, n, h, c, oc, k, s, p)


def test_wrapper_rejects_bad_operands(dev):
    a = torch.zeros(8, 16, device=dev)
    with pytest.raises(ValueError):
        matmul(a, torch.zeros(16, 8, device=dev, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        matmul(a, torch.zeros(8, 16, device=dev).t())  # not contiguous
    with pytest.raises(ValueError):
        matmul(a.half(), torch.zeros(16, 8, device=dev).half())


# (K, M, N): a 64x64 output over a long K (many splits), ragged edges, and a
# wide output over a short K
_ATB_CASES = [(25088, 64, 64), (1000, 77, 130), (1568, 512, 2048)]
# (N, H, C, OC, k, pad): stride-1 convs, 3x3 and 1x1
_BCK_CASES = [(2, 14, 64, 64, 3, 1), (2, 9, 24, 40, 3, 1), (2, 7, 256, 128, 1, 0)]


def test_matmul_atb_vs_plain(dev):
    for dt in (torch.float32, torch.bfloat16):
        for K, M, N in _ATB_CASES:
            rng = np.random.default_rng(K + M + N)
            a, b = _t(rng, (K, M), dt, dev), _t(rng, (K, N), dt, dev, K ** -0.5)
            before = matmul_atb.launches
            out = matmul_atb(a, b)
            torch.cuda.synchronize()
            assert matmul_atb.launches == before + 1
            assert out.dtype == torch.float32 and out.shape == (M, N)
            assert _err(out, matmul_atb_plain(a, b)) <= _TOL[dt], (dt, K, M, N)
            assert torch.equal(out, matmul_atb(a, b))  # deterministic


def test_conv2d_bck_filts_vs_plain(dev):
    for dt in (torch.float32, torch.bfloat16):
        for n, h, c, oc, k, p in _BCK_CASES:
            rng = np.random.default_rng(n + h + c + oc + k)
            x = _t(rng, (n, h, h, c), dt, dev)
            dy = _t(rng, (n, h + 2 * p - k + 1, h + 2 * p - k + 1, oc), dt, dev)
            before = matmul_atb.launches
            out = conv2d_bck_filts(x, dy, pad=(p, p))
            torch.cuda.synchronize()
            assert matmul_atb.launches == before + 1
            ref = conv2d_bck_filts_plain(x, dy, pad=(p, p))
            assert out.shape == ref.shape == (k, k, c, oc)
            assert _err(out, ref) <= _TOL[dt], (dt, n, h, c, oc, k, p)


def test_conv2d_bck_in_vs_plain(dev):
    for dt in (torch.float32, torch.bfloat16):
        for n, h, c, oc, k, p in _BCK_CASES:
            rng = np.random.default_rng(n + h + c + oc + k + 1)
            oh = h + 2 * p - k + 1
            dy = _t(rng, (n, oh, oh, oc), dt, dev)
            w = _t(rng, (k, k, c, oc), dt, dev, (k * k * oc) ** -0.5)
            before = conv2d.launches
            out = conv2d_bck_in(dy, w, pad=(p, p))
            torch.cuda.synchronize()
            assert conv2d.launches == before + 1
            ref = conv2d_bck_in_plain(dy, w, pad=(p, p))
            assert out.shape == ref.shape == (n, h, h, c)
            assert _err(out, ref) <= _TOL[dt], (dt, n, h, c, oc, k, p)


# (n, h, w, c, k): ragged planes (tiles of 8 and 7 cut at the edge), C and K
# off the 16-byte vectors, a res5-like plane in one tile, and planes whose
# few tiles are shared by clusters of blocks (the wgmma route: the others
# run one block per tile)
_BLOCK_CASES = [(2, 9, 11, 24, 16), (1, 5, 7, 20, 12), (2, 7, 7, 256, 64),
                (1, 14, 14, 64, 32), (1, 7, 7, 1024, 256), (1, 5, 5, 256, 128)]


def test_bottleneck_vs_plain(dev):
    clusters = {block_plan(n, h, w, c, k, torch.bfloat16).cluster
                for n, h, w, c, k in _BLOCK_CASES}
    assert {1, 2, 4} <= clusters, clusters
    for dt in (torch.float32, torch.bfloat16):
        for n, h, w, c, k in _BLOCK_CASES:
            rng = np.random.default_rng(n + h + w + c + k)
            ops = [_t(rng, (n, h, w, c), dt, dev), _t(rng, (c, k), dt, dev, c ** -0.5),
                   _t(rng, (k,), dt, dev, 0.1), _t(rng, (3, 3, k, k), dt, dev, (9 * k) ** -0.5),
                   _t(rng, (k,), dt, dev, 0.1), _t(rng, (k, c), dt, dev, k ** -0.5),
                   _t(rng, (c,), dt, dev, 0.1)]
            before = bottleneck.launches
            out = bottleneck(*ops)
            torch.cuda.synchronize()
            assert bottleneck.launches == before + 1
            assert out.shape == (n, h, w, c) and out.dtype == dt
            assert _err(out, bottleneck_plain(*ops)) <= _TOL[dt], (dt, n, h, w, c, k)


# (n, h, w, c, k, s, p, avg): pool1's ceil-mode clip at a ragged C, an avg
# with padding (the divisor counts only image pixels), a global avg
_POOL_CASES = [(2, 13, 13, 12, 3, 2, 0, False), (2, 13, 13, 16, 3, 2, 0, False),
               (1, 9, 9, 8, 3, 1, 1, True), (2, 7, 7, 24, 7, 1, 0, True)]


def test_pool2d_vs_plain(dev):
    for dt in (torch.float32, torch.bfloat16):
        for n, h, w, c, k, s, p, avg in _POOL_CASES:
            oy = -(-(h + 2 * p - k) // s) + 1
            ox = -(-(w + 2 * p - k) // s) + 1
            pad_y = (p, max(0, (oy - 1) * s + k - h - p))
            pad_x = (p, max(0, (ox - 1) * s + k - w - p))
            x = _t(np.random.default_rng(h + c), (n, h, w, c), dt, dev)
            args = ((k, k), (s, s), pad_y, pad_x, oy, ox, avg)
            before = pool2d.launches
            out = pool2d(x, *args)
            torch.cuda.synchronize()
            assert pool2d.launches == before + 1
            ref = pool2d_plain(x, *args)
            assert out.shape == ref.shape == (n, oy, ox, c)
            if avg:
                assert _err(out, ref) <= _TOL[dt], (dt, h, c, k, s, p)
            else:  # a max is exact in any dtype
                assert torch.equal(out, ref), (dt, h, c, k, s, p)


def test_space_to_depth_conv_vs_plain(dev):
    for dt in (torch.float32, torch.bfloat16):
        for n, h, c, oc, k, s, p in [(2, 31, 3, 16, 7, 2, 3), (1, 17, 5, 6, 3, 2, 1)]:
            rng = np.random.default_rng(h + k)
            x = _t(rng, (n, h, h, c), dt, dev)
            w = _t(rng, (k, k, c, oc), dt, dev, (k * k * c) ** -0.5)
            b = _t(rng, (oc,), dt, dev, 0.1)
            before = conv2d.launches
            out = space_to_depth_conv(x, w, b, stride=(s, s), pad=(p, p), relu=True)
            torch.cuda.synchronize()
            assert conv2d.launches == before + 1
            ref = conv2d_plain(x, w, b, stride=(s, s), pad=(p, p), relu=True)
            assert out.shape == ref.shape
            assert _err(out, ref) <= _TOL[dt], (dt, n, h, c, oc, k, s, p)


def _bits(t):
    """The raw bits of a float tensor, for bit-for-bit comparison (NaN, -0)."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def test_eltwise_vs_plain(dev):
    from boda_tpu_torch.ops.kernels.elementwise import FUNC_CODES, eltwise, eltwise_plain
    rng = np.random.default_rng(9)
    special = np.array([np.nan, -0.0, 0.0, -1.5, np.inf, -np.inf, 1e-40], np.float32)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        for n in (777, 100_003):
            base = rng.standard_normal(n + 1).astype(np.float32)
            base[:len(special)] = special
            a = torch.from_numpy(base).to(dev, dt)
            b = torch.from_numpy(np.roll(base, 3)).to(dev, dt)
            b[5] = 0.0  # max(-0, +0) at index 1 and max(-inf, +0) at 5
            # aligned operands, then a sliced view one element off alignment
            for x, y in ((a[:n], b[:n]), (a[1:], b[1:])):
                for func in FUNC_CODES:
                    ins = (x, y) if func in ("mul", "add", "sub", "max") else (x,)
                    before = eltwise.launches
                    out = eltwise(func, *ins)
                    torch.cuda.synchronize()
                    assert eltwise.launches == before + 1
                    ref = eltwise_plain(func, *ins)
                    assert out.dtype == dt and out.shape == ref.shape
                    assert torch.equal(_bits(out), _bits(ref)), (dt, n, func)


def _stem_case(rng, n, hw, oc, dt, dev):
    from boda_tpu_torch.graph.lowering_nhwc import host_stem_s2d, stem_s2d_geom
    from boda_tpu_torch.ops.kernels.stem import fold_stem_weights_dx, host_stem_dxfold
    c, kk, s, p = 3, 7, 2, 3
    o = (hw + 2 * p - kk) // s + 1
    geom = stem_s2d_geom({"chan": c, "y": hw, "x": hw}, {"y": o, "x": o},
                         (s, s), (p, p), (kk, kk), (1, 1), 1)
    m = geom["m"]
    x = rng.standard_normal((n, hw, hw, c)).astype(np.float32)
    w = (rng.standard_normal((oc, c, kk, kk)) * 0.1).astype(np.float32)
    wh = np.pad(w.transpose(2, 3, 1, 0), ((0, m * s - kk), (0, m * s - kk), (0, 0), (0, 0)))
    wh = wh.reshape(m, s, m, s, c, oc).transpose(0, 2, 1, 3, 4, 5).reshape(m, m, s * s * c, oc)
    x6 = host_stem_dxfold(host_stem_s2d(x, geom), m, o)
    pooled = -(-(o - 3) // 2) + 1
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)  # noqa: E731
    return (to(x6), to(fold_stem_weights_dx(wh)),
            to((rng.standard_normal(oc) * 0.1).astype(np.float32))), m, pooled


def test_stem_fused_vs_plain(dev):
    from boda_tpu_torch.ops.kernels.stem import stem_fused, stem_fused_plain
    rng = np.random.default_rng(4)
    # the tensor-core path (OW, CP, OC multiples of 16) and the FMA path
    # (a 13-wide conv row, OC 24)
    for n, hw, oc in ((2, 64, 64), (1, 26, 24), (1, 32, 16)):
        for dt in (torch.float32, torch.bfloat16):
            ops, m, pooled = _stem_case(rng, n, hw, oc, dt, dev)
            for relu in (True, False):
                kw = dict(kh=m, poh=pooled, pow_=pooled, relu=relu)
                before = stem_fused.launches
                out = stem_fused(*ops, **kw)
                torch.cuda.synchronize()
                assert stem_fused.launches == before + 1
                ref = stem_fused_plain(*ops, **kw)
                assert out.shape == ref.shape == (n, pooled, pooled, oc)
                assert _err(out, ref) <= _TOL[dt], (n, hw, oc, dt, relu)


def test_rtc_test_on_cuda(dev, capsys):
    from boda_tpu_torch import cli
    from boda_tpu_torch.ops.kernels.elementwise import eltwise
    before = eltwise.launches
    assert cli.main(["rtc_test", "--n=1000003"]) == 0
    out = capsys.readouterr().out
    assert "PASS" in out and f"be=cuda:{torch.cuda.get_device_name()}".replace(" ", "_") in out
    assert eltwise.launches == before + 1
