"""The GEMM core's wgmma path (csrc/gemm.cuh) against the plain versions, on
the card: K1 (matmul) and K2/K3 (conv2d, conv2d_bck_in) at the plans the
shapes get, each case asserting which path ran.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on
the machine with the card from the repo root with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_gemm.py``.
Tolerances as in tests/test_torch_cuda.py: 1e-2 of max|ref| in bf16 (one
bf16 rounding is 2^-8 of a value), 1e-5 in f32.
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.ops.kernels.bconv import conv2d_bck_in, conv2d_bck_in_plain
from boda_tpu_torch.ops.kernels.common import plan_gemm
from boda_tpu_torch.ops.kernels.conv import conv2d, conv2d_plain
from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


def _t(rng, shape, dev, scale=1.0, dt=BF16):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, dt)


def _err(out, ref):
    return float((out.float() - ref.float()).abs().max()) / \
        max(float(ref.float().abs().max()), 1e-30)


def _plan(M, N, K, conv_c=None):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return plan_gemm(M, N, K, sms, BF16, conv_c=conv_c)


def _gemm(dev, M, K, N, *, res=False, relu=False, seed=0):
    """One matmul launch against matmul_plain; returns (out, plan, path run)."""
    rng = np.random.default_rng(seed)
    a, b = _t(rng, (M, K), dev), _t(rng, (K, N), dev, K ** -0.5)
    bias = _t(rng, (N,), dev, 0.1)
    r = _t(rng, (M, N), dev) if res else None
    paths = dict(matmul.paths)
    out = matmul(a, b, bias, relu=relu, residual=r)
    torch.cuda.synchronize()
    ran = [p for p in paths if matmul.paths[p] == paths[p] + 1]
    ref = matmul_plain(a, b, bias, relu=relu, residual=r)
    assert out.shape == (M, N) and out.dtype == BF16
    assert _err(out, ref) <= 1e-2, (M, K, N, _plan(M, N, K))
    return out, _plan(M, N, K), ran, (a, b, bias, r)


def _conv(dev, n, h, c, oc, k, s, p, *, res=False, relu=True, seed=0):
    rng = np.random.default_rng(seed)
    x, w = _t(rng, (n, h, h, c), dev), _t(rng, (k, k, c, oc), dev, (k * k * c) ** -0.5)
    bias = _t(rng, (oc,), dev, 0.1)
    oh = (h + 2 * p - k) // s + 1
    r = _t(rng, (n, oh, oh, oc), dev) if res else None
    kw = dict(stride=(s, s), pad=(p, p), relu=relu, residual=r)
    paths = dict(conv2d.paths)
    out = conv2d(x, w, bias, **kw)
    torch.cuda.synchronize()
    ran = [q for q in paths if conv2d.paths[q] == paths[q] + 1]
    assert out.shape == (n, oh, oh, oc)
    assert _err(out, conv2d_plain(x, w, bias, **kw)) <= 1e-2, (n, h, c, oc, k, s, p)
    return out, _plan(n * oh * oh, oc, k * k * c, conv_c=c), ran, lambda: conv2d(x, w, bias, **kw)


def test_one_tile(dev):
    # one 64x64 output tile over one 64-deep chunk: the smem descriptors and
    # the 128-byte swizzle of A (K-major) and B (N-major) in isolation
    _, plan, ran, _ = _gemm(dev, 64, 64, 64)
    assert ran == ["wgmma"] and plan[:4] == ("wgmma", 64, 64, 1) and plan.ctas == 1


def test_tile_widths(dev):
    # forward signatures whose plans take each width (and a 64-row tile)
    for M, K, N, tile in ((100352, 64, 64, (128, 64)), (25088, 256, 128, (128, 128)),
                          (100352, 64, 256, (128, 256)), (1568, 1024, 512, (64, 128))):
        _, plan, ran, _ = _gemm(dev, M, K, N, seed=N)
        assert ran == ["wgmma"] and (plan.bm, plan.bn) == tile and plan.split == 1, plan


def test_split_k_bit_equal(dev):
    # fc1000 at batch 32, and a res5-like 3x3 conv (n = 4, 7x7, 512 -> 512)
    out, plan, ran, (a, b, bias, _) = _gemm(dev, 32, 2048, 1000)
    assert ran == ["wgmma"] and plan.split > 1 and plan.bm == 64
    assert torch.equal(out, matmul(a, b, bias))
    out, plan, ran, again = _conv(dev, 4, 7, 512, 512, 3, 1, 1)
    assert ran == ["wgmma"] and plan.split > 1
    assert torch.equal(out, again())


def test_residual_relu_and_ragged_edges(dev):
    # the residual + ReLU epilogue; then M, N and K cut inside a tile, where
    # TMA reads zeros past the edge (N = 72 and K = 200 keep 16-byte rows)
    for M, K, N, res in ((2048, 256, 256, True), (1000, 200, 72, True), (130, 72, 136, False)):
        _, plan, ran, _ = _gemm(dev, M, K, N, res=res, relu=True, seed=M)
        assert ran == ["wgmma"], plan


def test_stem_takes_the_mma_path(dev):
    # C = 3 cannot take 16-byte gathers: the mma.sync loop, chosen by shape
    _, plan, ran, _ = _conv(dev, 2, 32, 3, 64, 7, 2, 3)
    assert ran == ["mma"] and plan.path == "mma"
    # the fold's C = 16 (4 taps per 64-deep chunk) and a strided 3x3 take wgmma
    for sig in ((2, 30, 16, 64, 4, 1, 0), (2, 15, 128, 128, 3, 2, 1), (2, 14, 24, 40, 3, 1, 1)):
        _, plan, ran, _ = _conv(dev, *sig, res=sig[2] == 24, seed=sig[2])
        assert ran == ["wgmma"], (sig, plan)


def test_dgrad_shapes(dev):
    # res2's 3x3 and res4's 1x1 dgrads: the conv kernel on flipped,
    # io-transposed weights through K3's entry
    for n, h, c, oc, k, p in ((4, 56, 64, 64, 3, 1), (4, 14, 1024, 256, 1, 0)):
        rng = np.random.default_rng(h + c)
        dy = _t(rng, (n, h, h, oc), dev)
        w = _t(rng, (k, k, c, oc), dev, (k * k * oc) ** -0.5)
        before = conv2d.paths["wgmma"]
        out = conv2d_bck_in(dy, w, pad=(p, p))
        torch.cuda.synchronize()
        assert conv2d.paths["wgmma"] == before + 1
        assert _err(out, conv2d_bck_in_plain(dy, w, pad=(p, p))) <= 1e-2, (n, h, c, oc, k)
