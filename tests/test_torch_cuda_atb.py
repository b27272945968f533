"""K5 (csrc/atb.cu) on the GEMM core's wgmma path, A stored M-major and read
through wgmma's transpose-A bit, against its plain versions on the card:
the dense Aᵀ.B (matmul_atb, A by TMA) and the weight gradient
(conv2d_bck_filts, A gathered by cp.async), each case asserting which path
ran; the edge route (``wgmma_edge``: the dense form with an even N % 8 != 0
on B's rows padded to 16 bytes, as the training step's fc writes dY;
fc1000's (tp=2) wgrad, N = 500) at (M, N, K) = (2048, N, 32) for N = 84,
126, 500 and 1002 with NaN in the padding, split-K bit-equal, the output
written up to its last element and not past it (the C entry on a
NaN-filled buffer), and the C entry's refusals.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on
the machine with the card from the repo root with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_atb.py``.
Tolerances: small-integer inputs give exact products and exact f32 sums,
so those cases must match bit for bit; random inputs within 1e-2 of
max|ref| in bf16 (f32 sums in another order over K up to 100,352), 1e-5
in f32.
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.ops.kernels.bconv import (conv2d_bck_filts, conv2d_bck_filts_plain,
                                              matmul_atb, matmul_atb_plain)
from boda_tpu_torch.ops.kernels.common import cdiv, copy_rows

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


def _t(rng, shape, dev, dt=BF16, ints=False):
    v = rng.integers(-3, 4, shape) if ints else rng.standard_normal(shape)
    return torch.from_numpy(v.astype(np.float32)).to(dev, dt)


def _err(out, ref):
    return float((out.float() - ref.float()).abs().max()) / \
        max(float(ref.float().abs().max()), 1e-30)


def _run(fn, *args, **kw):
    """One K5 launch: (output, the path it ran, its plan)."""
    paths = dict(matmul_atb.paths)
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    ran = [p for p in paths if matmul_atb.paths[p] == paths[p] + 1]
    assert out.dtype == torch.float32
    return out, ran, matmul_atb.last_plan


def test_one_tile_trans_a(dev):
    # one 64x64 output tile over one 64-deep chunk: the M-major A under the
    # 128-byte swizzle (transpose-A descriptor) in isolation; exact
    rng = np.random.default_rng(0)
    a, b = _t(rng, (64, 64), dev, ints=True), _t(rng, (64, 64), dev, ints=True)
    out, ran, plan = _run(matmul_atb, a, b)
    assert ran == ["wgmma"] and plan[:4] == ("wgmma", 64, 64, 1) and plan.ctas == 1
    assert torch.equal(out, matmul_atb_plain(a, b))
    # two M boxes (a 128-row tile) and a 256-wide B, still one chunk
    a, b = _t(rng, (64, 128), dev, ints=True), _t(rng, (64, 256), dev, ints=True)
    out, ran, plan = _run(matmul_atb, a, b)
    assert ran == ["wgmma"] and torch.equal(out, matmul_atb_plain(a, b)), plan


def test_dense_ragged_k(dev):
    # K cut inside a 64-deep chunk (TMA reads zeros past it), M and N cut
    # inside a tile; integers exact, then random data at 1e-2
    for K, M, N, ints in ((1000, 72, 136, True), (4099, 128, 64, True),
                          (25088, 512, 128, False), (1568, 2048, 512, False)):
        rng = np.random.default_rng(K)
        a, b = _t(rng, (K, M), dev, ints=ints), _t(rng, (K, N), dev, ints=ints)
        out, ran, plan = _run(matmul_atb, a, b)
        ref = matmul_atb_plain(a, b)
        assert ran == ["wgmma"], plan
        assert torch.equal(out, ref) if ints else _err(out, ref) <= 1e-2, (K, M, N, plan)


def test_gather_3x3_with_padding(dev):
    # the weight gradient's gather: the 3x3 taps' padding rows at the image
    # edges, channels past C inside a 64-wide box (C = 24), several images
    # per chunk (7x7), K ragged, a padded 1x1 (the gather, not the dense
    # form); integers exact, then the res2 3x3 at 1e-2
    for n, h, c, oc, k, p, ints in ((2, 9, 24, 40, 3, 1, True), (3, 7, 128, 256, 3, 1, True),
                                    (2, 14, 64, 64, 3, 1, True), (2, 11, 64, 72, 3, 0, True),
                                    (2, 7, 64, 64, 1, 1, True), (8, 56, 64, 64, 3, 1, False)):
        rng = np.random.default_rng(n * h + c)
        oh = h + 2 * p - k + 1
        x, dy = _t(rng, (n, h, h, c), dev, ints=ints), _t(rng, (n, oh, oh, oc), dev, ints=ints)
        out, ran, plan = _run(conv2d_bck_filts, x, dy, pad=(p, p))
        ref = conv2d_bck_filts_plain(x, dy, pad=(p, p))
        assert ran == ["wgmma"] and out.shape == (k, k, c, oc), plan
        assert torch.equal(out, ref) if ints else _err(out, ref) <= 1e-2, (n, h, c, oc, plan)


def test_split_k_bit_equal(dev):
    # res2's 1x1 at batch 8 (K = 25,088) and its 3x3: many splits, each
    # summed in order by the reduction, so two calls agree bit for bit
    rng = np.random.default_rng(1)
    x, dy = _t(rng, (8, 56, 56, 64), dev), _t(rng, (8, 56, 56, 64), dev)
    for p in (0, 1):  # the 1x1, then the 3x3 (x and dY both 56x56)
        out, ran, plan = _run(conv2d_bck_filts, x, dy, pad=(p, p))
        assert ran == ["wgmma"] and plan.split > 1, plan
        assert torch.equal(out, conv2d_bck_filts(x, dy, pad=(p, p)))
    a, b = x.reshape(-1, 64), dy.reshape(-1, 64)
    out, ran, plan = _run(matmul_atb, a, b)
    assert ran == ["wgmma"] and plan.split > 1 and torch.equal(out, matmul_atb(a, b))


def test_wmma_and_fma_paths(dev):
    # M % 8 != 0 (C = 19, 77) or N % 8 != 0: the WMMA loop, chosen by shape;
    # f32: the FMA loop, 1e-5
    rng = np.random.default_rng(2)
    for K, M, N in ((1000, 77, 130), (130, 200, 9)):
        a, b = _t(rng, (K, M), dev), _t(rng, (K, N), dev)
        out, ran, plan = _run(matmul_atb, a, b)
        assert ran == ["mma"] and _err(out, matmul_atb_plain(a, b)) <= 1e-2, plan
    x, dy = _t(rng, (3, 7, 7, 19), dev), _t(rng, (3, 7, 7, 77), dev)
    out, ran, plan = _run(conv2d_bck_filts, x, dy, pad=(0, 0))
    assert ran == ["mma"] and _err(out, conv2d_bck_filts_plain(x, dy, pad=(0, 0))) <= 1e-2
    x, dy = _t(rng, (2, 9, 9, 64), dev, torch.float32), _t(rng, (2, 9, 9, 64), dev, torch.float32)
    out, ran, plan = _run(conv2d_bck_filts, x, dy, pad=(1, 1))
    assert ran == ["fma"] and _err(out, conv2d_bck_filts_plain(x, dy, pad=(1, 1))) <= 1e-5


def _nan_rows(rng, shape, dev, ints=False):
    """A seeded bf16 (K, N) as copy_rows' view of rows of a multiple of 8
    elements, the padding past N filled with NaN."""
    b = copy_rows(_t(rng, shape, dev, ints=ints), BF16)
    b.as_strided((shape[0], b.stride(0)), b.stride())[:, shape[1]:] = float("nan")
    return b


@pytest.mark.parametrize("N", [84, 126, 500, 1002])
def test_edge_route(dev, N):
    # fc1000's (tp=2) wgrad x^T @ dY (K = 32 images) at N = 500 and the
    # other even N % 8 != 0: B by TMA at ldb, the columns past N as zeros,
    # the f32 pairs masked at the edge; integers exact, random data at 1e-2;
    # a dense B of the same shape stays on the WMMA loop
    M, K = 2048, 32
    for ints in (True, False):
        rng = np.random.default_rng(N + ints)
        a, b = _t(rng, (K, M), dev, ints=ints), _nan_rows(rng, (K, N), dev, ints)
        assert b.stride(0) == cdiv(N, 8) * 8
        out, ran, plan = _run(matmul_atb, a, b)
        ref = matmul_atb_plain(a, b)
        assert ran == ["wgmma_edge"] and plan.path == "wgmma_edge", plan
        assert bool(torch.isfinite(out).all()), plan
        assert torch.equal(out, ref) if ints else _err(out, ref) <= 1e-2, (N, plan)
    out, ran, plan = _run(matmul_atb, a, b.contiguous())
    assert ran == ["mma"] and _err(out, ref) <= 1e-2, plan


def test_edge_split_k_bit_equal(dev):
    # deep K over few output tiles: the plan splits K, the reduction sums
    # the splits in one order, so two launches agree bit for bit
    for M, N, K in ((128, 126, 8192), (72, 20, 2000), (2048, 500, 4096)):
        rng = np.random.default_rng(M + N)
        a, b = _t(rng, (K, M), dev), _nan_rows(rng, (K, N), dev)
        out, ran, plan = _run(matmul_atb, a, b)
        assert ran == ["wgmma_edge"] and plan.split > 1, plan
        assert _err(out, matmul_atb_plain(a, b)) <= 1e-2, (M, N, K, plan)
        assert torch.equal(out, matmul_atb(a, b))


def _atb_entry(a, b, out, ws, M, N, K, plan, ldb, gather=0, path=None):
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import PATH_CODES
    g = (7, 7, 7, 7, 1, 1, 0, 0) if gather else (0, 0, 0, 0, 1, 1, 0, 0)
    return build.load().lib.boda_atb(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                     None if ws is None else ws.data_ptr(), M, N, K,
                                     plan.split, plan.chunk, gather, *g, 1,
                                     PATH_CODES[path or plan.path], plan.bm, plan.bn, ldb,
                                     build.stream_ptr(a))


@pytest.mark.parametrize("N", [126, 500])
def test_edge_writes_the_output_and_nothing_past_it(dev, N):
    # the C entry on an output buffer one 64-element run longer than M x N,
    # filled with NaN: every element of M x N written, the run past it left
    # as it was; once on one split and once split-K (the reduction's store)
    from boda_tpu_torch.ops.kernels.bconv import atb_workspace, plan_atb
    M = 2048
    for K in (32, 4096):
        rng = np.random.default_rng(N + K)
        a, b = _t(rng, (K, M), dev), _nan_rows(rng, (K, N), dev)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        plan = plan_atb(M, N, K, 1, sms, BF16, True, False, b.stride(0))
        assert plan.path == "wgmma_edge" and (plan.split > 1) == (K > 32), plan
        buf = torch.full((M * N + 64,), float("nan"), dtype=torch.float32, device=dev)
        ws = atb_workspace(plan, 1, M, N, dev)
        assert _atb_entry(a, b, buf, ws, M, N, K, plan, b.stride(0)) == 0
        torch.cuda.synchronize()
        assert bool(torch.isfinite(buf[:M * N]).all()) and bool(buf[M * N:].isnan().all())
        assert _err(buf[:M * N].view(M, N), matmul_atb_plain(a, b)) <= 1e-2, (K, plan)


def test_edge_refusals(dev):
    # the C entry runs wgmma_edge on the dense form with N % 8 != 0 and
    # even and B's rows a multiple of 8 elements; a gather, an N % 8 == 0,
    # an odd N, an ldb off 8 or below N are refused, never rerouted
    from boda_tpu_torch.ops.kernels.bconv import AtbPlan
    rng = np.random.default_rng(3)
    a, b = _t(rng, (49, 64), dev), _t(rng, (49, 136), dev)
    out = torch.empty((64 * 136,), dtype=torch.float32, device=dev)
    plan = AtbPlan("wgmma_edge", 64, 64, 1, 64, 1)
    assert _atb_entry(a, b, out, None, 64, 126, 49, plan, 128) == 0
    torch.cuda.synchronize()
    for N, ldb, gather in ((126, 126, 1), (128, 128, 0), (125, 128, 0), (126, 126, 0),
                           (126, 120, 0)):
        assert _atb_entry(a, b, out, None, 64, N, 49, plan, ldb, gather) != 0, (N, ldb, gather)
