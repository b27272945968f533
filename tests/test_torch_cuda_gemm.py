"""The GEMM core's wgmma paths (csrc/gemm.cuh) against the plain versions, on
the card: K1 (matmul) and K2/K3 (conv2d, conv2d_bck_in) at the plans the
shapes get, each case asserting which path ran; K2's narrow route
(``wgmma_narrow``, C % 8 != 0) at C = 1, 3, 5 and 12, strides 1 and 2, padding
0-3, odd sizes, M off the 64-row tile, a residual, split-K, an x off 16-byte
alignment, and replayed in a CUDA graph; the edge route (``wgmma_edge``, N %
8 != 0 and even) at N = 20, 84, 126 and 500 on K1 and K2, with and without a
residual and ReLU, split-K bit-equal across launches, a dense B (the
wrapper's padded copy, counted) against the padded view the engine holds,
replayed in a CUDA graph, and the C entry's refusals; K1's GEMM with K % 8
!= 0 on A's rows padded to 16 bytes (``copy_rows``, as the training step's
fc writes dY: fc1000's (tp=2) dgrad, K = 500) on the wgmma route at
(32, K, 2048) for K = 4, 20, 500 and 1004, the padding filled with NaN,
split-K bit-equal, a dense A on the mma.sync loop, and the refusals of an
lda below K or off 8.

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
from boda_tpu_torch.ops.kernels.common import cdiv, copy_rows, pad_rows, plan_gemm
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


def _gemm(dev, M, K, N, *, res=False, relu=False, seed=0, padded=False):
    """One matmul launch against matmul_plain; returns (out, plan, path run).
    padded: b in rows of a multiple of 8 elements (``pad_rows``)."""
    rng = np.random.default_rng(seed)
    a, b = _t(rng, (M, K), dev), _t(rng, (K, N), dev, K ** -0.5)
    if padded:
        b = pad_rows(b)
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


def _conv(dev, n, h, c, oc, k, s, p, *, res=False, relu=True, seed=0, x_off=0,
          padded=False):
    """One conv2d launch against conv2d_plain; x_off: x starts that many
    elements into its allocation; padded: w in the engine's padded HWIO
    rows (``pad_rows``)."""
    rng = np.random.default_rng(seed)
    x = _t(rng, (n * h * h * c + x_off,), dev)[x_off:].view(n, h, h, c)
    w = _t(rng, (k, k, c, oc), dev, (k * k * c) ** -0.5)
    if padded:
        w = pad_rows(w)
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
    # C = 3 cannot take 16-byte gathers: the wgmma ring with A built element
    # by element (wgmma_narrow), chosen by shape, within 1e-2 of plain
    _, plan, ran, _ = _conv(dev, 2, 32, 3, 64, 7, 2, 3)
    assert ran == ["wgmma_narrow"] and plan.path == "wgmma_narrow"
    # N % 8 != 0 keeps the mma.sync loop
    _, plan, ran, _ = _conv(dev, 2, 13, 3, 20, 7, 2, 3)
    assert ran == ["mma"] and plan.path == "mma"
    # the fold's C = 16 (4 taps per 64-deep chunk) and a strided 3x3 take wgmma
    for sig in ((2, 30, 16, 64, 4, 1, 0), (2, 15, 128, 128, 3, 2, 1), (2, 14, 24, 40, 3, 1, 1)):
        _, plan, ran, _ = _conv(dev, *sig, res=sig[2] == 24, seed=sig[2])
        assert ran == ["wgmma"], (sig, plan)


# (n, h, c, oc, k, s, p, residual): C = 1, 3, 5 and 12; strides 1 and 2;
# padding 0-3; odd H and W; M = n * oh * ow off the 64-row tile (578, 147,
# 338, 242, 81, 72 rows)
_NARROW = [(2, 17, 1, 64, 3, 1, 1, False), (3, 13, 3, 64, 7, 2, 3, True),
           (2, 25, 5, 72, 5, 2, 2, True), (2, 13, 12, 136, 3, 1, 0, False),
           (1, 9, 5, 64, 7, 1, 3, True), (2, 11, 3, 256, 3, 2, 1, False)]


@pytest.mark.parametrize("sig", _NARROW)
def test_narrow_route(dev, sig):
    n, h, c, oc, k, s, p, res = sig
    out, plan, ran, again = _conv(dev, n, h, c, oc, k, s, p, res=res, seed=c + k)
    assert ran == ["wgmma_narrow"] and plan.path == "wgmma_narrow" and plan.bm == 64, plan
    if plan.split > 1:  # the split's sum in a fixed order: bit-equal across calls
        assert torch.equal(out, again())
    # no ReLU, with the same epilogue terms
    _, _, ran, _ = _conv(dev, n, h, c, oc, k, s, p, res=res, relu=False, seed=c)
    assert ran == ["wgmma_narrow"]


def test_narrow_tile_widths(dev):
    # each of the narrow kernel's tiles (64 rows; 64 or 128 columns),
    # launched past the plan through the C entry point, against plain
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import PATH_CODES
    rng = np.random.default_rng(3)
    n, h, c, oc, k, s, p = 2, 19, 3, 256, 5, 2, 2
    oh = (h + 2 * p - k) // s + 1
    x, w = _t(rng, (n, h, h, c), dev), _t(rng, (k, k, c, oc), dev, (k * k * c) ** -0.5)
    bias, r = _t(rng, (oc,), dev, 0.1), _t(rng, (n, oh, oh, oc), dev)
    ref = conv2d_plain(x, w, bias, stride=(s, s), pad=(p, p), relu=True, residual=r)
    for bn in (64, 128):
        out = torch.empty_like(ref)
        rc = build.load().lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                          r.data_ptr(), out.data_ptr(), None, n, h, h, c, oh,
                                          oh, oc, k, k, s, s, p, p, 1, 1,
                                          PATH_CODES["wgmma_narrow"], 64, bn, 1, oc,
                                          build.stream_ptr(x))
        build.check(rc, f"narrow 64x{bn}")
        torch.cuda.synchronize()
        assert _err(out, ref) <= 1e-2, bn
    # a 128-row or 256-column tile is not a narrow plan: refused, never rerouted
    for bm, bn in ((128, 64), (64, 256)):
        rc = build.load().lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(), None,
                                          out.data_ptr(), None, n, h, h, c, oh, oh, oc, k, k, s,
                                          s, p, p, 1, 1, PATH_CODES["wgmma_narrow"], bm, bn, 1,
                                          oc, build.stream_ptr(x))
        assert rc != 0, (bm, bn)


def test_narrow_split_k_and_misaligned_x(dev):
    # 81 rows, K = 245: two tiles, so the plan splits K in 4
    out, plan, ran, again = _conv(dev, 1, 9, 5, 64, 7, 1, 3, res=True)
    assert ran == ["wgmma_narrow"] and plan.split == 4, plan
    assert torch.equal(out, again())
    # x one element past a 16-byte boundary: the fill reads it element by element
    _, plan, ran, _ = _conv(dev, 2, 17, 3, 64, 7, 2, 3, x_off=1)
    assert ran == ["wgmma_narrow"], plan


def test_narrow_replayed_in_a_cuda_graph(dev):
    # the stem at b2: a captured launch replays bit-equal to the eager one
    rng = np.random.default_rng(5)
    x, w = _t(rng, (2, 224, 224, 3), dev), _t(rng, (7, 7, 3, 64), dev, 147 ** -0.5)
    bias = _t(rng, (64,), dev, 0.1)
    kw = dict(stride=(2, 2), pad=(3, 3), relu=True)
    eager = conv2d(x, w, bias, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv2d(x, w, bias, **kw)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    paths = dict(conv2d.paths)
    with torch.cuda.graph(g):
        out = conv2d(x, w, bias, **kw)
    assert conv2d.paths["wgmma_narrow"] == paths["wgmma_narrow"] + 1
    out.fill_(0)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert _err(out, conv2d_plain(x, w, bias, **kw)) <= 1e-2


# (M, K, N) and (n, h, c, oc, k, s, p): N = 20, 84, 126 and 500 (N % 8 != 0,
# even); M off the tiles; ssd300's heads at b1 and b2
_EDGE_GEMMS = [(77, 64, 20), (1000, 256, 84), (300, 512, 126), (32, 2048, 500)]
_EDGE_CONVS = [(2, 9, 8, 20, 3, 1, 1), (2, 19, 64, 84, 3, 1, 1), (1, 10, 128, 126, 3, 1, 1),
               (2, 7, 32, 500, 1, 1, 0), (2, 11, 16, 126, 3, 2, 1)]


@pytest.mark.parametrize("res,relu", [(False, False), (True, True)])
@pytest.mark.parametrize("sig", _EDGE_GEMMS)
def test_edge_gemm(dev, sig, res, relu):
    M, K, N = sig
    for padded in (True, False):
        _, plan, ran, _ = _gemm(dev, M, K, N, res=res, relu=relu, seed=N, padded=padded)
        assert ran == ["wgmma_edge"] and plan.path == "wgmma_edge", plan


@pytest.mark.parametrize("res,relu", [(False, False), (True, True)])
@pytest.mark.parametrize("sig", _EDGE_CONVS)
def test_edge_conv(dev, sig, res, relu):
    _, plan, ran, _ = _conv(dev, *sig, res=res, relu=relu, seed=sig[3], padded=True)
    assert ran == ["wgmma_edge"] and plan.path == "wgmma_edge", plan


def test_edge_split_k_bit_equal(dev):
    # fc1000's (tp=2) slice and ssd300's conv9_2_mbox_conf: few tiles, K
    # split; the reduce sums the splits in one order, so two launches agree
    out, plan, ran, (a, b, bias, _) = _gemm(dev, 32, 2048, 500, padded=True)
    assert ran == ["wgmma_edge"] and plan.split > 1, plan
    assert torch.equal(out, matmul(a, b, bias))
    out, plan, ran, again = _conv(dev, 4, 1, 256, 84, 3, 1, 1, relu=False, padded=True)
    assert ran == ["wgmma_edge"] and plan.split > 1, plan
    assert torch.equal(out, again())


def test_edge_dense_b_gets_a_counted_copy(dev):
    # a dense B with N % 8 != 0: the wrapper launches on a padded copy, and
    # says so; the engine's padded view needs none; both give the same bits
    rng = np.random.default_rng(7)
    x, w = _t(rng, (2, 19, 19, 64), dev), _t(rng, (3, 3, 64, 84), dev, 576 ** -0.5)
    bias = _t(rng, (84,), dev, 0.1)
    copies = conv2d.pad_copies
    dense = conv2d(x, w, bias, pad=(1, 1))
    assert conv2d.pad_copies == copies + 1 and conv2d.last_plan.path == "wgmma_edge"
    view = conv2d(x, pad_rows(w), bias, pad=(1, 1))
    assert conv2d.pad_copies == copies + 1
    assert torch.equal(dense, view)
    a, b = _t(rng, (100, 128), dev), _t(rng, (128, 84), dev, 128 ** -0.5)
    copies = matmul.pad_copies
    out = matmul(a, b)
    assert matmul.pad_copies == copies + 1 and matmul.last_plan.path == "wgmma_edge"
    assert torch.equal(out, matmul(a, pad_rows(b))) and matmul.pad_copies == copies + 1


def test_edge_replayed_in_a_cuda_graph(dev):
    # ssd300's conv4_3_norm_mbox_conf at b4 on its padded filters: a captured
    # launch replays bit-equal to the eager one
    rng = np.random.default_rng(9)
    x, w = _t(rng, (4, 38, 38, 512), dev), pad_rows(_t(rng, (3, 3, 512, 84), dev, 4608 ** -0.5))
    bias = _t(rng, (84,), dev, 0.1)
    kw = dict(pad=(1, 1))
    eager = conv2d(x, w, bias, **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        conv2d(x, w, bias, **kw)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    paths = dict(conv2d.paths)
    with torch.cuda.graph(g):
        out = conv2d(x, w, bias, **kw)
    assert conv2d.paths["wgmma_edge"] == paths["wgmma_edge"] + 1
    out.fill_(0)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert _err(out, conv2d_plain(x, w, bias, **kw)) <= 1e-2


def test_edge_refusals(dev):
    # the C entry runs wgmma_edge only where the plan gives it: N % 8 != 0
    # and even, B's rows a multiple of 8 elements, tiles of at most 128
    # columns; anything else is refused, never rerouted
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import PATH_CODES
    lib, edge = build.load().lib, PATH_CODES["wgmma_edge"]
    rng = np.random.default_rng(4)
    a = _t(rng, (64, 64), dev)
    b = _t(rng, (64, 128), dev)
    out = torch.empty((64, 128), dtype=BF16, device=dev)

    def launch(N, ldb, bm=64, bn=64):
        return lib.boda_gemm(a.data_ptr(), b.data_ptr(), None, None, out.data_ptr(), None,
                             64, N, 64, 0, 1, edge, bm, bn, 1, 64, ldb, build.stream_ptr(a))
    assert launch(84, 88) == 0 and launch(84, 128, 128, 128) == 0
    torch.cuda.synchronize()
    for N, ldb, bm, bn in ((64, 64, 64, 64), (83, 88, 64, 64), (84, 84, 64, 64),
                           (84, 88, 64, 256), (84, 80, 64, 64)):
        assert launch(N, ldb, bm, bn) != 0, (N, ldb, bm, bn)


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


def _nan_rows(rng, shape, dev):
    """A seeded bf16 (M, K) as copy_rows' view of rows of a multiple of 8
    elements, the padding past K filled with NaN: a kernel that read it
    would say so."""
    a = copy_rows(_t(rng, shape, dev), BF16)
    a.as_strided((shape[0], a.stride(0)), a.stride())[:, shape[1]:] = float("nan")
    return a


@pytest.mark.parametrize("K", [4, 20, 500, 1004])
def test_padded_a_rows(dev, K):
    # fc1000's (tp=2) dgrad dY @ W^T at K = 500 and K off 8 below one
    # 64-deep chunk, in it and past several: A read by TMA at lda, the
    # columns past K as zeros; split-K launches agree bit for bit; the same
    # product on a dense A takes the mma.sync loop and agrees with plain too;
    # matmul.padded_a counts the launches on padded rows and no other
    M, N = 32, 2048
    rng = np.random.default_rng(K)
    a, b = _nan_rows(rng, (M, K), dev), _t(rng, (K, N), dev, K ** -0.5)
    assert a.stride(0) == cdiv(K, 8) * 8
    paths, padded = dict(matmul.paths), matmul.padded_a
    out = matmul(a, b)
    torch.cuda.synchronize()
    assert matmul.padded_a == padded + 1
    ran = [p for p in paths if matmul.paths[p] == paths[p] + 1]
    plan = matmul.last_plan
    ref = matmul_plain(a, b)
    assert ran == ["wgmma"] and plan.path == "wgmma", plan
    assert bool(torch.isfinite(out.float()).all()) and _err(out, ref) <= 1e-2, (K, plan)
    assert torch.equal(out, matmul(a, b))
    if K >= 500:
        assert plan.split > 1, plan
    dense = a.contiguous()
    out_d = matmul(dense, b)
    assert matmul.last_plan.path == "mma" and _err(out_d, ref) <= 1e-2
    assert matmul.padded_a == padded + 2


def test_padded_a_refusals(dev):
    # the C entry reads A at lda on every path: it refuses an lda below K,
    # and the wgmma route an lda off 8 elements, never rerouted
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import PATH_CODES
    lib = build.load().lib
    rng = np.random.default_rng(6)
    a, b = _t(rng, (64, 512), dev), _t(rng, (500, 128), dev)
    out = torch.empty((64, 128), dtype=BF16, device=dev)

    def launch(path, lda):
        return lib.boda_gemm(a.data_ptr(), b.data_ptr(), None, None, out.data_ptr(), None,
                             64, 128, 500, 0, 1, PATH_CODES[path], 64, 64, 1, lda, 128,
                             build.stream_ptr(a))
    assert launch("wgmma", 504) == 0 and launch("mma", 500) == 0 and launch("mma", 512) == 0
    torch.cuda.synchronize()
    for path, lda in (("wgmma", 500), ("wgmma", 499), ("mma", 499), ("wgmma_edge", 504)):
        assert launch(path, lda) != 0, (path, lda)
