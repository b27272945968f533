"""K6 (csrc/block.cu) on its wgmma route: the three products of the fused
bottleneck on wgmma with A from registers (ldmatrix fragments of x, of h1
at a tap's row offset, of h2) and the weights by TMA, against the mma.sync
loop (the same values in a misaligned buffer) and the plain version on the
card, each case asserting its route.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on
the machine with the card from the repo root with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_block.py``.
Tolerances: small-integer inputs give exact products and exact f32 sums,
and h1, h2 and y round to bf16 from the same f32 values on every route, so
those cases match bit for bit; random inputs within 1e-2 of max|ref| in
bf16 (h1, h2 and y each rounded once; sums in another order), 1e-5 in f32.
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.ops.kernels import build
from boda_tpu_torch.ops.kernels.block import bottleneck, bottleneck_plain
from boda_tpu_torch.ops.kernels.block import plan as block_plan
from boda_tpu_torch.ops.kernels.common import PATH_CODES

pytestmark = pytest.mark.cuda

BF16 = torch.bfloat16
# the ResNet-50 b32 fused forward's identity blocks: (n, h, c, k)
B32 = [(32, 56, 256, 64), (32, 28, 512, 128), (32, 14, 1024, 256), (32, 7, 2048, 512)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


def _ops(n, h, c, k, dev, dt=BF16, ints=False, seed=0):
    """x, w1, b1, w2, b2, w3, b3; ints: x in -3..3, weights and biases in
    -1..1 (the sums stay far below 2^24: exact in f32)."""
    rng = np.random.default_rng(seed)
    shapes = ((n, h, h, c), (c, k), (k,), (3, 3, k, k), (k,), (k, c), (c,))
    scales = (1.0, c ** -0.5, 0.1, (9 * k) ** -0.5, 0.1, k ** -0.5, 0.1)
    out = []
    for i, (shape, sc) in enumerate(zip(shapes, scales)):
        v = (rng.integers(-3 if i == 0 else -1, 4 if i == 0 else 2, shape) if ints
             else rng.standard_normal(shape) * sc)
        out.append(torch.from_numpy(v.astype(np.float32)).to(dev, dt))
    return out


def _err(out, ref):
    return float((out.float() - ref.float()).abs().max()) / \
        max(float(ref.float().abs().max()), 1e-30)


def _run(ops):
    """One K6 launch: (output, the route it ran, its plan)."""
    paths = dict(bottleneck.paths)
    out = bottleneck(*ops)
    torch.cuda.synchronize()
    ran = [p for p in paths if bottleneck.paths[p] == paths[p] + 1]
    return out, ran, bottleneck.last_plan


def _misaligned(t):
    """t's values in a buffer 2 bytes off 16-byte alignment: K6 routes an
    operand there to the mma.sync loop (element copies)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_one_tile_register_a(dev):
    # one 8x8 tile: phase A's two m64 blocks of staged x, phase B's 80 rows on
    # two blocks at 9 tap offsets into h1, phase C's one block split across
    # the warpgroups (one idle at C = 64), m64n64 wgmmas; then C = 192, K =
    # 128, which the plan cuts into four 6x6 tiles (a lone m64 block splits
    # its 128 columns between the warpgroups): a last column chunk half past
    # C
    for c, k, one in ((64, 64, True), (256, 64, True), (192, 128, False)):
        ops = _ops(1, 8, c, k, dev, ints=True, seed=c + k)
        out, ran, plan = _run(ops)
        assert ran == ["wgmma"] and (plan[:4] == ("wgmma", 8, 1, 1) or not one), plan
        ref, ran_mma, _ = _run([_misaligned(ops[0])] + ops[1:])
        assert ran_mma == ["mma"]
        assert torch.equal(out, ref), (c, k)
        assert torch.equal(out, bottleneck_plain(*ops)), (c, k)


def test_b32_stages_vs_plain(dev):
    # the four stage shapes of the fused b32 forward, at their own plans
    for n, h, c, k in B32:
        ops = _ops(n, h, c, k, dev, seed=h)
        out, ran, plan = _run(ops)
        assert ran == ["wgmma"], plan
        assert out.shape == (n, h, h, c) and bool(torch.isfinite(out.float()).all())
        assert _err(out, bottleneck_plain(*ops)) <= 1e-2, (h, plan)


def test_res5_cluster_of_4(dev):
    # res5's 32 one-tile images, each tile on a cluster of 4 blocks that
    # gather h1's and h2's column slices from each other; exact on integers
    ops = _ops(32, 7, 2048, 512, dev, ints=True, seed=5)
    out, ran, plan = _run(ops)
    assert ran == ["wgmma"] and plan.cluster == 4 and plan.blocks == 128, plan
    assert plan == block_plan(32, 7, 7, 2048, 512, torch.bfloat16)  # the launch's own plan
    assert torch.equal(out, bottleneck_plain(*ops))


def test_ragged_k_on_mma_and_f32_on_fma(dev):
    # K = 72 (no whole 64-deep chunks): mma.sync, and the C side refuses
    # the wgmma route for it; f32: the FMA loop
    ops = _ops(2, 14, 256, 72, dev, seed=72)
    out, ran, plan = _run(ops)
    assert ran == ["mma"] and _err(out, bottleneck_plain(*ops)) <= 1e-2, plan
    with torch.cuda.device(dev):
        rc = build.load().lib.boda_bottleneck(*(t.data_ptr() for t in ops), out.data_ptr(),
                                              2, 14, 14, 256, 72, 1, PATH_CODES["wgmma"],
                                              None, build.stream_ptr(out))
    assert rc != 0
    ops = _ops(2, 14, 256, 64, dev, dt=torch.float32, seed=32)
    out, ran, plan = _run(ops)
    assert ran == ["fma"] and _err(out, bottleneck_plain(*ops)) <= 1e-5, plan


def test_two_calls_bit_equal(dev):
    for n, h, c, k in (B32[0], B32[3]):
        ops = _ops(n, h, c, k, dev, seed=h + 1)
        first, ran, _ = _run(ops)
        assert ran == ["wgmma"] and torch.equal(first, _run(ops)[0])
