"""K8's route and plan by shape (ops/kernels/pool.py:route, plan) and K9's
plan (ops/kernels/elementwise.py:plan), chosen before the launch. The
ResNet-50 b32 fused forward's two pools are taken from the port's zoo and
fused engine on the CPU (chip_smoke.py's own extraction). The kernels
themselves, and the way they split a plan's work among their blocks, run
on the card: tests/test_torch_cuda_pool.py runs every route and path on
outputs filled with NaN beforehand, so that an output no block wrote
fails."""

import pytest
import torch

import chip_smoke
from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import load_net
from boda_tpu_torch.ops.kernels import elementwise as elt
from boda_tpu_torch.ops.kernels import pool
from boda_tpu_torch.utils.lexp import parse_lexp

BF16 = torch.bfloat16


def _pads(h, k, s, oy):
    """caffe's ceil-mode pads (top, bottom) of chip_smoke.py's pool signatures"""
    return (0, max(0, (oy - 1) * s + k - h))


def test_b32_fused_pools_take_rows_and_window():
    pipe, _ = load_net("resnet50", img=32)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16", fuse_block=True, device="cpu",
               tune=parse_lexp(chip_smoke.FUSED_TUNE))
    eng.init(pipe)
    _, pools, _ = chip_smoke.fused_shapes(pipe, eng)
    assert pools == {sig: 1 for sig in chip_smoke.POOL_B32_ROUTES}
    for (n, h, c, k, s, oy, avg), want in chip_smoke.POOL_B32_ROUTES.items():
        assert pool.route(h, c, (k, k), (s, s), oy, oy, avg, BF16) == want
        p = pool.plan(n, h, h, c, (k, k), (s, s), oy, oy, avg, BF16)
        assert p.route == want
        if want == "rows":  # pool1: a ring of 3 input rows, 3 blocks per SM
            assert (p.slots, p.blocks) == (3, 3 * pool.SMS)
            assert 3 * (p.smem + 1024) <= pool.SM_SMEM
        else:  # pool5: 32 lanes x 8 slices, a block per image and 256 channels
            assert (p.lanes, p.slices, p.blocks) == (32, 8, n * c // 256)


@pytest.mark.parametrize("c,dtype,aligned", [(64, torch.float32, True), (12, BF16, True),
                                             (64, BF16, False)],
                         ids=["f32", "c12", "misaligned"])
def test_other_shapes_take_thread(c, dtype, aligned):
    for h, k, s, oy in ((112, 3, 2, 56), (7, 7, 1, 1)):
        p = pool.plan(32, h, h, c, (k, k), (s, s), oy, oy, k == 7, dtype, aligned)
        assert pool.route(h, c, (k, k), (s, s), oy, oy, k == 7, dtype, aligned) == "thread"
        cpt = 8 if dtype == BF16 and c % 8 == 0 and aligned else 1
        assert p == pool.PoolPlan("thread", -(-32 * oy * oy * c // cpt // 256), 0, 0, 0, 0)
    # a 3x3 at stride 1 is neither a strided small window nor a large one
    assert pool.route(9, 64, (3, 3), (1, 1), 9, 9, False, BF16) == "thread"


# (n, h, w, c, k, s, oy, ox, avg): pool1 at b32 (its last window clipped by
# ceil mode), the same clipped class at 14x14, a 2x2 s2 avg, and an odd
# plane with shares that cross images
_ROWS = [(32, 112, 112, 64, (3, 3), (2, 2), 56, 56, False),
         (2, 14, 14, 16, (3, 3), (2, 2), 7, 7, True),
         (3, 12, 12, 16, (2, 2), (2, 2), 6, 6, True),
         (2, 31, 17, 8, (3, 3), (2, 2), 15, 8, False)]


def test_rows_plans_fit_and_agree_with_route():
    for n, h, w, c, k, s, oy, ox, avg in _ROWS:
        assert pool.route(w, c, k, s, oy, ox, avg, BF16) == "rows"
        pad_y = _pads(h, k[0], s[0], oy)
        # the last window hangs over the bottom edge (ceil mode) where a pad is
        assert (oy - 1) * s[0] + k[0] - h == pad_y[1]
        plans = [(pool.plan(n, h, w, c, k, s, oy, ox, avg, BF16), pool.SMS)] + [
            (pool.rows_plan(n, w, c, k, oy, ox, avg, slots, sms), sms)
            for slots in (1, 2, 5) for sms in (132, 4, 1)]
        for p, sms in plans:
            assert p.route == "rows" and p.smem <= pool.BLOCK_SMEM
            assert p.smem == pool.rows_smem(w, c, k, ox, avg, p.slots)
            # no idle block (one output row each at least), and the blocks
            # that share an SM fit its shared memory
            assert 1 <= p.blocks <= n * oy
            assert -(-p.blocks // sms) * (p.smem + 1024) <= pool.SM_SMEM
    # route and plan agree on every 3x3 s2 shape, the ring sized for the real
    # avg: at C = 2048 and W 10-14 a max pool's ring fits and an avg's does not
    for c in (8, 64, 512, 2048):
        for w in range(3, 40):
            for avg in (False, True):
                ox = (w - 3 + 1) // 2 + 1
                r = pool.route(w, c, (3, 3), (2, 2), ox, ox, avg, BF16)
                assert pool.plan(2, w, w, c, (3, 3), (2, 2), ox, ox, avg, BF16).route == r
                if c == 2048 and 10 <= w <= 14:
                    assert r == ("thread" if avg else "rows"), (w, avg)


def test_window_plans_split_each_window():
    for c, k, want in ((2048, 7, (32, 8)), (256, 7, (32, 8)), (24, 7, (3, 49)),
                       (64, 4, (8, 16))):
        p = pool.plan(2, k, k, c, (k, k), (1, 1), 1, 1, True, BF16)
        assert p.route == "window" and (p.lanes, p.slices) == want
        # at most one slice per window pixel, all in one block of <= 256 threads
        assert p.lanes * p.slices <= 256 and p.slices <= k * k
        assert p.blocks == 2 * -(-c // 8 // p.lanes)


def test_eltwise_plan_by_size_and_alignment():
    b32 = 32 * 256 * 56 * 56
    for dtype in (BF16, torch.float32):
        vec = 16 // dtype.itemsize
        stage = elt.RING_STAGE_BYTES // dtype.itemsize
        for n in (1, 15, 16, stage - 1, stage, stage + 1, 100_003, b32):
            p = elt.plan(n, dtype, True)
            assert p.path == ("ring" if n >= vec else "scalar"), (n, p)
            if p.path == "ring":
                assert p.stage_bytes == elt.RING_STAGE_BYTES and p.stage_bytes % 16 == 0
                assert p.stages == elt.RING_STAGES
                # no more blocks than chunks of one stage: none idles
                assert 1 <= p.blocks <= min(elt.SMS * elt.RING_PER_SM,
                                            -(-(n // vec) // (p.stage_bytes // 16)))
                assert p.smem == elt.ring_smem(2)
                assert elt.RING_PER_SM * (p.smem + 1024) <= pool.SM_SMEM
        assert elt.plan(b32, dtype, True).blocks == elt.SMS * elt.RING_PER_SM
        assert elt.plan(b32, dtype, True, sms=4).blocks == 4 * elt.RING_PER_SM
        # misaligned operands take the scalar path: one grid-stride loop
        for n in (1, 777, b32):
            p = elt.plan(n, dtype, False)
            assert p.path == "scalar" and (p.stage_bytes, p.stages, p.smem) == (0, 0, 0)
            assert 1 <= p.blocks <= elt.SMS * 32
    # the unary funcs stage one operand
    assert elt.plan(10**6, BF16, True, nin=1).smem == elt.ring_smem(1) < elt.ring_smem(2)
