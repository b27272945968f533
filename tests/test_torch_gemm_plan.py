"""The GEMM core's tile plan (ops/kernels/common.py:plan_gemm) at the ResNet-50
batch-32 bf16 forward's 54 GEMM and conv calls, taken from the port's zoo and
lowering on the CPU (chip_smoke.py's own extraction); and the split-K
arithmetic (matmul_splitk_plain, the partial sums in the kernel's order)
against the plain matmul, f32 within 1e-5 of max|ref|. The kernels
themselves run on the card: tests/test_torch_cuda_gemm.py."""

import numpy as np
import pytest
import torch

import chip_smoke
from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import load_net
from boda_tpu_torch.ops.kernels.common import (SMEM_LIMIT, WGMMA_CHUNK, cdiv, plan_gemm,
                                               wgmma_smem)
from boda_tpu_torch.ops.kernels.conv import conv2d
from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain, matmul_splitk_plain

SMS = 132  # an H100 SXM
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def calls():
    """(M, N, K, conv C or None) of each GEMM and conv launch of one forward."""
    pipe, _ = load_net("resnet50", img=32)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16", device="cpu")
    eng.init(pipe)
    gemm, conv = chip_smoke.layer_shapes(pipe, eng)
    out = []
    for (M, K, N, _, _), count in gemm.items():
        out += [(M, N, K, None)] * count
    for (n, h, c, oc, k, s, p, _, _), count in conv.items():
        oh = (h + 2 * p - k) // s + 1
        out += [(n * oh * oh, oc, k * k * c, c)] * count
    assert len(out) == 54  # 53 convs and fc1000
    return out


def test_plans_cover_the_problem_and_fit_in_shared_memory(calls):
    for M, N, K, c in calls:
        plan = plan_gemm(M, N, K, SMS, BF16, conv_c=c)
        if c == 3:  # the stem: below
            continue
        assert plan.path == "wgmma", (M, N, K, c, plan)
        tiles = cdiv(M, plan.bm) * cdiv(N, plan.bn)
        assert tiles * plan.bm * plan.bn >= M * N
        chunks = cdiv(K, WGMMA_CHUNK)
        assert chunks % plan.split == 0 and plan.split <= chunks, plan
        assert plan.ctas == min(tiles * plan.split, SMS)  # persistent blocks
        assert wgmma_smem(plan.bm, plan.bn) <= SMEM_LIMIT
        assert plan.bm in (64, 128) and plan.bn in (64, 128, 256)


def test_narrow_problems_get_narrow_tiles(calls):
    assert any(N == 64 for _, N, _, _ in calls)
    for M, N, K, c in calls:
        plan = plan_gemm(M, N, K, SMS, BF16, conv_c=c)
        if plan.path == "wgmma":
            assert plan.bn == 64 or N > 64, (M, N, K, plan)
            assert plan.bm == 64 or M > 64, (M, N, K, plan)
    # fc1000 at batch 32: 16 tiles of 64x64 over K = 2,048, so K is split
    fc = plan_gemm(32, 1000, 2048, SMS, BF16)
    assert (fc.bm, fc.bn, fc.split) == (64, 64, 8) and fc.ctas == 128


# Plans the cost model must pick: the fastest of every plan, or within 3% of
# it, in scripts/torch_gemm_plans.py's sweep (PERF.md §6): (M, N, K, conv
# C) -> (bm, bn, split). Each beat the first planner's choice (128x128 tiles
# split to fill all 132 SMs) by 15-40%.
_MEASURED = {(6272, 256, 2304, 256): (128, 256, 2), (1568, 512, 4608, 512): (128, 256, 4),
             (1568, 512, 1024, None): (64, 128, 1), (6272, 256, 512, None): (128, 128, 1),
             (1568, 2048, 1024, None): (128, 256, 1), (100352, 64, 64, None): (128, 64, 1),
             (6272, 1024, 512, None): (128, 128, 1)}


def test_work_items_fill_the_sms_and_follow_the_measurements(calls):
    split = 0
    for M, N, K, c in calls:
        plan = plan_gemm(M, N, K, SMS, BF16, conv_c=c)
        if plan.path != "wgmma":
            continue
        # a work item for at least 2/3 of the SMs, or K split to the end
        assert plan.ctas >= 2 * SMS / 3 or plan.split == min(16, cdiv(K, WGMMA_CHUNK)), \
            (M, N, K, plan)
        split += plan.split > 1
    assert split > 0  # res4/res5's 3x3s and fc1000 split K
    for (M, N, K, c), want in _MEASURED.items():
        assert (M, N, K, c) in calls
        assert plan_gemm(M, N, K, SMS, BF16, conv_c=c)[1:4] == want, (M, N, K, c)


def test_stem_odd_shapes_and_f32_take_the_other_paths():
    # the gen forward's 7x7 s2 stem at C = 3: no 16-byte rows -> mma.sync
    assert plan_gemm(32 * 112 * 112, 64, 147, SMS, BF16, conv_c=3).path == "mma"
    assert plan_gemm(77, 100, 147, SMS, BF16).path == "mma"     # K, N % 8
    assert plan_gemm(1000, 100, 64, SMS, BF16).path == "mma"    # N % 8
    assert plan_gemm(1000, 64, 64, SMS, BF16, conv_c=12).path == "mma"
    assert plan_gemm(1000, 64, 64, SMS, BF16, aligned=False).path == "mma"
    # the fused stem's fold (C = 16) and the ragged card-test shapes take wgmma
    assert plan_gemm(32 * 112 * 112, 64, 256, SMS, BF16, conv_c=16).path == "wgmma"
    assert plan_gemm(1000, 24, 40, SMS, BF16).path == "wgmma"
    f32 = plan_gemm(4096, 4096, 4096, SMS, torch.float32)
    assert f32 == ("fma", 64, 64, 1, 64 * 64)
    with pytest.raises(ValueError):
        plan_gemm(64, 64, 64, SMS, torch.float16)


def test_plan_is_a_pure_function(calls):
    first = [plan_gemm(*sig[:3], SMS, BF16, conv_c=sig[3]) for sig in calls]
    plan_gemm.cache_clear()
    fresh = [plan_gemm.__wrapped__(*sig[:3], SMS, BF16, conv_c=sig[3]) for sig in calls]
    assert first == fresh
    # fewer SMs never ask for more splits
    for M, N, K, c in calls:
        assert plan_gemm(M, N, K, 66, BF16, conv_c=c).split <= \
            plan_gemm(M, N, K, SMS, BF16, conv_c=c).split


# fc1000 at batch 32; ragged M and N, and K = 1,000 (a short last chunk)
@pytest.mark.parametrize("M,K,N,res", [(32, 2048, 1000, False), (77, 1000, 136, True)])
def test_split_k_emulation_matches_plain(M, K, N, res):
    rng = np.random.default_rng(M + K)
    a = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    b = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5).astype(np.float32))
    bias = torch.from_numpy((rng.standard_normal(N) * 0.1).astype(np.float32))
    r = torch.from_numpy(rng.standard_normal((M, N)).astype(np.float32)) if res else None
    ref = matmul_plain(a, b, bias, relu=True, residual=r)
    chunks = cdiv(K, WGMMA_CHUNK)
    for split in [d for d in range(1, chunks + 1) if chunks % d == 0]:
        got = matmul_splitk_plain(a, b, bias, relu=True, residual=r, split=split)
        err = float((got - ref).abs().max())
        assert err <= 1e-5 * float(ref.abs().max()), (split, err)
    # one split is the plain version's own sum
    assert torch.equal(matmul_splitk_plain(a, b, bias, relu=True, residual=r), ref)
    # a CPU tensor runs the plain version: no launch, no path, no plan
    before = (matmul.launches, dict(matmul.paths), conv2d.launches, dict(conv2d.paths))
    matmul(a, b, bias, relu=True, residual=r)
    conv2d(a[None, None, :1, :8], b[None, None, :8, :8], bias[:8])
    assert (matmul.launches, matmul.paths, conv2d.launches, conv2d.paths) == before
