"""K5's plan (ops/kernels/bconv.py:plan_atb) at the ResNet-50 batch-32
gradient graph's 46 weight gradients, taken from the port's zoo, autodiff
and lowering on the CPU (chip_smoke.py's own extraction), and its path
choice by shape. The kernels themselves run on the card:
tests/test_torch_cuda_atb.py."""

import pytest
import torch

import chip_smoke
from boda_tpu_torch.config import make
from boda_tpu_torch.graph.autodiff import add_bck_ops
from boda_tpu_torch.modes.cnet import load_net
from boda_tpu_torch.ops.kernels.bconv import atb_workspace, plan_atb
from boda_tpu_torch.ops.kernels.common import WGMMA_CHUNK, cdiv

SMS = 132  # an H100 SXM
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def wgrads():
    """(M = C, N = OC, K = n*oh*ow, taps, gathered) of each weight-gradient
    launch of one b32 gradient pass (a 1x1 is the dense form, x as it lies)."""
    pipe, _ = load_net("resnet50", img=32)
    add_bck_ops(pipe)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16", device="cpu")
    eng.init(pipe)
    out = []
    for (n, h, c, oc, k, p), count in chip_smoke.bck_shapes(pipe, eng).items():
        oh = h + 2 * p - k + 1
        out += [(c, oc, n * oh * oh, k * k, k > 1)] * count
    assert len(out) == 46
    return out


def test_every_wgrad_plan_covers_k_on_wgmma(wgrads):
    for M, N, K, taps, gather in wgrads:
        plan = plan_atb(M, N, K, taps, SMS, BF16, True, gather)
        assert plan.path == "wgmma", (M, N, K, taps, plan)
        # splits x chunk cover K exactly: chunks of whole 64-deep steps, the
        # last split the only short one, none empty
        assert plan.chunk % WGMMA_CHUNK == 0 and plan.split >= 1
        assert (plan.split - 1) * plan.chunk < K <= plan.split * plan.chunk, plan
        assert plan.bm in (64, 128) and plan.bn in (64, 128, 256)
        assert plan.bn <= max(64, cdiv(N, 64) * 64), plan
        assert plan.bm == 64 or M > 64, plan  # res2's 64-row outputs take 64-row tiles
        items = cdiv(M, plan.bm) * cdiv(N, plan.bn) * taps * plan.split
        assert plan.ctas == min(items, SMS)  # persistent blocks


def test_work_items_fill_the_sms(wgrads):
    # res2's 64-wide outputs over K = 100,352 split until 2/3 of the SMs
    # have a work item at least; so does every other shape
    for M, N, K, taps, gather in wgrads:
        plan = plan_atb(M, N, K, taps, SMS, BF16, True, gather)
        assert cdiv(M, plan.bm) * cdiv(N, plan.bn) * taps * plan.split >= 2 * SMS // 3, plan
    res2 = plan_atb(64, 64, 100352, 1, SMS, BF16, True, True)
    assert (res2.bm, res2.bn) == (64, 64) and res2.split > 16


def test_workspace_is_sized_for_the_splits(wgrads):
    sizes = set()
    for M, N, K, taps, gather in wgrads:
        plan = plan_atb(M, N, K, taps, SMS, BF16, True, gather)
        ws = atb_workspace(plan, taps, M, N, "cpu")
        if plan.split == 1:
            assert ws is None
        else:
            assert ws.dtype == torch.float32 and ws.numel() == plan.split * taps * M * N
        sizes.add(plan.split == 1)
    assert sizes == {True, False}  # both kinds occur at b32


# (M, N, K, taps, dtype, aligned, the path)
_PATHS = [
    (64, 64, 100352, 9, BF16, True, "wgmma"),
    (24, 40, 162, 9, BF16, True, "wgmma"),      # 16-byte rows, ragged tiles
    (72, 136, 1000, 1, BF16, True, "wgmma"),    # ragged K
    (19, 77, 147, 1, BF16, True, "mma"),        # C % 8 != 0
    (77, 130, 1000, 1, BF16, True, "mma"),
    (200, 9, 130, 1, BF16, True, "mma"),        # N % 8 != 0
    (64, 64, 4096, 1, BF16, False, "mma"),      # a misaligned operand
    (64, 64, 4096, 9, torch.float32, True, "fma"),
]


# (M, N, K, ldb, aligned, the path): K5's edge route, the dense form with an
# even N % 8 != 0 on B rows padded to 16 bytes (fc1000's (tp=2) wgrad, N =
# 500 at ldb 504); a dense B, odd N or M % 8 != 0 stay on the WMMA loop
_EDGE_PATHS = [
    (2048, 500, 32, 504, True, "wgmma_edge"),
    (2048, 84, 32, 88, True, "wgmma_edge"),
    (128, 126, 8192, 128, True, "wgmma_edge"),
    (2048, 500, 32, 500, True, "mma"),          # dense B, N % 8 != 0
    (2048, 499, 32, 504, True, "mma"),          # odd N
    (77, 500, 32, 504, True, "mma"),            # M % 8 != 0
    (2048, 500, 32, 504, False, "mma"),         # a misaligned operand
    (2048, 512, 32, 520, True, "wgmma"),        # N % 8 == 0 at a padded stride
]


@pytest.mark.parametrize("M,N,K,ldb,aligned,path", _EDGE_PATHS)
def test_edge_path_by_shape(M, N, K, ldb, aligned, path):
    plan = plan_atb(M, N, K, 1, SMS, BF16, aligned, False, ldb)
    assert plan.path == path, plan
    assert (plan.split - 1) * plan.chunk < K <= plan.split * plan.chunk, plan
    if path == "wgmma_edge":
        # tiles of 64 or 128 rows and columns, a work item for 2/3 of the
        # SMs where K allows, the grid persistent
        assert plan.bm in (64, 128) and plan.bn in (64, 128) and plan.chunk % WGMMA_CHUNK == 0
        items = cdiv(M, plan.bm) * cdiv(N, plan.bn) * plan.split
        assert plan.ctas == min(items, SMS) and (items >= 2 * SMS // 3
                                                 or plan.chunk == WGMMA_CHUNK), plan
        # the same product on a dense B, the gather, and N % 8 == 0 do not
        assert plan_atb(M, N, K, 1, SMS, BF16, aligned, False).path == "mma"
        assert plan_atb(M, N, K, 9, SMS, BF16, aligned, True, ldb).path == "mma"
    else:
        assert (plan.bm, plan.bn) == ((128, 128) if path == "mma" else plan[1:3])


def test_path_by_shape():
    for M, N, K, taps, dtype, aligned, path in _PATHS:
        plan = plan_atb(M, N, K, taps, SMS, dtype, aligned, taps > 1)
        assert plan.path == path, (M, N, K, taps, dtype, aligned, plan)
        step = {"wgmma": WGMMA_CHUNK, "mma": 32, "fma": 16}[path]
        assert plan.chunk % step == 0
        assert (plan.split - 1) * plan.chunk < K <= plan.split * plan.chunk, plan
        if path != "wgmma":
            assert (plan.bm, plan.bn) == ((128, 128) if path == "mma" else (64, 64))
