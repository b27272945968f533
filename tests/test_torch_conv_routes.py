"""K2's routes by shape (ops/kernels/common.py:plan_gemm) at every direct conv
that the gen forwards of ResNet-50, GoogLeNet and VGG-16 at b32 and of
ssd300 at b4 launch, from the port's zoo and the engine's own dispatch on the
CPU (chip_smoke.py's extraction, ``layer_shapes``): ``wgmma_narrow`` exactly
where C % 8 != 0 (each net's C = 3 conv1), ``wgmma_edge`` exactly where N % 8
!= 0 (ssd300's six mbox_conf heads), the mma.sync loop nowhere, in agreement
with chip_smoke.py's own statement of the rule (``core_path``), its per-net
counts and its lists of narrow and edge shapes (``NARROW_SHAPES``,
``EDGE_SHAPES``). And the narrow plans: 64-row tiles of 64
or 128 columns that cover the problem, split K evenly and fit in shared
memory. The kernel itself runs on the card: tests/test_torch_cuda_gemm.py."""

import pytest
import torch

import chip_smoke
from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import load_net
from boda_tpu_torch.ops.kernels.common import (SMEM_LIMIT, WGMMA_CHUNK, cdiv, plan_gemm,
                                               wgmma_smem)

SMS = 132  # an H100 SXM
BF16 = torch.bfloat16

# each net's K2 launches per gen forward by route (chip_smoke.py's
# check_paths and SSD_NARROW / SSD_EDGE; SSD_MMA is 0)
_ROUTES = {("resnet50", 32): {"wgmma": 16, "wgmma_narrow": 1},
           ("googlenet_conv", 32): {"wgmma": 19, "wgmma_narrow": 1},
           ("vgg16", 32): {"wgmma": 12, "wgmma_narrow": 1},
           ("ssd300", chip_smoke.SSD_BATCH): {"wgmma": 22, "wgmma_narrow": chip_smoke.SSD_NARROW,
                                              "wgmma_edge": chip_smoke.SSD_EDGE}}


@pytest.mark.parametrize("net,batch", list(_ROUTES))
def test_each_conv_takes_its_route(net, batch):
    pipe, _ = load_net(net, img=batch)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16", device="cpu")
    eng.init(pipe)
    _, conv = chip_smoke.layer_shapes(pipe, eng)
    got = {}
    for (n, h, c, oc, k, s, p, _, _), count in conv.items():
        oh = (h + 2 * p - k) // s + 1
        path = plan_gemm(n * oh * oh, oc, k * k * c, SMS, BF16, conv_c=c).path
        assert path == chip_smoke.core_path(c, oc), (net, (n, h, c, oc, k, s, p))
        # the mma.sync loop never for a conv whose only narrow dimension is C
        assert path != "mma" or oc % 8, (net, (n, h, c, oc))
        if path == "wgmma_narrow":
            assert (n, h, c, oc, k, s, p) in chip_smoke.NARROW_SHAPES
        if path == "wgmma_edge":
            assert (n, h, c, oc, k, s, p) in chip_smoke.EDGE_SHAPES
        got[path] = got.get(path, 0) + count
    assert got == _ROUTES[net, batch]
    assert chip_smoke.SSD_MMA == 0 and "mma" not in got
    if net == "ssd300":
        assert sum(got.values()) == chip_smoke.SSD_LAUNCHES["gen"]["conv"]


_NARROW = list(chip_smoke.NARROW_SHAPES) + [
    (2, 17, 1, 64, 3, 1, 1), (2, 17, 3, 64, 7, 2, 3), (3, 13, 5, 72, 5, 2, 2),
    (2, 15, 12, 136, 3, 1, 0), (1, 9, 5, 64, 7, 1, 3), (2, 11, 3, 256, 3, 2, 1)]


@pytest.mark.parametrize("sig", _NARROW)
def test_narrow_plans_cover_the_problem_and_fit(sig):
    n, h, c, oc, k, s, p = sig
    oh = (h + 2 * p - k) // s + 1
    M, K = n * oh * oh, k * k * c
    plan = plan_gemm(M, oc, K, SMS, BF16, conv_c=c)
    assert plan.path == "wgmma_narrow" and plan.bm == 64 and plan.bn in (64, 128), plan
    assert plan.bn <= max(64, cdiv(oc, 64) * 64), plan
    tiles = cdiv(M, plan.bm) * cdiv(oc, plan.bn)
    assert tiles * plan.bm * plan.bn >= M * oc
    chunks = cdiv(K, WGMMA_CHUNK)
    assert chunks % plan.split == 0 and plan.split <= min(16, chunks), plan
    assert plan.ctas == min(tiles * plan.split, SMS)
    assert wgmma_smem(plan.bm, plan.bn) <= SMEM_LIMIT
    # the same shape with 16-byte channels takes the aligned ring
    assert plan_gemm(M, oc, k * k * 8, SMS, BF16, conv_c=8).path == "wgmma"


def test_narrow_split_k_where_tiles_are_few():
    # 81 rows, K = 245 (4 chunks): two 64-row tiles, so K splits to fill SMs
    plan = plan_gemm(81, 64, 245, SMS, BF16, conv_c=5)
    assert plan.path == "wgmma_narrow" and plan.split == 4 and plan.ctas == 8, plan
