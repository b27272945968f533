"""K6's route by shape (ops/kernels/block.py:route): which product loop of
csrc/block.cu a launch takes, chosen before the launch. The ResNet-50 b32
fused forward's 12 bottlenecks are taken from the port's zoo and fused
engine on the CPU (chip_smoke.py's own extraction). The kernels themselves
run on the card: tests/test_torch_cuda_block.py."""

import numpy as np
import pytest
import torch

import chip_smoke
from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import load_net
from boda_tpu_torch.ops.kernels.block import bottleneck, bottleneck_plain, route
from boda_tpu_torch.utils.lexp import parse_lexp

BF16 = torch.bfloat16


def test_b32_fused_forward_takes_wgmma():
    pipe, _ = load_net("resnet50", 32)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16", fuse_block=True, device="cpu",
               tune=parse_lexp(chip_smoke.FUSED_TUNE))
    eng.init(pipe)
    blocks, _, _ = chip_smoke.fused_shapes(pipe, eng)
    # res2 56², res3 28², res4 14², res5 7²: 2 + 3 + 5 + 2 identity blocks
    assert blocks == {(32, 56, 256, 64): 2, (32, 28, 512, 128): 3,
                      (32, 14, 1024, 256): 5, (32, 7, 2048, 512): 2}
    assert {route(c, k, BF16) for _, _, c, k in blocks} == {"wgmma"}


@pytest.mark.parametrize("c,k,dtype,aligned,want", [
    (64, 64, BF16, True, "wgmma"), (256, 72, BF16, True, "mma"), (96, 64, BF16, True, "mma"),
    (256, 64, BF16, False, "mma"), (24, 16, torch.float32, True, "fma")],
    ids=["64x64", "ragged-k", "ragged-c", "misaligned", "f32"])
def test_route_by_shape(c, k, dtype, aligned, want):
    assert route(c, k, dtype, aligned) == want


def test_cpu_runs_the_plain_version():
    # CPU tensors take bottleneck_plain and launch nothing
    rng = np.random.default_rng(0)
    n, h, c, k = 1, 6, 64, 64
    ops = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(BF16)
           for s in ((n, h, h, c), (c, k), (k,), (3, 3, k, k), (k,), (k, c), (c,))]
    launches, paths = bottleneck.launches, dict(bottleneck.paths)
    assert torch.equal(bottleneck(*ops), bottleneck_plain(*ops))
    assert bottleneck.launches == launches and bottleneck.paths == paths
    with pytest.raises(ValueError):
        route(c, k, torch.float16)
