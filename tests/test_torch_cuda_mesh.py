"""The multi-device paths on the card: the engine's dp=2 forward replayed on
a 2-device mesh (the first two cards, or cuda:0 twice) with each half
bit-equal to the no-mesh engine's replay of its images and twice its
launches; a 2-rank gloo training step on the card against the
single-process step on the global batch; and the gen training step on a
(tp=2) mesh of the same devices against the step without a mesh.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. On the
machine with the card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_mesh.py``.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from boda_tpu_torch.config import make
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.ops.kernels.conv import conv2d
from boda_tpu_torch.ops.kernels.sgemm import matmul
from boda_tpu_torch.ops.kernels.bconv import matmul_atb
from boda_tpu_torch.parallel.mesh import gather_weights, make_mesh, shard_weights
from boda_tpu_torch.parallel.train import find_logits_node, make_train_step
from boda_tpu_torch.utils.dims import NDA

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def devs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    n = torch.cuda.device_count()
    return [torch.device("cuda", i % n) for i in range(2)]


def _launches():
    torch.cuda.synchronize()
    return matmul.launches, conv2d.launches


@pytest.mark.parametrize("dtype", ["bfloat16", ""])
def test_dp2_forward_halves_bit_equal(devs, dtype):
    pipe, dims = build_model("mini_resnet", img=8, num_cls=16, in_sz=32)
    half, hdims = build_model("mini_resnet", img=4, num_cls=16, in_sz=32)
    ins = gen_data_inputs(dims)
    halves = [{"data": NDA(hdims["data"], ins["data"].data[i * 4:(i + 1) * 4])}
              for i in range(2)]
    ref = make("conv_fwd", "cuda", compute_tn=dtype)
    ref.init(half)
    ref.prepare(halves[0], ["prob"])
    l0 = _launches()
    want = [ref.run_fwd(h, ["prob"])["prob"].data for h in halves]
    n_half = [a - b for a, b in zip(_launches(), l0)]
    eng = make("conv_fwd", "cuda", compute_tn=dtype, mesh=make_mesh({"dp": 2}, devices=devs))
    eng.init(pipe)
    eng.prepare(ins, ["prob"])
    l0 = _launches()
    got = eng.run_fwd(ins, ["prob"])["prob"].data
    n_mesh = [a - b for a, b in zip(_launches(), l0)]
    assert np.array_equal(got[:4], want[0]) and np.array_equal(got[4:], want[1])
    assert n_mesh == [2 * n for n in n_half] and min(n_half) > 0
    assert eng._graph is not None and eng._reps[1]._graph is not None
    assert eng.time_fwd(ins, ["prob"], n_iters=3, warmup=1) > 0


def test_two_rank_gloo_step_on_card(devs):
    """dist_test_master on the card (two ranks sharing the machine's cards)
    against the step of one process on the global batch."""
    r = subprocess.run([sys.executable, "-m", "boda_tpu_torch", "dist_test_master",
                        "--num-procs=2", "--devices-per-proc=2", "--steps=2"],
                       cwd=REPO, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    ranks = [[float(v) for v in m.group(1).split(",")]
             for m in re.finditer(r"losses=([\d.,-]+)", r.stdout)]
    assert len(ranks) == 2 and ranks[0] == ranks[1]
    pipe, dims = build_model("mini_resnet", img=8, num_cls=16, in_sz=16)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*dims["data"].shape).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 16, size=(8,)).astype(np.int32)).cuda()
    step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9,
                           bn_momentum=0.1, clip_norm=1.0)
    w = {k: torch.from_numpy(np.ascontiguousarray(v.data)).cuda()
         for k, v in pipe.weights.items()}
    mom, single = None, []
    for _ in range(2):
        loss, w, mom = step(w, {"data": x}, y, mom)
        single.append(float(loss))
    assert np.allclose(ranks[0], single, rtol=1e-4, atol=0)


def test_tp2_step_on_card(devs):
    """mini_resnet b8 f32 gen, two steps with momentum, clip and train-mode
    BN on the (tp=2) row against no mesh: the loss and every weight and
    momentum within 1e-4 (tests/test_torch_train_step.py's rule), twice the
    no-mesh step's K1, K2 and K5 launches."""
    pipe, dims = build_model("mini_resnet", img=8, num_cls=16, in_sz=16)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*dims["data"].shape).astype(np.float32)).cuda(devs[0])
    y = torch.from_numpy(rng.randint(0, 16, size=(8,)).astype(np.int32)).cuda(devs[0])
    w0 = {k: torch.from_numpy(np.ascontiguousarray(v.data)).cuda(devs[0])
          for k, v in pipe.weights.items()}
    runs = []
    for mesh in (None, make_mesh({"tp": 2}, devices=devs)):
        step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9,
                               bn_momentum=0.1, clip_norm=1.0, mesh=mesh)
        w = w0 if mesh is None else shard_weights(w0, pipe, mesh)
        mom, losses = None, []
        l0 = _launches() + (matmul_atb.launches,)
        for _ in range(2):
            loss, w, mom = step(w, {"data": x}, y, mom)
            losses.append(float(loss))
        n = [a - b for a, b in zip(_launches() + (matmul_atb.launches,), l0)]
        runs.append((losses, gather_weights(w, devs[0]), gather_weights(mom, devs[0]), n))
    (lr_, wr, mr, nr), (lt, wt, mt, nt) = runs
    assert np.allclose(lt, lr_, rtol=1e-4, atol=0)
    upd = max(float((wr[k] - w0[k]).abs().max()) for k in w0)
    for k in wr:
        assert float((wt[k] - wr[k]).abs().max()) <= 1e-4 * max(float(wr[k].abs().max()), upd), k
    mmax = max(float(v.abs().max()) for v in mr.values())
    assert all(float((mt[k] - mr[k]).abs().max()) <= 1e-4 * mmax for k in mr)
    assert nt == [2 * v for v in nr] and min(nr) > 0
