"""int8 on the card: the library's int8 GEMM (``torch._int_mm``, cuBLASLt)
through ``ops/int8.py:int8_mm`` at the shapes it must pad (17 rows and
fewer, K = 147 as ResNet-50's unfolded conv1, N % 8 != 0), bit-equal to the
exact product of the same int8 operands (in f64, exact at these sizes); the
ResNet-50 b2 int8-static forward in bench.py's configuration (input_s2d,
bf16, the calibration sidecar) replayed from a CUDA graph, bit-equal to its
eager forward on two batches; and ``test_lmdb`` on the trained shapesnet on
the card, f32 and int8, printing its golden line.

These tests need an NVIDIA GPU; elsewhere they skip. On the machine with the
card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_int8.py``.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from boda_tpu_torch import cli
from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
from boda_tpu_torch.ops.int8 import int8_mm
from boda_tpu_torch.utils.dims import NDA, Dims

pytestmark = pytest.mark.cuda

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = os.path.join(REPO, "testdata", "calib", "resnet50-bf16.calib.json")
# (M, K, N): _int_mm wants M > 16 and K, N multiples of 8
_MM_SHAPES = [(2, 64, 16), (16, 147, 64), (100352, 147, 64), (32, 2048, 1001),
              (17, 24, 5), (1568, 4608, 512)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (cuBLASLt's int8 GEMM has no CPU form here)")
    return torch.device("cuda")


def test_int8_mm_pads_to_cublaslt_shapes(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    for m, k, n in _MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        b = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        got = int8_mm(a, b)
        want = (a.double() @ b.double()).to(torch.int32)
        assert got.dtype == torch.int32 and got.shape == (m, n)
        assert torch.equal(got, want), (m, k, n)


def test_int8_resnet50_b2_replay_equals_eager(dev):
    pipe, dims = load_net("resnet50", img=2)
    e = make("conv_fwd", "cuda", compute_tn="bfloat16", input_s2d=True, int8=True,
             calib_fn=CALIB)
    e.init(pipe)
    log = e.get_info_log()
    assert "conv1: nhwc-stem_s2d" in log and "fc1000: nhwc-ip int8" in log
    assert log.count("nhwc-int8_conv") >= 52 and "static_amax" in log
    x = gen_data_inputs(dims)["data"].data
    for seed in (None, 5):
        xb = x if seed is None else \
            np.random.default_rng(seed).standard_normal(x.shape).astype(np.float32) * 50
        xf = e.host_input_s2d("data", np.ascontiguousarray(xb.transpose(0, 2, 3, 1)))
        ins = {"data": NDA(Dims.of(img=2, y=xf.shape[1], x=xf.shape[2], chan=xf.shape[3]), xf)}
        e.cuda_graph = True
        replay = e.run_fwd(ins, ["prob", "fc1000"])
        e.cuda_graph = False
        eager = e.run_fwd(ins, ["prob", "fc1000"])
        for n in ("prob", "fc1000"):
            assert np.array_equal(replay[n].data, eager[n].data), (seed, n)
        assert np.isfinite(replay["fc1000"].data).all()


def test_lmdb_shapesnet_on_card(dev, tmp_path):
    nets, recs = os.path.join(REPO, "testdata", "nets"), os.path.join(REPO, "testdata", "lmdb")
    base = [f"--ptt-fn={nets}/shapesnet.prototxt", f"--weights-fn={nets}/shapesnet.caffemodel"]
    calib = str(tmp_path / "shapesnet.calib.json")
    assert cli.main(["net_calib"] + base + [f"--lmdb-fn={recs}/shapes_train.rec", "--img=8",
                                            f"--out-fn={calib}"]) == 0
    lines = []
    for eng in ("(mode=cuda)", f"(mode=cuda,int8=1,calib_fn={calib})"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["test_lmdb"] + base + [f"--rec-fn={recs}/shapes_test.rec",
                                                    "--img=8", f"--conv-fwd={eng}"]) == 0
        lines.append(buf.getvalue().splitlines()[-1])
    assert lines == ["test_lmdb: n=64 top1=0.9844 top5=1.0000 net=shapesnet"] * 2
