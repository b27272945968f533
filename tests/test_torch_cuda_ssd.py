"""The SSD head on the card: DetectionOutput on the card against the same rule
on the CPU, called alone and inside ssd300's captured forward; K2 at the
mbox_conf heads' odd output widths (N = 84 and 126: wgmma_edge on the
padded filters the engine holds, and the mma.sync loop they took before,
forced by an explicit plan) against its plain version; and the captured
ssd300 forward holding no copy
from the host (a capture refuses one, and the replay's device activity
shows none).

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. On the
machine with the card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_ssd.py``.
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.config import make
from boda_tpu_torch.graph import ssd_ops
from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
from boda_tpu_torch.ops.kernels import conv

pytestmark = pytest.mark.cuda

HEAD_INS = ["mbox_loc", "mbox_conf_flatten", "mbox_priorbox"]
# scores and boxes, card vs CPU, max|err|/max|ref|: the same f32 ops, an exp
# ulp apart at most in a decoded box
HEAD_TOL = 1e-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _agree(a, b):
    a, b = a.reshape(-1, 7), b.reshape(-1, 7)
    assert np.array_equal(a[:, :2], b[:, :2])  # images, labels: keep masks, order
    assert np.abs(a[:, 2:] - b[:, 2:]).max() <= HEAD_TOL * np.abs(b[:, 2:]).max()


def test_head_on_card_matches_cpu(dev):
    """ssd300 b2 f32: the head called alone on the forward's own inputs, on
    the card and on the CPU, and the replayed forward's detection_out
    against the CPU engine's."""
    pipe, dims = load_net("ssd300", img=2)
    ins = gen_data_inputs(dims)
    card = make("conv_fwd", "cuda")
    card.init(pipe)
    rc = card.run_fwd(ins, HEAD_INS + ["detection_out"])
    assert card._graph is not None  # the replay of one captured graph
    cpu = make("conv_fwd", "cuda", device="cpu")
    cpu.init(pipe)
    rcpu = cpu.run_fwd(ins, ["detection_out"])["detection_out"].data
    op = pipe.ops["detection_out"]
    hin = [torch.from_numpy(rc[k].data) for k in HEAD_INS]
    with torch.inference_mode():
        on_card = ssd_ops._detection_output_fn(op, 21, 2, "cuda")(*(t.to(dev) for t in hin))
        on_cpu = ssd_ops._detection_output_fn(op, 21, 2, "cpu")(*hin)
    _agree(on_card[0].cpu().numpy(), on_cpu[0].numpy())
    _agree(rc["detection_out"].data, on_cpu[0].numpy())
    # the CPU engine's own trunk differs from the card's in f32 sum order only
    a, b = rc["detection_out"].data.reshape(-1, 7), rcpu.reshape(-1, 7)
    assert np.array_equal(a[:, :2], b[:, :2]) and np.allclose(a[:, 2:], b[:, 2:], atol=1e-3)


@pytest.mark.parametrize("oc", [84, 126])
def test_mbox_conf_odd_n_on_mma(dev, oc):
    """K2 at the mbox_conf heads' shapes in bf16 (3x3 p1, N % 8 != 0), on the
    filters padded as the HWIO prep stores them: the planned route,
    wgmma_edge, with no weight copy, and the mma.sync loop that the heads
    took before it (an explicit plan, chip_smoke.mma_conv), each within 1e-2
    of max|ref| of its plain version."""
    import chip_smoke
    from boda_tpu_torch.ops.kernels.common import pad_rows
    g = torch.Generator(device=dev).manual_seed(1)
    for h, c in ((38, 512), (19, 1024), (3, 256)):
        x = torch.randn((4, h, h, c), generator=g, device=dev).to(torch.bfloat16)
        w = pad_rows((torch.randn((3, 3, c, oc), generator=g, device=dev) * (9 * c) ** -0.5)
                     .to(torch.bfloat16))
        b = (torch.randn((oc,), generator=g, device=dev) * 0.1).to(torch.bfloat16)
        before, copies = dict(conv.conv2d.paths), conv.conv2d.pad_copies
        out = conv.conv2d(x, w, b, pad=(1, 1))
        torch.cuda.synchronize()
        assert conv.conv2d.paths["wgmma_edge"] == before["wgmma_edge"] + 1
        assert conv.conv2d.pad_copies == copies
        ref = conv.conv2d_plain(x, w, b, pad=(1, 1))
        for got in (out, chip_smoke.mma_conv(x, w, b, 1, 1, relu=False)):
            err = float((got.float() - ref.float()).abs().max() / ref.float().abs().max())
            assert got.shape == (4, h, h, oc) and err <= 1e-2, (h, c, err)


def test_captured_ssd300_forward_holds_no_host_copy(dev):
    """ssd300 b4 bf16 under gen captures (a copy from pageable host memory
    inside a capture raises) and replays bit-equal to its eager forward; the
    replay alone runs no host-to-card copy."""
    from torch.profiler import ProfilerActivity, profile
    pipe, dims = load_net("ssd300", img=4)
    ins = gen_data_inputs(dims)
    e = make("conv_fwd", "cuda", compute_tn="bfloat16")
    e.init(pipe)
    e.cuda_graph = False
    eager = e.run_fwd(ins, ["detection_out"])["detection_out"].data
    e.cuda_graph = True
    replay = e.run_fwd(ins, ["detection_out"])["detection_out"].data
    np.testing.assert_array_equal(replay, eager)
    g = e._graph
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        g.graph.replay()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if "HtoD" in n], names[:20]
