"""The training step on the card: the gen convs' and fcs' autograd Functions
(ops/kernels/train_conv.py) on the hand kernels against the same Functions
on CPU tensors (the plain versions), per backward route and dtype; a
mini_resnet step on the card against the CPU, with its launches per
wrapper exact; train_lmdb and test_lmdb --ckpt-fn on the card; the training
Dropout's mask the same on the card as on the CPU.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. On the
machine with the card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_train.py``.
"""

import numpy as np
import pytest
import torch

from boda_tpu_torch.ops.kernels import bconv, conv, sgemm
from boda_tpu_torch.ops.kernels.train_conv import gen_conv, gen_fc

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    return torch.device("cuda")


def _grads(fn, ins, ct):
    ins = [t.detach().clone().requires_grad_() for t in ins]
    out = fn(*ins)
    gs = torch.autograd.grad((out.float() * ct.to(out.device)).sum(), ins)
    return out, gs


# (n, h, c, oc, k, s, p): 1x1 s1 and s2 (K1, K5), 3x3 s1 (K2, K3, K5), 7x7 s2
# (K2 forward, the library's backward), C = 3 on mma.sync
CONVS = [(2, 14, 64, 32, 1, 1, 0), (2, 14, 64, 128, 1, 2, 0), (2, 12, 32, 64, 3, 1, 1),
         (2, 16, 3, 16, 7, 2, 3), (2, 10, 3, 16, 3, 1, 1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gen_functions_match_plain(dev, dtype):
    """Forward and every gradient of each route and of the fc, card against
    CPU: within 1e-4 (f32) or 1e-2 (bf16) of max|ref|."""
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 1e-2
    g = torch.Generator().manual_seed(3)
    cases = []
    for n, h, c, oc, k, s, p in CONVS:
        x = torch.randn((n, h, h, c), generator=g).to(dt)
        w = (torch.randn((k, k, c, oc), generator=g) * (k * k * c) ** -0.5).to(dt)
        b = (torch.randn((oc,), generator=g) * 0.1).to(dt)
        oh = (h + 2 * p - k) // s + 1
        ct = torch.randn((n, oh, oh, oc), generator=g)
        cases.append((lambda x, w, b, s=s, p=p: gen_conv(x, w, b, stride=(s, s), pad=(p, p)),
                      (x, w, b), ct))
    x = torch.randn((4, 200), generator=g).to(dt)
    w = (torch.randn((200, 24), generator=g) * 200 ** -0.5).to(dt)
    cases.append((gen_fc, (x, w, (torch.randn((24,), generator=g) * 0.1).to(dt)),
                  torch.randn((4, 24), generator=g)))
    for fn, ins, ct in cases:
        ref, rgs = _grads(fn, ins, ct)
        out, gs = _grads(fn, [t.to(dev) for t in ins], ct)
        for got, want in zip((out, *gs), (ref, *rgs)):
            assert got.dtype == want.dtype and got.shape == want.shape
            err = (got.cpu().float() - want.float()).abs().max()
            assert err <= tol * want.float().abs().max(), (fn, tuple(want.shape), float(err))


def _counters():
    return {"sgemm": sgemm.matmul, "conv": conv.conv2d, "conv_nhwc": conv.conv2d_nhwc,
            "atb": bconv.matmul_atb}


def test_step_card_vs_cpu_and_launches(dev):
    """One gen step (momentum 0.9, train-mode BN, clip 1) of mini_resnet b2
    f32 on the card against the CPU: loss within 1e-4 relative, weights and
    momenta within 1e-4 of the largest; the launches per wrapper as
    chip_smoke.py's train_calls derives them from the routes."""
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.parallel.train import make_train_step
    import chip_smoke
    pipe, dims = build_model("mini_resnet", img=2, in_sz=16)
    w = {k: torch.from_numpy(np.asarray(v.data, np.float32)) for k, v in pipe.weights.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3, 16, 16))
                         .astype(np.float32))
    y = torch.tensor([1, 5])
    step = make_train_step(pipe, "fc", lr=0.05, momentum=0.9, clip_norm=1.0,
                           bn_momentum=0.1, precision="highest")
    rl, rw, rm = step(w, {"data": x}, y)
    step(*({k: v.to(dev) for k, v in w.items()}, {"data": x.to(dev)}, y.to(dev)))
    for f in _counters().values():
        f.launches = 0
    tl, tw, tm = step({k: v.to(dev) for k, v in w.items()}, {"data": x.to(dev)}, y.to(dev))
    torch.cuda.synchronize()
    got = {k: f.launches for k, f in _counters().items()}
    assert got == chip_smoke.train_launches(chip_smoke.train_calls(pipe))
    assert abs(float(tl) - float(rl)) <= 1e-4 * abs(float(rl))
    upd = max(float((rw[k] - w[k]).abs().max()) for k in w)
    for k in w:
        assert float((tw[k].cpu() - rw[k]).abs().max()) <= 1e-4 * max(
            float(rw[k].abs().max()), upd), k
    mmax = max(float(v.abs().max()) for v in rm.values())
    for k in rm:
        assert float((tm[k].cpu() - rm[k]).abs().max()) <= 1e-4 * mmax, k


def test_train_lmdb_and_ckpt_on_card(dev, tmp_path, capsys):
    """train_lmdb on the card (its default device) writes a checkpoint that
    test_lmdb --ckpt-fn reads on the card and on the CPU with one top-1."""
    from boda_tpu_torch.cli import main
    rec = "--rec-fn=testdata/lmdb/cifar_mini.rec"
    assert main(["train_lmdb", rec, "--model=mini_resnet", "--img=4", "--n-steps=3",
                 "--ckpt-fn=ck.npz", f"--boda-output-dir={tmp_path}"]) == 0
    assert "train_lmdb: 3 steps over 8 records" in capsys.readouterr().out
    lines = []
    for eng in ("(mode=cuda)", "(mode=cuda,device=cpu)"):
        assert main(["test_lmdb", rec, "--model=mini_resnet", "--img=4",
                     f"--ckpt-fn={tmp_path}/ck.npz", f"--conv-fwd={eng}"]) == 0
        lines.append([ln for ln in capsys.readouterr().out.splitlines()
                      if ln.startswith("test_lmdb:")])
    assert lines[0] == lines[1] and "(step 3)" in lines[0][0]


def test_dropout_mask_same_on_card(dev):
    """The training Dropout draws its mask on the host from the op's seed,
    so the card and the CPU drop the same elements."""
    from boda_tpu_torch.graph.lowering import LowerCtx
    from boda_tpu_torch.graph.lowering_nhwc import lower_op_nhwc
    from boda_tpu_torch.models.zoo import NetBuilder
    from boda_tpu_torch.ops.tune import OpTune
    from boda_tpu_torch.utils.dims import Dims
    b = NetBuilder("d")
    t = b.input("data")
    t = b.conv("c", t, 8, 3, pad=1, in_chans=3)
    b.dropout("drop", t)
    pipe = b.done({"data": Dims.of(img=2, chan=3, y=6, x=6)})
    fn, _ = lower_op_nhwc(pipe, pipe.ops["drop"], LowerCtx(train=True, det_drop_seed=7),
                          OpTune(), [])
    x = torch.ones((2, 6, 6, 8))
    (cpu,) = fn(x)
    (card,) = fn(x.to(dev))
    assert torch.equal(card.cpu(), cpu) and 0 < int((cpu == 0).sum()) < cpu.numel()
