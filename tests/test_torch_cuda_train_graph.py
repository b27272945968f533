"""The compiled training step on the card (parallel/train.py:CapturedStep):
the step captured once per key as one CUDA graph and replayed, against the
eager step from the same weights, under cuDNN's deterministic algorithms, at
mini_resnet b4 16x16 f32: three steps bit-equal with momentum and train-mode
BN under gen and lib; the four remat modes; bn_freeze_at's two graphs;
train_lmdb's kill and resume on the captured step; a failed capture raising;
the (tp=2) step on cuda:0 twice and a one-rank NCCL group's step (remat
none and seg) each replayed bit-equal to its eager step on two batches,
each captured once.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. On the
machine with the card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_train_graph.py``.
"""

import re

import numpy as np
import pytest
import torch

from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.parallel.train import make_train_step

pytestmark = pytest.mark.cuda

KW = dict(lr=0.05, momentum=0.9, clip_norm=1.0, weight_decay=1e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the hand kernels have no CPU mode)")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield torch.device("cuda")
    torch.backends.cudnn.deterministic = det


def _setup(dev):
    pipe, dims = build_model("mini_resnet", img=4, in_sz=16)
    w = {k: torch.from_numpy(np.asarray(v.data, np.float32)).to(dev)
         for k, v in pipe.weights.items()}
    rng = np.random.default_rng(0)
    feeds = [(torch.from_numpy(rng.standard_normal(dims["data"].shape).astype(np.float32))
              .to(dev), torch.from_numpy(rng.integers(0, 16, 4)).to(dev), i) for i in range(3)]
    return pipe, w, feeds


def _same(a: list, b: list) -> list:
    """The (step, tensor) pairs where two runs of train_step_states differ."""
    import chip_smoke
    return [(i, k) for i, (x, y) in enumerate(zip(a, b))
            for k, d in chip_smoke.max_diffs(x, y).items() if d]


@pytest.mark.parametrize("policy", ["gen", "lib"])
def test_replay_bit_equal_to_eager(dev, policy):
    """Three replays of one capture (three batches, momentum, decoupled
    decay, clip, train-mode BN) bit-equal to three eager steps: the loss,
    every weight and running statistic, every momentum."""
    import chip_smoke
    pipe, w, feeds = _setup(dev)
    kw = dict(KW, bn_momentum=0.1, kernel_policy=policy)
    eager = chip_smoke.train_step_states(make_train_step(pipe, "fc", **kw), w, feeds)
    step = make_train_step(pipe, "fc", cuda_graph=True, **kw)
    got = chip_smoke.train_step_states(step, w, feeds)
    assert _same(eager, got) == []
    assert step.captured.captures == 1 and step.captured.copies == len(w)


def test_remat_modes_capture(dev):
    """'', seg, full and dots: each captured once, each equal to its eager
    step over three steps, bit for bit."""
    import chip_smoke
    pipe, w, feeds = _setup(dev)
    for remat in ("", "seg", "full", "dots"):
        kw = dict(KW, bn_momentum=0.1, remat=remat)
        eager = chip_smoke.train_step_states(make_train_step(pipe, "fc", **kw), w, feeds)
        step = make_train_step(pipe, "fc", cuda_graph=True, **kw)
        assert _same(eager, chip_smoke.train_step_states(step, w, feeds)) == [], remat
        assert step.captured.captures == 1, remat


def test_bn_freeze_at_two_graphs(dev):
    """train_lmdb's bn_freeze_at: two steps in train-mode BN, then two with
    BN frozen on the first step's returned state, each step its own graph,
    bit-equal to the same sequence run eagerly."""
    pipe, w, feeds = _setup(dev)
    runs = []
    for cg in (False, True):
        warm = make_train_step(pipe, "fc", bn_momentum=0.1, cuda_graph=cg, **KW)
        frozen = make_train_step(pipe, "fc", cuda_graph=cg, **KW)
        cur, m, losses = w, None, []
        for i, sfn in enumerate((warm, warm, frozen, frozen)):
            x, y, _ = feeds[i % 3]
            loss, cur, m = sfn(cur, {"data": x}, y, m, step=i)
            losses.append(loss)
        runs.append((losses, {k: v.clone() for k, v in cur.items()},
                     {k: v.clone() for k, v in m.items()}))
        if cg:
            assert warm.captured.captures == frozen.captured.captures == 1
            assert frozen.captured.copies == len(w) + len(m)  # warm's statics, foreign to it
    (le, we, me), (lc, wc, mc) = runs
    assert all(torch.equal(a, b) for a, b in zip(le, lc))
    assert all(torch.equal(we[k], wc[k]) for k in we)
    assert all(torch.equal(me[k], mc[k]) for k in me)


def test_train_lmdb_kill_and_resume_captured(dev, tmp_path, capsys):
    """train_lmdb --cuda-graph=1 on the card: 3 steps with a checkpoint,
    then a resume to 6, against 6 straight: the same losses; and the
    straight run's losses the same as --cuda-graph=0's."""
    from boda_tpu_torch.cli import main
    common = ["train_lmdb", "--rec-fn=testdata/lmdb/cifar_mini.rec", "--model=mini_resnet",
              "--img=4", "--lr-schedule=cosine", "--warmup-steps=2", "--log-every=1"]

    def losses(args):
        assert main(common + args) == 0
        return {int(m.group(1)): float(m.group(2)) for m in
                re.finditer(r"step (\d+): loss ([\d.eE+-]+)", capsys.readouterr().out)}
    full = losses(["--n-steps=6", "--cuda-graph=1", f"--boda-output-dir={tmp_path}/a"])
    eager = losses(["--n-steps=6", "--cuda-graph=0", f"--boda-output-dir={tmp_path}/b"])
    losses(["--n-steps=3", "--ckpt-fn=ck.npz", f"--boda-output-dir={tmp_path}/c"])
    resumed = losses(["--n-steps=6", "--ckpt-fn=ck.npz", "--resume=1",
                      f"--boda-output-dir={tmp_path}/c"])
    assert set(resumed) == {3, 4, 5}
    assert all(resumed[i] == full[i] for i in (3, 4, 5)), (resumed, full)
    assert full == eager


def test_failed_capture_raises(dev):
    """A failure planted in the first conv during the capture (the warm-up
    steps pass) raises, naming the op; no eager step stands in, and the step
    keeps no graph."""
    from boda_tpu_torch.parallel import train as ptrain
    pipe, w, feeds = _setup(dev)
    orig = ptrain._lower_train

    def planted(p, op, ctx, gen, info_log):
        fn, preps = orig(p, op, ctx, gen, info_log)
        if op.name != "conv1":
            return fn, preps

        def failing(*args):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a failure planted in the capture")
            return fn(*args)
        return failing, preps
    ptrain._lower_train = planted
    try:
        step = make_train_step(pipe, "fc", cuda_graph=True, **KW)
    finally:
        ptrain._lower_train = orig
    x, y, _ = feeds[0]
    with pytest.raises(RuntimeError, match="capture failed at op 'conv1'"):
        step(w, {"data": x}, y)
    assert step.captured.graph is None and step.captured.key is None


def test_tp2_one_card_replay_bit_equal(dev):
    """A (tp=2) mesh whose row is cuda:0 twice: two replays of one capture
    bit-equal to two eager (tp=2) steps (the weights and momenta gathered),
    and the returned shards the step's static parts."""
    import chip_smoke
    from boda_tpu_torch.parallel.mesh import Shards, make_mesh, shard_weights
    pipe, w, feeds = _setup(dev)
    mesh = make_mesh({"tp": 2}, devices=[dev, dev])
    ws = shard_weights(w, pipe, mesh)
    kw = dict(KW, bn_momentum=0.1, mesh=mesh)
    eager = chip_smoke.train_step_states(make_train_step(pipe, "fc", **kw), ws, feeds[:2])
    step = make_train_step(pipe, "fc", cuda_graph=True, **kw)
    assert not any(ln.startswith("eager") for ln in step.info_log)
    got = chip_smoke.train_step_states(step, ws, feeds[:2])
    assert _same(eager, got) == []
    cap = step.captured
    assert cap.captures == 1 and any(isinstance(v, Shards) for v in cap.w.values())
    assert cap.copies == sum(len(v) if isinstance(v, Shards) else 1 for v in ws.values())


def test_nccl_one_rank_replay_bit_equal(dev):
    """A one-rank NCCL group: the captured step (its all-reduces in the
    graph) replayed bit-equal to the eager group step on two batches, remat
    none and seg (train-mode BN's all-reduces run again in the recompute),
    and to the captured step without a group; each captured once."""
    import torch.distributed as dist

    import chip_smoke
    from boda_tpu_torch.modes.dist_modes import _free_port
    pipe, w, feeds = _setup(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        for remat in ("", "seg"):
            kw = dict(KW, bn_momentum=0.1, remat=remat)
            g = dict(kw, group=dist.group.WORLD)
            eager = chip_smoke.train_step_states(make_train_step(pipe, "fc", **g), w, feeds[:2])
            step = make_train_step(pipe, "fc", cuda_graph=True, **g)
            assert not any(ln.startswith("eager") for ln in step.info_log), remat
            got = chip_smoke.train_step_states(step, w, feeds[:2])
            alone = chip_smoke.train_step_states(
                make_train_step(pipe, "fc", cuda_graph=True, **kw), w, feeds[:2])
            assert _same(eager, got) == [] and _same(alone, got) == [], remat
            assert step.captured.captures == 1, remat
            step.release()  # before the group's teardown, which waits for its graphs
            assert step.captured.graph is None
    finally:
        dist.destroy_process_group()
