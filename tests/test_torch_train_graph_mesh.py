"""The compiled training step under a mesh and a process group, on the CPU
(parallel/train.py:CapturedStep over ``Shards``, ``make_train_step``'s
choice, the ranks' key check): the static-buffer body that the card
captures as one CUDA graph, run eagerly here, against the port's eager step
bit for bit and against boda_tpu's jitted sharded step.

mini_resnet b8 16x16 f32, boda_tpu's seeded weights carried across, three
seeded batches, momentum 0.9, clip 1, train-mode BN (tests/test_torch_tp_train.py's
set-up and ``KW``). Gates: test_torch_train_step.py's ``_close`` at 1e-5
after one step and 1e-4 after three; the body bit-equal to the eager step
at every step. Under a (tp=2) mesh both kernel policies, each shard's
returned weight and momentum the step's static part and a chained call
copying none; two spawned gloo ranks (tests/test_torch_dist.py's way), with
remat=seg and without, against boda_tpu's step jitted over (dp=2) on the
global batch; two ranks whose new keys differ raising, naming their keys,
with no hang; and the ``info_log`` line of each case that stays eager.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.parallel import mesh as tmesh
from boda_tpu_torch.parallel import train as ptrain
from boda_tpu_torch.parallel.train import make_train_step as tmake
from boda_tpu_torch.utils.carry import weights_from_numpy
from test_torch_tp_train import KW, _jax_sharded, _setup
from test_torch_train_step import _close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 240  # seconds for a spawned rank; a hang fails the test after it

# one gloo rank of two: the group step eager and its static-buffer body over
# the rank's slices of the batches (argv: rank, port, src npz, out npz, remat,
# kw json, the rank's batch rows or -1 for an equal slice)
_RANK = """
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.parallel.train import make_train_step
from boda_tpu_torch.utils.carry import weights_from_numpy
rank, port, src, out, remat, kw, rows = sys.argv[1:8]
rank, rows = int(rank), int(rows)
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2, rank=rank,
                        timeout=datetime.timedelta(seconds=60))
z = np.load(src)
W = {k[2:]: z[k] for k in z.files if k.startswith("w_")}
per = z["xs"].shape[1] // 2
lo, n = (rank * per, per) if rows < 0 else (0, rows)
pipe = build_model("mini_resnet", img=n, num_cls=16, in_sz=16)[0]
weights_from_numpy(pipe, W)
step = make_train_step(pipe, "fc", remat=remat, group=dist.group.WORLD, cuda_graph=True,
                       **json.loads(kw))
res = {}
try:
    # the key check (rows given): the body alone
    for tag, fn in (("eager", step), ("body", step.captured))[1 if rows >= 0 else 0:]:
        w, m = {k: torch.from_numpy(v.copy()) for k, v in W.items()}, None
        for i in range(z["xs"].shape[0]):
            x = torch.from_numpy(z["xs"][i, lo:lo + n])
            y = torch.from_numpy(z["ys"][i, lo:lo + n])
            loss, w, m = fn(w, {"data": x}, y, m)
            res[f"{tag}/{i}/loss"] = loss.numpy()
            res.update({f"{tag}/{i}/w/{k}": v.numpy().copy() for k, v in w.items()})
            res.update({f"{tag}/{i}/m/{k}": v.numpy().copy() for k, v in m.items()})
except RuntimeError as e:
    print("RAISED " + str(e), flush=True)
else:
    np.savez(out, captures=step.captured.captures, **res)
dist.destroy_process_group()
"""


def _spawn(tmp_path, xs, ys, W, remat="", rows=(-1, -1)) -> list[str]:
    """Run the two ranks; each rank's output (a rank that outlives
    RANK_TIMEOUT is killed and fails the test)."""
    from boda_tpu_torch.modes.dist_modes import _free_port
    src = tmp_path / "src.npz"
    np.savez(src, xs=xs, ys=ys, **{"w_" + k: v for k, v in W.items()})
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), port, str(src),
                               str(tmp_path / f"r{r}.npz"), remat, json.dumps(KW), str(rows[r])],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


def _state(pre: str, z) -> tuple:
    """(loss, weights, momenta) of one step's entries ``pre/...`` as numpy."""
    def part(what):
        k0 = f"{pre}/{what}/"
        return {k[len(k0):]: z[k] for k in z.files if k.startswith(k0)}
    return float(z[f"{pre}/loss"]), part("w"), part("m")


def _bit_equal(a: tuple, b: tuple) -> bool:
    return a[0] == b[0] and all(
        set(x) == set(y) and all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(a[1:], b[1:]))


@pytest.mark.parametrize("policy", ["gen", "lib"])
def test_tp2_body_matches_eager_and_boda_tpu(policy):
    """A (tp=2) mesh of CPU devices: three steps of the body bit-equal to
    the eager (tp=2) step, within 1e-5 after one step and 1e-4 after three
    of boda_tpu's step jitted with its (tp=2) shardings; each shard's
    returned weight and momentum is the step's static part, and a call with
    them copies no tensor in."""
    jp, W, xs, ys = _setup()
    pipe = tbuild("mini_resnet", img=xs.shape[1], num_cls=16, in_sz=16)[0]
    weights_from_numpy(pipe, W)
    mesh = tmesh.make_mesh({"tp": 2}, devices=["cpu"] * 2)
    ref = _jax_sharded(jp, W, xs, ys, 1, 2, KW)
    step = tmake(pipe, "fc", kernel_policy=policy, mesh=mesh, cuda_graph=True, **KW)
    cap = step.captured
    assert not any(ln.startswith("eager") for ln in step.info_log)
    runs = []
    for fn in (step, cap):
        w, m, res = tmesh.shard_weights({k: torch.from_numpy(v.copy()) for k, v in W.items()},
                                        pipe, mesh), None, []
        for x, y in zip(xs, ys):
            loss, w, m = fn(w, {"data": torch.from_numpy(x)}, torch.from_numpy(y), m)
            res.append((float(loss),
                        {k: v.numpy().copy() for k, v in tmesh.gather_weights(w).items()},
                        {k: v.numpy().copy() for k, v in tmesh.gather_weights(m).items()}))
        runs.append((res, w, m))
    (eager, _, _), (body, w, m) = runs
    assert all(_bit_equal(a, b) for a, b in zip(eager, body))
    _close(body[0], ref[0], W, 1e-5, (policy, 1))
    _close(body[2], ref[2], W, 1e-4, (policy, 3))
    split = [k for k, v in w.items() if isinstance(v, tmesh.Shards)]
    assert "conv1__filts" in split and "fc__filts" in split and len(cap.w[split[0]]) == 2
    for got, static in ((w, cap.w), (m, cap.m)):
        for k, v in got.items():
            assert all(p is s for p, s in zip(ptrain._parts(v), ptrain._parts(static[k]))), k
    n = cap.copies  # the first call's weights, every part; zeros for the momenta
    assert n == sum(len(ptrain._parts(v)) for v in w.values())
    cap(w, {"data": torch.from_numpy(xs[0])}, torch.from_numpy(ys[0]), m)
    assert cap.copies == n and cap.captures == 1
    step.release()  # what a group's teardown needs first: the graph freed
    assert cap.graph is None and cap.key is None


@pytest.mark.parametrize("remat", ["", "seg"])
def test_two_gloo_ranks_body(tmp_path, remat):
    """Two gloo ranks, each stepping its half of the global batch b8: the
    body bit-equal to the rank's eager group step at every step (remat=seg:
    train-mode BN's all-reduces run again in the recompute), the ranks
    bit-equal to each other, and within 1e-5 after one step and 1e-4 after
    three of boda_tpu's step jitted over (dp=2) on the global batch."""
    jp, W, xs, ys = _setup()
    ref = _jax_sharded(jp, W, xs, ys, 2, 1, KW, remat=remat)
    _spawn(tmp_path, xs, ys, W, remat)
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    assert sorted(r0.files) == sorted(r1.files)
    assert all(np.array_equal(r0[k], r1[k]) for k in r0.files)
    assert int(r0["captures"]) == 1
    for i in range(len(xs)):
        assert _bit_equal(_state(f"eager/{i}", r0), _state(f"body/{i}", r0)), i
    _close(_state("body/0", r0), ref[0], W, 1e-5, (remat, 1))
    _close(_state("body/2", r0), ref[2], W, 1e-4, (remat, 3))


def test_ranks_with_different_keys_raise(tmp_path):
    """Two gloo ranks whose bodies meet different new keys (b4 and b2) both
    raise before any warm-up, each naming its own key; neither hangs."""
    _, W, xs, ys = _setup()
    outs = _spawn(tmp_path, xs, ys, W, rows=(4, 2))
    for r, (out, n) in enumerate(zip(outs, (4, 2))):
        line = next((ln for ln in out.splitlines() if ln.startswith("RAISED ")), "")
        assert f"rank {r} of 2 meets a new key that differs from another rank's" in line, out
        assert f"inputs [({n}, 3, 16, 16)], labels ({n},)" in line, line
        assert "every rank must step equal slices" in line
        assert not (tmp_path / f"r{r}.npz").exists()


def test_choice_lines(monkeypatch, tmp_path):
    """make_train_step's choice with ``cuda_graph``: an NCCL group and a tp
    row on one card (cuda:0 twice) are captured, with no eager line; a gloo
    group and a row over two cards each stay eager on CUDA tensors with a
    line of their own that says why, both lines where both hold; on CPU
    tensors every step runs eagerly, whatever the group's backend."""
    import torch.distributed as dist
    pipe = tbuild("mini_resnet", img=4, num_cls=16, in_sz=16)[0]
    gloo = "eager on CUDA tensors: the process group's backend is gloo, which reduces " \
           "through the host"
    row = "eager on CUDA tensors: this rank's tp row spans 2 devices (cuda:0, cuda:1)"

    def eager_lines(step):
        return [ln for ln in step.info_log if ln.startswith("eager")]
    one_card = tmesh.make_mesh({"tp": 2}, devices=["cuda:0"] * 2)
    two_cards = tmesh.make_mesh({"tp": 2}, devices=["cuda:0", "cuda:1"])
    assert eager_lines(tmake(pipe, "fc", mesh=one_card, cuda_graph=True)) == []
    lines = eager_lines(tmake(pipe, "fc", mesh=two_cards, cuda_graph=True))
    assert len(lines) == 1 and lines[0].startswith(row)
    assert eager_lines(tmake(pipe, "fc", mesh=two_cards)) == []
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        g = dist.group.WORLD
        lines = eager_lines(tmake(pipe, "fc", group=g, cuda_graph=True))
        assert len(lines) == 1 and lines[0].startswith(gloo)
        both = tmesh.make_mesh({"dp": 1, "tp": 2}, devices=["cuda:0", "cuda:1"])
        lines = eager_lines(tmake(pipe, "fc", group=g, mesh=both, cuda_graph=True))
        assert len(lines) == 2 and lines[0].startswith(gloo) and lines[1].startswith(row)
        # an NCCL group: its backend reported as NCCL's (NCCL needs a card)
        monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
        seen, real = [], ptrain.capture_step
        monkeypatch.setattr(ptrain, "capture_step",
                            lambda body, warm, device: seen.append(device) or real(body, warm,
                                                                                   device))
        cpu2 = tmesh.make_mesh({"dp": 1, "tp": 2}, devices=["cpu"] * 2)
        step = tmake(pipe, "fc", lr=0.05, group=g, mesh=cpu2, cuda_graph=True)
        assert eager_lines(step) == [] and step.captured is not None
        w = tmesh.shard_weights({k: torch.from_numpy(np.ascontiguousarray(v.data))
                                 for k, v in pipe.weights.items()}, pipe, cpu2)
        x, y = torch.zeros(4, 3, 16, 16), torch.zeros(4, dtype=torch.int32)
        step(w, {"data": x}, y)
        assert seen == []  # CPU tensors: the eager step
        step.captured(w, {"data": x}, y)
        assert seen == [torch.device("cpu")]
    finally:
        dist.destroy_process_group()

