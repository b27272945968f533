"""The port's data-parallel training across ranks, on the CPU: dist_test_master
and dist_test_worker (boda_tpu_torch/modes/dist_modes.py) over gloo, the
``group`` of parallel/train.py's step, and parallel/dryrun.py.

Gates: parallel/dryrun.py's (dp=2,tp=4) production step within 1e-5
relative of boda_tpu's ``_dryrun_body``; the master's line is the one
boda_tpu's dist_test_master prints
today (its golden testdata/good_tr/dist_test_2x2/test_out.txt is stale:
ROADMAP §3); each rank's losses within 1e-5 relative of boda_tpu's jitted
single-device step on the global batch; two gloo ranks' weights and momenta
after two steps against the port's single-process step on the global batch,
under BODA_TRAIN_VJP=0 and =1, within 1e-5 of the largest momentum (each
weight: of the larger of its own size and that); a one-rank group's step
bit-equal to the step without one; a failing worker's rc and output in the
master's error, as boda_tpu's master reports them.
"""

import contextlib
import io
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.parallel.train import find_logits_node as jlogits
from boda_tpu.parallel.train import make_train_step as jmake_step
from boda_tpu_torch import cli
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.parallel.dryrun import dryrun_multichip
from boda_tpu_torch.parallel.train import find_logits_node, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINE = ("dist_test_master: 2 controllers x 2 devices, loss 4.5355 -> 3.0080, "
        "all ranks agree OK")
THREADS = "2"  # each spawned rank's CPU threads, beside the other test workers


def _main(argv) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def master_2x2(tmp_path_factory):
    """The master in this process; its workers with a jax, jaxlib and
    ml_dtypes on their path that fail on import (the port imports none)."""
    fake = tmp_path_factory.mktemp("no_jax")
    for mod in ("jax", "jaxlib", "ml_dtypes"):
        (fake / mod).mkdir()
        (fake / mod / "__init__.py").write_text(f"raise ImportError('imported {mod}')\n")
    old = {k: os.environ.get(k) for k in ("PYTHONPATH", "OMP_NUM_THREADS")}
    os.environ.update(PYTHONPATH=str(fake), OMP_NUM_THREADS=THREADS)
    try:
        rc, out, err = _main(["dist_test_master", "--num-procs=2", "--devices-per-proc=2",
                              "--steps=3", "--device=cpu"])
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v
    assert rc == 0, out + err
    return out


def test_master_prints_boda_tpus_line(master_2x2):
    """boda_tpu's line, from workers that import no jax."""
    assert master_2x2.splitlines()[-1] == LINE
    assert "backend=gloo device=cpu" in master_2x2


def test_rank_losses_match_boda_tpus_single_device_step(master_2x2):
    """boda_tpu's worker config (lr 0.05, momentum 0.9, BN momentum 0.1,
    clip 1) jitted on one device over the global batch of 8 (2 per device
    of 2 x 2), the same seeded data."""
    ranks = [[float(v) for v in m.group(1).split(",")]
             for m in re.finditer(r"losses=([\d.,-]+)", master_2x2)]
    pipe, in_dims = jbuild("mini_resnet", img=8, num_cls=16, in_sz=16)
    rng = np.random.RandomState(0)
    x = rng.randn(*in_dims["data"].shape).astype(np.float32)
    y = rng.randint(0, 16, size=(8,)).astype(np.int32)
    step = jax.jit(jmake_step(pipe, jlogits(pipe), lr=0.05, momentum=0.9, bn_momentum=0.1,
                              clip_norm=1.0))
    w, mom, want = {k: v.data for k, v in pipe.weights.items()}, None, []
    for _ in range(3):
        loss, w, mom = step(w, {"data": x}, y, mom)
        want.append(float(loss))
    assert len(ranks) == 2 and ranks[0] == ranks[1]
    assert np.allclose(ranks[0], want, rtol=1e-5, atol=0), (ranks[0], want)


_RANK = """
import os, sys
import numpy as np, torch, torch.distributed as dist
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.parallel.train import find_logits_node, make_train_step
rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        world_size=world, rank=rank)
pipe, dims = build_model("mini_resnet", img=8, num_cls=16, in_sz=16)
rng = np.random.RandomState(0)
x = rng.randn(*dims["data"].shape).astype(np.float32)
y = rng.randint(0, 16, size=(8,)).astype(np.int32)
per = 8 // world
step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9, bn_momentum=0.1,
                       clip_norm=1.0, remat="seg", group=dist.group.WORLD)
w = {k: torch.from_numpy(np.ascontiguousarray(v.data)) for k, v in pipe.weights.items()}
mom, losses = None, []
for _ in range(2):
    loss, w, mom = step(w, {"data": torch.from_numpy(x[rank * per:(rank + 1) * per])},
                        torch.from_numpy(y[rank * per:(rank + 1) * per]), mom)
    losses.append(loss.numpy())
np.savez(out, losses=np.array(losses), **{"w_" + k: v.numpy() for k, v in w.items()},
         **{"m_" + k: v.numpy() for k, v in mom.items()})
dist.destroy_process_group()
"""


@pytest.mark.parametrize("vjp", ["0", "1"])
def test_two_gloo_ranks_match_single_process(tmp_path, monkeypatch, vjp):
    """The dp step (remat=seg: the recompute runs its all-reduces again in
    the backward) on two ranks against the step of one process on the
    global batch, both routes of train-mode BN's backward."""
    from boda_tpu_torch.modes.dist_modes import _free_port
    monkeypatch.setenv("BODA_TRAIN_VJP", vjp)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS=THREADS)
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), "2", port,
                               str(tmp_path / f"r{r}.npz")], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    r0, r1 = (np.load(tmp_path / f"r{r}.npz") for r in range(2))
    assert all(np.array_equal(r0[k], r1[k]) for k in r0.files)  # the ranks agree bit for bit
    pipe, dims = tbuild("mini_resnet", img=8, num_cls=16, in_sz=16)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*dims["data"].shape).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 16, size=(8,)).astype(np.int32))
    step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9,
                           bn_momentum=0.1, clip_norm=1.0, remat="seg")
    w = {k: torch.from_numpy(np.ascontiguousarray(v.data)) for k, v in pipe.weights.items()}
    mom, losses = None, []
    for _ in range(2):
        loss, w, mom = step(w, {"data": x}, y, mom)
        losses.append(float(loss))
    assert np.allclose(r0["losses"], losses, rtol=1e-5, atol=0)
    # a conv bias ahead of train-mode BN has a zero gradient, so its
    # momentum is rounding noise: each momentum is held to the largest
    # momentum, each weight to the larger of its own size and that
    # (tests/test_torch_train_step.py's rule)
    m_max = max(float(v.abs().max()) for v in mom.values())
    for k, v in mom.items():
        assert np.abs(r0["m_" + k] - v.numpy()).max() <= 1e-5 * m_max, k
    for k, v in w.items():
        v = v.numpy()
        assert np.abs(r0["w_" + k] - v).max() <= 1e-5 * max(np.abs(v).max(), m_max), k


def test_failing_worker_reaches_master(monkeypatch):
    """As boda_tpu's master: each failed rank's rc and the end of its output,
    then the master's error."""
    monkeypatch.setenv("OMP_NUM_THREADS", THREADS)
    rc, out, err = _main(["dist_test_master", "--num-procs=2", "--steps=1",
                          "--model=no_such_model", "--device=cpu"])
    assert rc == 1
    assert "error: dist_test_master: worker process failed" in err
    for rank in range(2):
        m = re.search(rf"rank {rank} FAILED rc=1:\n(.*?)(?=\nrank \d FAILED|\Z)", out, re.S)
        assert m and "unknown model 'no_such_model'" in m.group(1), out


def _dryrun_body_losses(n_devices: int) -> list[float]:
    """The losses of ``__graft_entry__.py:_dryrun_body``'s two steps (it
    prints them to 4 places): boda_tpu's production step jitted over the
    (dp=2, tp=n/2) mesh, the same code on the 8 CPU devices."""
    from boda_tpu.models.zoo import build_mini_resnet
    from boda_tpu.parallel import mesh as jm
    dp, tp = 2, n_devices // 2
    mesh = jm.make_mesh({"dp": dp, "tp": tp})
    pipe, in_dims = build_mini_resnet(img=2 * dp, num_cls=16 * tp, in_sz=16)
    step = jmake_step(pipe, jlogits(pipe), lr=0.01, clip_norm=1.0, momentum=0.9,
                      bn_momentum=0.1, remat="seg")
    w_sh, in_sh = jm.weight_shardings(pipe, mesh), jm.input_shardings(in_dims, mesh)
    rng = np.random.RandomState(0)
    x = jax.device_put(rng.randn(*in_dims["data"].shape).astype(np.float32), in_sh["data"])
    y = jax.device_put(rng.randint(0, 16 * tp, size=(2 * dp,)).astype(np.int32),
                       jm.named_sharding(mesh, "dp"))
    w = {k: jax.device_put(v.data, w_sh[k]) for k, v in pipe.weights.items()}
    m_sh = {k: w_sh[k] for k in pipe.weights if not k.endswith(("__means", "__vars", "__sf"))}
    mom = {k: jax.device_put(np.zeros(pipe.weights[k].dims.shape, np.float32), m_sh[k])
           for k in m_sh}
    jstep = jax.jit(step, in_shardings=(w_sh, {"data": in_sh["data"]},
                                        jm.named_sharding(mesh, "dp"), m_sh),
                    out_shardings=(jm.named_sharding(mesh), w_sh, m_sh))
    losses = []
    with mesh:
        for _ in range(2):
            loss, w, mom = jstep(w, {"data": x}, y, mom)
            losses.append(float(loss))
    return losses


def test_dryrun_multichip_8(capsys, monkeypatch):
    """The production step on (dp=2, tp=4): two gloo ranks, each on its tp
    row of 4 CPU devices, bit-equal to each other, and their losses within
    1e-5 relative of boda_tpu's _dryrun_body on the same seeded batch."""
    monkeypatch.setenv("OMP_NUM_THREADS", THREADS)
    losses = dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(8): 2 ranks x (tp=4) over gloo, loss 5.6920 -> 5.5587" in out
    assert "dp=2 tp=4 sharded inference forward OK" in out
    want = _dryrun_body_losses(8)
    assert np.allclose(losses, want, rtol=1e-5, atol=0), (losses, want)


def test_one_rank_group_is_the_step_bit_for_bit(monkeypatch):
    """With a one-rank group every all-reduce is the identity and the
    step's graph keeps its shape: the loss, weights and momenta of two
    steps bit-equal to the step without a group, on both BN backward
    routes, the plain one under remat=seg (chip_smoke.py [dist] holds the
    same on a one-rank NCCL group)."""
    import torch.distributed as dist

    from boda_tpu_torch.modes.dist_modes import _free_port
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        pipe, dims = tbuild("mini_resnet", img=4, num_cls=16, in_sz=16)
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(*dims["data"].shape).astype(np.float32))
        y = torch.from_numpy(rng.randint(0, 16, size=(4,)).astype(np.int32))
        for vjp, remat in (("0", "seg"), ("1", "")):
            monkeypatch.setenv("BODA_TRAIN_VJP", vjp)
            runs = []
            for group in (None, dist.group.WORLD):
                step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9,
                                       bn_momentum=0.1, clip_norm=1.0, remat=remat,
                                       group=group)
                w = {k: torch.from_numpy(np.ascontiguousarray(v.data))
                     for k, v in pipe.weights.items()}
                mom, losses = None, []
                for _ in range(2):
                    loss, w, mom = step(w, {"data": x}, y, mom)
                    losses.append(loss)
                runs.append((losses, w, mom))
            (la, wa, ma), (lb, wb, mb) = runs
            assert all(torch.equal(a, b) for a, b in zip(la, lb)), vjp
            assert all(torch.equal(wa[k], wb[k]) for k in wa), vjp
            assert all(torch.equal(ma[k], mb[k]) for k in ma), vjp
    finally:
        dist.destroy_process_group()
