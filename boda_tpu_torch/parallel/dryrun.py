"""The multi-device dryrun: the production training step across ranks and
the engine's dp x tp forward, each checked.

Counterpart of ``dryrun_multichip`` (``__graft_entry__.py:29-152``), which
jits boda_tpu's full training step over an n-device dp x tp mesh and runs
the sharded inference forward against the single-device engine. Here:

1. the full production step (momentum, clip, train-mode BatchNorm,
   ``remat=seg``) on the ``(dp=2,tp=n/2)`` mesh: two ranks of a
   ``torch.distributed`` group, each stepping its half of the batch on its
   tp row of n/2 devices (parallel/train.py's dp x tp step; the weights and
   momenta split over out_chan as boda_tpu's ``weight_shardings`` splits
   them), compiled as boda_tpu jits it (``cuda_graph``: captured where
   the ranks talk over NCCL, eager over gloo), two steps: the loss
   finite, the BN statistics moved, every rank's losses and its gathered
   weights and momenta the same bits;
2. the engine's ``(dp=2,tp=n/2)`` forward under ``kernel_policy=lib`` on n
   logical devices (the engine's device repeated n times) against the
   single-device engine, ``comp_vars`` at 1e-5.

The n devices are the CPU n times, or on the card ``mesh_devices``' rule:
the cards in turn (one card: cuda:0 n times). The ranks talk over NCCL
where each rank's row is one card of its own, else over gloo (on the CUDA
tensors where they lie on cards).

    python -m boda_tpu_torch.parallel.dryrun 8 [cpu]
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _case(n_devices: int):
    """boda_tpu's dryrun mesh and net: dp 2 (1 for odd n), tp n/dp;
    mini_resnet at 2 images per dp slice, 16 * tp classes."""
    from ..models.zoo import build_mini_resnet
    dp = 2 if n_devices % 2 == 0 else 1
    tp = n_devices // dp
    pipe, in_dims = build_mini_resnet(img=2 * dp, num_cls=16 * tp, in_sz=16)
    return dp, tp, pipe, in_dims


def _batch(in_dims, n_cls: int):
    rng = np.random.RandomState(0)
    x = rng.randn(*in_dims["data"].shape).astype(np.float32)
    labels = rng.randint(0, n_cls, size=(x.shape[0],)).astype(np.int32)
    return x, labels


def _mesh(n_devices: int, dp: int, tp: int, device: str):
    """The (dp, tp) mesh over n devices (module docstring), and the ranks'
    backend (``rows_backend``)."""
    import torch

    from ..parallel.mesh import make_mesh
    if device == "cpu":
        devs = [torch.device("cpu")] * n_devices
    else:
        cards = torch.cuda.device_count()
        devs = [torch.device("cuda", i % cards) for i in range(n_devices)]
    mesh = make_mesh({"dp": dp, "tp": tp}, devices=devs)
    return mesh, rows_backend(mesh)


def rows_backend(mesh) -> str:
    """The process group's backend for ranks that each step one tp row of
    ``mesh``: NCCL where each row is one card of its own (NCCL takes one
    device per rank), else gloo."""
    from ..parallel.mesh import tp_row
    rows = [set(tp_row(mesh, i)) for i in range(mesh.size("dp"))]
    one_card = all(len(r) == 1 and next(iter(r)).type == "cuda" for r in rows)
    return "nccl" if one_card and len(set().union(*rows)) == len(rows) else "gloo"


def rank_body(rank: int, world: int, coord: str, n_devices: int, device: str) -> dict:
    """One rank of part 1: two production steps on this rank's slice of
    the batch and its tp row; returns its losses, whether the BN
    statistics moved, and a digest of its gathered weights and momentum."""
    import torch
    import torch.distributed as dist

    from ..parallel.mesh import gather_weights, shard_weights, tp_row
    from ..parallel.train import find_logits_node, make_train_step
    _, tp, pipe, in_dims = _case(n_devices)
    mesh, backend = _mesh(n_devices, world, tp, device)
    dev = tp_row(mesh, rank)[0]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coord}",
                            world_size=world, rank=rank)
    step = None
    try:
        # compiled as __graft_entry__.py jits its step: captured where the
        # ranks talk over NCCL, each row on one card; eager otherwise
        step = make_train_step(pipe, find_logits_node(pipe), lr=0.01, clip_norm=1.0,
                               momentum=0.9, bn_momentum=0.1, remat="seg",
                               group=dist.group.WORLD, mesh=mesh, cuda_graph=True)
        x, labels = _batch(in_dims, 16 * tp)
        per = x.shape[0] // world
        xs = torch.from_numpy(x[rank * per:(rank + 1) * per]).to(dev)
        ys = torch.from_numpy(labels[rank * per:(rank + 1) * per]).to(dev)
        w = shard_weights({k: torch.from_numpy(np.ascontiguousarray(v.data))
                           for k, v in pipe.weights.items()}, pipe, mesh, rank)
        bn_k = next(k for k in w if k.endswith("__means"))
        bn0 = w[bn_k].cpu().numpy()
        mom, losses = None, []
        for _ in range(2):
            loss, w, mom = step(w, {"data": xs}, ys, mom)
            losses.append(float(loss))
        h = hashlib.sha256()
        for d in (w, mom):
            d = gather_weights(d, torch.device("cpu"))
            for k in sorted(d):
                h.update(d[k].detach().numpy().tobytes())
        return {"rank": rank, "losses": losses, "digest": h.hexdigest(), "backend": backend,
                "bn_moved": not np.allclose(w[bn_k].cpu().numpy(), bn0)}
    finally:
        if step is not None:  # NCCL's teardown waits for the graph that holds its kernels
            step.release()
        dist.destroy_process_group()


def _train_across_ranks(n_devices: int, device: str, world: int = 2) -> list[dict]:
    from ..modes.dist_modes import _free_port
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH", "")) if p))
    code = ("import json, sys\n"
            "from boda_tpu_torch.parallel.dryrun import rank_body\n"
            "r = rank_body(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], "
            "int(sys.argv[4]), sys.argv[5])\n"
            "print('DRYRUN ' + json.dumps(r))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), str(world), coord,
                               str(n_devices), device], cwd=_ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    res = []
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        line = next((ln for ln in out.splitlines() if ln.startswith("DRYRUN ")), None)
        if p.returncode != 0 or line is None:
            raise RuntimeError(f"dryrun_multichip: rank {r} failed rc={p.returncode}:\n"
                               f"{out[-2000:]}")
        res.append(json.loads(line[len("DRYRUN "):]))
    return res


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[float]:
    """Both parts; raises on any failure (a parity miss included). Returns
    part 1's losses."""
    import torch

    from ..config import make
    from ..parallel.mesh import make_mesh
    from ..utils.digest import comp_vars
    from ..utils.dims import NDA
    dp, tp, pipe, in_dims = _case(n_devices)
    ranks = _train_across_ranks(n_devices, device, world=dp)
    r0 = ranks[0]
    if not all(np.isfinite(r0["losses"])):
        raise RuntimeError(f"dryrun_multichip: non-finite loss {r0['losses']}")
    if not r0["bn_moved"]:
        raise RuntimeError("dryrun_multichip: train-mode BN stats did not update")
    for r in ranks[1:]:
        if (r["losses"], r["digest"]) != (r0["losses"], r0["digest"]):
            raise RuntimeError(f"dryrun_multichip: rank {r['rank']} {r['losses']} "
                               f"differs from rank 0 {r0['losses']}")
    print(f"dryrun_multichip({n_devices}): {len(ranks)} ranks x (tp={tp}) over "
          f"{r0['backend']}, loss {r0['losses'][0]:.4f} -> {r0['losses'][1]:.4f} "
          "(momentum+BN-stats+remat threaded, ranks bit-equal) OK")

    x, _ = _batch(in_dims, 16 * tp)
    ins = {"data": NDA(in_dims["data"], x)}
    mesh = make_mesh({"dp": dp, "tp": tp}, devices=[torch.device(device)] * n_devices)
    eng = make("conv_fwd", "cuda", device=device, kernel_policy="lib", mesh=mesh)
    eng.init(pipe)
    probs = eng.run_fwd(ins, ["prob"])["prob"].data
    if not np.all(np.isfinite(probs)):
        raise RuntimeError("dryrun_multichip: non-finite inference probs")
    eng1 = make("conv_fwd", "cuda", device=device, kernel_policy="lib")
    eng1.init(pipe)
    probs1 = eng1.run_fwd(ins, ["prob"])["prob"].data
    res = comp_vars(probs, probs1, mrd_toler=1e-5, atol=1e-8)
    if not res.ok():
        raise RuntimeError(f"dryrun_multichip: sharded-vs-single parity FAILED: {res}")
    print(f"dryrun_multichip({n_devices}): dp={dp} tp={tp} sharded inference forward OK "
          f"(prob sum {float(probs.sum()):.3f}, parity vs single-device "
          f"mrd={res.mrd:.2e}, gate rel 1e-5 + atol 1e-8)")
    return r0["losses"]


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]), *sys.argv[2:3])
