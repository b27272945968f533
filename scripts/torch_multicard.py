#!/usr/bin/env python3
"""The multi-device paths of boda_tpu_torch across distinct cards (run it on
a machine with two cards or more; four for the 4-rank case).

1. The kernels' per-device state: K6 (the bottleneck at ResNet-50's res2,
   32x56x56x256, K 64), K8 (pool1, 3x3 s2 max over 32x112x112x64, the rows
   route) and K9 (the b32 residual add, the ring route), whose launches use
   more than 48 KB of shared memory, on cuda:0 and then on cuda:1, each
   against its plain version. A tree that caches the opt-in for the first
   card only fails the second card's launches. ``--parent DIR`` runs the
   same check on another checkout first (the parent commit, say), so that
   the two are compared in one command.
2. chip_smoke.py's ``[mesh]`` (the engine's dp=2 mesh on cuda:0 and cuda:1,
   lib (dp=2,tp=2) over four cards, gen_src_dir) and ``[dist]`` (the
   golden 2x2 and flagship cases, NCCL when every rank has a card, a
   one-rank NCCL group) phases, as chip_smoke.py runs them.
3. ``dist_test_master --num-procs=4 --devices-per-proc=1`` on the cards
   (NCCL, a rank per card), its step captured (``--cuda-graph=1``) against
   eager (``=0``), mini_resnet and the flagship worker (resnet50 224x224,
   1000 classes, remat=seg), each rank's ms per step of both side by side
   and their losses within DIST4_TOL; and mini_resnet on the CPU (gloo).
4. tests/test_torch_cuda_mesh.py.
5. The training step split over tp across cards (parallel/train.py with a
   mesh): ResNet-50 b32 bf16 gen, momentum 0.9, clip 1, train-mode BN, the
   batch fixed, as chip_smoke.py's ``[tp-train]`` runs it: (tp=4) over
   cuda:0-3 in one process, and (dp=2,tp=2) as two ranks of two cards each
   (gloo, on the CUDA tensors: NCCL takes one device per rank), each
   against the one-card step without a mesh: the losses within
   chip_smoke.TRAIN_TOL, ms per step.

Prints the card's name and power limit and a line per check.

    python3 scripts/torch_multicard.py [--parent DIR] [--checks 1,2,3,4,5]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST4_TOL = 1e-4  # the captured step's losses against the eager step's, relative

# one launch each of K6, K8 and K9 above 48 KB of shared memory on cuda:0,
# then on cuda:1, in the tree named by argv[1]
OPTIN = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from boda_tpu_torch.ops.kernels.block import bottleneck, bottleneck_plain
from boda_tpu_torch.ops.kernels.pool import pool2d, pool2d_plain
from boda_tpu_torch.ops.kernels.elementwise import eltwise, eltwise_plain
import boda_tpu_torch.ops.kernels.build as b
print("tree", b.__file__)
g = torch.Generator().manual_seed(0)
def r(*s, scale=1.0): return (torch.randn(*s, generator=g) * scale).bfloat16()
x, w1, b1 = r(32, 56, 56, 256), r(256, 64, scale=1 / 16), r(64, scale=0.1)
w2, b2, w3, b3 = r(3, 3, 64, 64, scale=1 / 24), r(64, scale=0.1), r(64, 256, scale=1 / 8), r(256, scale=0.1)
xp = r(32, 112, 112, 64)
ea, eb = r(32, 56, 56, 256), r(32, 56, 56, 256)
for dev in ("cuda:0", "cuda:1"):
    for name, fn, plain, args in (
            ("K6 bottleneck res2", bottleneck, bottleneck_plain, (x, w1, b1, w2, b2, w3, b3)),
            ("K8 pool1 3x3 s2 max", lambda t: pool2d(t, (3, 3), (2, 2), (0, 1), (0, 1), 56, 56, False),
             lambda t: pool2d_plain(t, (3, 3), (2, 2), (0, 1), (0, 1), 56, 56, False), (xp,)),
            ("K9 add b32", lambda a, c: eltwise("add", a, c), lambda a, c: eltwise_plain("add", a, c), (ea, eb))):
        ins = [t.to(dev) for t in args]
        try:
            y = fn(*ins)
            torch.cuda.synchronize(dev)
            err = float((y.float() - plain(*ins).float()).abs().max())
            print(f"OPTIN {dev} {name}: ok, max|err| {err:.3e}", flush=True)
        except Exception as e:
            print(f"OPTIN {dev} {name}: FAILED {type(e).__name__}: {str(e)[:160]}", flush=True)
'''


def optin(tree: str) -> bool:
    r = subprocess.run([sys.executable, "-c", OPTIN, os.path.abspath(tree)],
                       capture_output=True, text=True, timeout=900)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith(("OPTIN", "tree"))]
    print(f"== the second card's shared-memory opt-ins, {tree}: rc {r.returncode}")
    print("\n".join(lines))
    if r.returncode:
        print(r.stderr[-2000:])
    return r.returncode == 0 and not any("FAILED" in ln for ln in lines)


# one rank of the (dp=2,tp=2) step over four cards: argv = tree, rank, port,
# fc1000's scale, steps; prints its losses and ms per step
TP_RANK = r'''
import json, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np, torch, torch.distributed as dist
import chip_smoke as cs
from boda_tpu_torch.modes.cnet import load_net
from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern
from boda_tpu_torch.parallel.dryrun import rows_backend
from boda_tpu_torch.parallel.mesh import make_mesh, shard_weights
from boda_tpu_torch.parallel.train import make_train_step
rank, port, fc_scale, n = int(sys.argv[2]), sys.argv[3], float(sys.argv[4]), int(sys.argv[5])
torch.backends.cuda.matmul.fp32_precision = "ieee"
torch.backends.cudnn.conv.fp32_precision = "ieee"
mesh = make_mesh({"dp": 2, "tp": 2}, devices=[torch.device("cuda", i) for i in range(4)])
lead = mesh.device(dp=rank, tp=0)
torch.cuda.set_device(lead)
dist.init_process_group(rows_backend(mesh), init_method="tcp://localhost:" + port,
                        world_size=2, rank=rank)
half = cs.BATCH // 2
pipe, dims = load_net("resnet50", img=half)
cs.scale_fc1000([pipe], fc_scale)
d = dims["data"]
x = gen_data_pattern((cs.BATCH,) + tuple(d.shape[1:]), d.tn)[rank * half:(rank + 1) * half]
x = x.to(lead, torch.bfloat16)
y = (torch.arange(cs.BATCH) % 1000)[rank * half:(rank + 1) * half].to(lead)
w = shard_weights({k: torch.from_numpy(np.asarray(v.data, np.float32)).to(lead, torch.bfloat16)
                   for k, v in pipe.weights.items()}, pipe, mesh, rank)
step = make_train_step(pipe, "fc1000", group=dist.group.WORLD, mesh=mesh, **cs.TP_KW)
mom, losses, ms = None, [], []
for _ in range(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, w, mom = step(w, {"data": x}, y, mom)
    losses.append(float(loss))
    ms.append((time.perf_counter() - t0) * 1e3)
print("TPRANK " + json.dumps({"rank": rank, "losses": losses, "ms": ms,
                              "backend": rows_backend(mesh)}), flush=True)
dist.destroy_process_group()
'''


def tp_cards(card: str, fc_scale: float) -> bool:
    """Check 5: the (tp=4) step in this process and the (dp=2,tp=2) step as
    two ranks, each against the one-card step without a mesh."""
    import json

    import numpy as np
    import torch

    import chip_smoke as cs
    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.modes.dist_modes import _free_port
    from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern
    from boda_tpu_torch.parallel.mesh import make_mesh, shard_weights
    from boda_tpu_torch.parallel.train import make_train_step
    pipe, dims = load_net("resnet50", img=cs.BATCH)
    cs.scale_fc1000([pipe], fc_scale)
    d = dims["data"]
    x = gen_data_pattern(d.shape, d.tn).to("cuda:0", torch.bfloat16)
    y = (torch.arange(cs.BATCH) % 1000).to("cuda:0")
    w0 = {k: torch.from_numpy(np.asarray(v.data, np.float32)).to("cuda:0", torch.bfloat16)
          for k, v in pipe.weights.items()}
    runs, ok = {}, True

    def report(tag, losses, ms):
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, runs["one card"][0]))
        print(f"[tp-cards] resnet50 b{cs.BATCH} bf16 gen {tag}: losses "
              f"{[f'{v:.6g}' for v in losses]} (max rel {rel:.3e} from one card, tol "
              f"{cs.TRAIN_TOL}); ms per step {[f'{v:.3f}' for v in ms]} ({card})", flush=True)
        return rel <= cs.TRAIN_TOL and losses[-1] < losses[0]
    for tag, mesh in (("one card", None),
                      ("(tp=4) cuda:0-3", make_mesh({"tp": 4}, devices=[
                          torch.device("cuda", i) for i in range(4)]))):
        step = make_train_step(pipe, "fc1000", mesh=mesh, **cs.TP_KW)
        w = w0 if mesh is None else shard_weights(w0, pipe, mesh)
        mom, losses, ms = None, [], []
        for _ in range(cs.TP_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, w, mom = step(w, {"data": x}, y, mom)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[tag] = (losses, ms)
        ok &= report(tag, losses, ms)
        del step, w, mom
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", TP_RANK, HERE, str(r), port,
                               repr(fc_scale), str(cs.TP_STEPS)], cwd=HERE,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0] + "\n(killed after 300 s)")
    lines = [next((ln for ln in o.splitlines() if ln.startswith("TPRANK ")), None)
             for o in outs]
    if any(p.returncode for p in procs) or None in lines:
        for r, (p, o) in enumerate(zip(procs, outs)):
            print(f"[tp-cards] (dp=2,tp=2) rank {r} rc={p.returncode}:\n"
                  + "\n".join(ln for ln in o.splitlines() if "socket.cpp" not in ln)[-3000:])
        return False
    ranks = [json.loads(ln[len("TPRANK "):]) for ln in lines]
    ok &= ranks[0]["losses"] == ranks[1]["losses"]
    return ok & report("(dp=2,tp=2) 2 ranks x 2 cards over " + ranks[0]["backend"],
                       ranks[0]["losses"],
                       [max(a, b) for a, b in zip(ranks[0]["ms"], ranks[1]["ms"])])


def dist4(card: str) -> bool:
    """Check 3: four ranks over NCCL, a card each, the step captured against
    eager, mini_resnet and the flagship worker; mini_resnet over gloo on the
    CPU."""
    import re

    import chip_smoke as cs

    def master(*extra):
        rc, lines, err = cs.run_cli_err(["dist_test_master", "--num-procs=4",
                                         "--devices-per-proc=1", *extra])
        for ln in lines[-13:]:
            print(f"[dist4] {' '.join(extra)}: {ln}", flush=True)
        if rc:
            print(err[-1500:])
            return None
        ms = [[float(v) for v in m.group(1).split(",")] for m in
              (re.search(r"ms_per_step=([\d.,]+)", ln) for ln in lines) if m]
        loss = [float(v) for v in re.search(r"losses=([\d.,-]+)",
                                            "\n".join(lines)).group(1).split(",")]
        digest = re.search(r"digest=(\w+)", "\n".join(lines)).group(1)
        return ms, loss, digest
    ok = master("--steps=3", "--device=cpu") is not None
    for model, steps in ((("--model=mini_resnet",), 5),
                         (("--model=resnet50", "--in-sz=224", "--num-cls=1000"), 3)):
        runs = {cg: master(f"--steps={steps}", f"--cuda-graph={cg}", *model) for cg in (1, 0)}
        if None in runs.values():
            ok = False
            continue
        (gms, gl, gd), (ems, el, ed) = runs[1], runs[0]
        rel = max(abs(a - b) / abs(b) for a, b in zip(gl, el))
        # per step, the slowest rank
        slow = [[max(r[i] for r in ms) for i in range(steps)] for ms in (gms, ems)]
        print(f"[dist4] {model[0][8:]} 4 ranks over NCCL, ms per step (the slowest rank): "
              f"captured {[f'{v:.3f}' for v in slow[0]]} (the first: 2 warm-up steps and the "
              f"capture), eager {[f'{v:.3f}' for v in slow[1]]}; losses captured {gl} vs "
              f"eager {el}, max rel {rel:.3e} (tol {DIST4_TOL}); digests bit-equal "
              f"{gd == ed} ({card})", flush=True)
        ok &= rel <= DIST4_TOL
    return ok


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="", help="another checkout to run check 1 on first")
    ap.add_argument("--checks", default="1,2,3,4,5", help="the checks to run, e.g. 5")
    args = ap.parse_args()
    checks = {int(c) for c in args.checks.split(",")}
    sys.path.insert(0, HERE)
    os.chdir(HERE)
    import numpy as np
    import torch

    import chip_smoke as cs
    from boda_tpu_torch.config import make
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.ops.kernels import build
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    t0 = time.perf_counter()
    if torch.cuda.device_count() < 2:
        print("torch_multicard: needs two cards or more", file=sys.stderr)
        return 1
    kb = build.load()
    card = cs.smi()
    print(f"{card} | device_count {torch.cuda.device_count()} | build {kb.build_secs:.1f} s")
    ok = True
    if args.parent and 1 in checks:
        optin(args.parent)  # reported, not gated: the parent may fail it
    if 1 in checks:
        ok &= optin(HERE)
    out_dir = build.BUILD_DIR.parent / "chip_smoke"
    pipe, in_dims = load_net("resnet50", img=cs.BATCH)  # fc1000 scaled as main() scales it
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    fc_max = float(np.abs(eng.run_fwd(gen_data_inputs(in_dims), ["fc1000"])["fc1000"].data).max())
    del eng
    laps = {}
    for name, fn in (("mesh", lambda: cs.mesh_phase(card, 1.0 / fc_max, out_dir,
                                                    cs.counted_wrappers())),
                     ("dist", lambda: cs.dist_phase(card, out_dir))) if 2 in checks else ():
        t = time.perf_counter()
        try:
            fn()
        except Exception:
            import traceback
            traceback.print_exc()
            ok = False
        laps[name] = time.perf_counter() - t
    if torch.cuda.device_count() >= 4 and 3 in checks:
        t = time.perf_counter()
        ok &= dist4(card)
        laps["dist4"] = time.perf_counter() - t
    if torch.cuda.device_count() >= 4 and 5 in checks:
        t = time.perf_counter()
        try:
            ok &= tp_cards(card, 1.0 / fc_max)
        except Exception:
            import traceback
            traceback.print_exc()
            ok = False
        laps["tp-cards"] = time.perf_counter() - t
    if 4 in checks:
        r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
                            "tests/test_torch_cuda_mesh.py"], capture_output=True, text=True)
        print(r.stdout[-1500:], r.stderr[-800:])
        ok &= r.returncode == 0
    print(f"torch_multicard: {'OK' if ok else 'FAILED'}; seconds {laps}, "
          f"{time.perf_counter() - t0:.1f} in all ({card})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
