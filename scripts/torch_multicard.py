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
   (NCCL, a rank per card) and on the CPU (gloo).
4. tests/test_torch_cuda_mesh.py.

Prints the card's name and power limit and a line per check.

    python3 scripts/torch_multicard.py [--parent DIR]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default="", help="another checkout to run check 1 on first")
    args = ap.parse_args()
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
    if args.parent:
        optin(args.parent)  # reported, not gated: the parent may fail it
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
                     ("dist", lambda: cs.dist_phase(card, out_dir))):
        t = time.perf_counter()
        try:
            fn()
        except Exception:
            import traceback
            traceback.print_exc()
            ok = False
        laps[name] = time.perf_counter() - t
    if torch.cuda.device_count() >= 4:
        for dev in ("cuda", "cpu"):
            rc, lines, err = cs.run_cli_err(["dist_test_master", "--num-procs=4",
                                             "--devices-per-proc=1", "--steps=3",
                                             f"--device={dev}"])
            for ln in lines[-9:]:
                print(f"[dist4] {dev} {ln}")
            if rc:
                print(err[-1500:])
            ok &= rc == 0
    r = subprocess.run([sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
                        "tests/test_torch_cuda_mesh.py"], capture_output=True, text=True)
    print(r.stdout[-1500:], r.stderr[-800:])
    ok &= r.returncode == 0
    print(f"torch_multicard: {'OK' if ok else 'FAILED'}; seconds {laps}, "
          f"{time.perf_counter() - t0:.1f} in all ({card})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
