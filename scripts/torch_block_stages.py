#!/usr/bin/env python3
"""K6 (the fused bottleneck, csrc/block.cu) per stage of the ResNet-50 b32 bf16
fused forward, beside the unfused library sequence for the same block
(cuBLAS, cuDNN, cuBLAS: chip_smoke.py's ``block_library``) and the bound, on
one card.

The four stage shapes (res2 56², res3 28², res4 14², res5 7²; 2, 3, 5 and 2
identity blocks per forward) are those chip_smoke.py takes from the fused
engine. Each is timed as chip_smoke.py times it: its device time, 20 calls
captured in one CUDA graph and replayed ("device"), and 20 back-to-back
calls between two CUDA events, L2 warm ("launch"). The bound is the larger
of the bytes (x read once, y written once, the weights once) over 3.35 TB/s
and the operations over 989 TFLOP/s (bf16, NVIDIA's H100 SXM data sheet).
``--root`` names the checkout whose ``boda_tpu_torch`` is timed, so that the
parent commit and a change can be timed on one card in one command (run
parent, change, change, parent); the route and plan are printed where that
tree keeps them. Prints the card's name and power limit, a line per stage
and, last, one JSON object with the totals per forward.

    python3 scripts/torch_block_stages.py [--root DIR] [--tag NAME]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# (n, h, c, k): blocks per b32 fused forward
STAGES = {(32, 56, 256, 64): 2, (32, 28, 512, 128): 3, (32, 14, 1024, 256): 5,
          (32, 7, 2048, 512): 2}
NAMES = {56: "res2", 28: "res3", 14: "res4", 7: "res5"}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose boda_tpu_torch to time")
    ap.add_argument("--tag", default="", help="a name for this tree in the output")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_block_stages: needs a CUDA card", file=sys.stderr)
        return 1
    # chip_smoke.py's timing, bound and library sequence, from this checkout
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.ops.kernels.block import bottleneck, bottleneck_plain
    from boda_tpu_torch.rtc.backends import graph_time

    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    rng = np.random.default_rng(0)

    def rnd(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, bf)

    tot = dict(device_ms=0.0, launch_ms=0.0, library_device_ms=0.0, library_launch_ms=0.0,
               bound_ms=0.0)
    stages = {}
    for (n, h, c, k), count in STAGES.items():
        ops = (rnd((n, h, h, c)), rnd((c, k), c ** -0.5), rnd((k,), 0.1),
               rnd((3, 3, k, k), (9 * k) ** -0.5), rnd((k,), 0.1), rnd((k, c), k ** -0.5),
               rnd((c,), 0.1))
        out = bottleneck(*ops)
        torch.cuda.synchronize()
        _, err = cs.rel_err(out, bottleneck_plain(*ops))
        if err > 1e-2:
            print(f"torch_block_stages: {NAMES[h]} rel err {err:.3g} > 1e-2", file=sys.stderr)
            return 1
        plan = getattr(bottleneck, "last_plan", None)
        lib = cs.block_library(*ops)
        fk = lambda: bottleneck(*ops)  # noqa: E731
        r = {"device_ms": graph_time(fk) * 1e3, "launch_ms": cs.cuda_ms(fk),
             "library_device_ms": graph_time(lib) * 1e3, "library_launch_ms": cs.cuda_ms(lib),
             "bound_ms": max(cs.work("block", (n, h, c, k))), "count": count,
             "plan": cs.block_plan_str(plan) if plan is not None else "-", "rel_err": err}
        stages[NAMES[h]] = r
        for key in tot:
            tot[key] += r[key] * count
        print(f"[{args.tag}] {NAMES[h]} {(n, h, c, k)} x{count}: device "
              f"{r['device_ms'] * 1e3:.1f} us (launched {r['launch_ms'] * 1e3:.1f}), library "
              f"device {r['library_device_ms'] * 1e3:.1f} us (launched "
              f"{r['library_launch_ms'] * 1e3:.1f}), bound {r['bound_ms'] * 1e3:.1f} us, "
              f"plan {r['plan']}, rel err {err:.2e}")
        del ops, out
    print(json.dumps({"tag": args.tag, "card": card, "per_forward": tot, "stages": stages}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
