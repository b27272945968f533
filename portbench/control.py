"""The readings that a cell's limits are set from, on the card, at the
cell's own sizes (not run by the benchmark's runs):

    python3 portbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds 2 [--quants fp8,bf16] [--faults]

For each of ``--seeds``: a whole run of the cell (set-up, a short window,
the check), its compared numbers, the lower readings. For each of
``--control-seeds``: the control (the reference in the program's place,
computed one precision below the configuration's: float8 for bfloat16,
the driver's ``control``; ``--quants`` adds others, such as ``bf16``, the
configuration's own precision, as a witness of the lower readings), and
with ``--faults`` a run with each of the driver's planted faults: the upper
readings. One JSON line per reading.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness as H  # noqa: E402
from portbench import run as R  # noqa: E402

FAULTS = {"serve": ["answer"], "detect": ["answer"], "train": ["unchanged", "half"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--quants", default="fp8")
    ap.add_argument("--faults", action="store_true")
    a = ap.parse_args(argv)
    import torch
    cell, cfg = H.load_cell(a.workload)
    drv = H.traffic_driver(cell["kind"])

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    for s in [int(v) for v in a.seeds.split(",") if v]:
        t = time.perf_counter()
        res = R.run_cell(a.workload, s, a.seconds, False, t_start=t)
        emit(what="program", seed=s, correct=res["correct"], secs=time.perf_counter() - t,
             **{k: c["value"] for k, c in res["checks"].items()}, **res["readings"])
    for s in [int(v) for v in a.control_seeds.split(",") if v]:
        r = R.Run(cell, cfg, s, a.seconds, False, torch.device("cuda", 0), time.perf_counter())
        for q in a.quants.split(","):
            emit(what=f"control:{q}", seed=s, **drv.control(r, q))
            torch.cuda.empty_cache()
        for f in (FAULTS[cell["kind"]] if a.faults else []):
            res = R.run_cell(a.workload, s, a.seconds, False, fault=f,
                             t_start=time.perf_counter())
            emit(what=f"fault:{f}", seed=s, **{k: c["value"] for k, c in res["checks"].items()},
                 **res["readings"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
