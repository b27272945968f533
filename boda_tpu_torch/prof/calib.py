"""Static int8 calibration sidecar: per-node activation amax.

Counterpart of ``boda_tpu/prof/calib.py``, copied, in the same JSON format,
so boda_tpu's sidecars (testdata/calib) read unchanged. ``net_calib``
(modes/calib.py) observes per-node |act| maxima over N batches and writes
them; an engine given ``calib_fn`` reads them, and its int8 conv/fc
lowerings then quantize with a static per-tensor scale instead of a
per-forward amax reduce, and its ``act_int8`` storage takes its scales
from them.
"""

from __future__ import annotations

import json
import os


def write_calib(fn: str, net: str, amax: dict[str, float], *,
                batches: int, compute_tn: str) -> None:
    rec = {"net": net, "batches": batches, "compute_tn": compute_tn,
           "amax": {k: float(v) for k, v in sorted(amax.items())}}
    tmp = fn + ".tmp"
    with open(tmp, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, fn)  # atomic: a reader never sees half a file


def read_calib(fn: str) -> dict[str, float]:
    """node name -> activation amax (absolute max over calibration batches)."""
    with open(fn) as f:
        rec = json.load(f)
    return {k: float(v) for k, v in rec["amax"].items()}
