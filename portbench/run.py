"""The benchmark of boda_tpu_torch, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell on the card(s) of this machine: the cell's file
(``workloads/<cell>.json``) names its configuration (``configs/<config>.json``)
and its traffic driver (``traffic/<kind>.py``); the driver makes the weights
and inputs from the seed, sets up and warms the program, serves or steps it
for ``--seconds``, then checks what the timed path produced against the
plain reference (``reference/<model>.py``). ``--trace 0`` prints the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics, each read by its
own reader (``metrics/<metric>.py``) from a profiled sub-window after the
measured one. The last line of standard output is one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

A run exits with a code other than 0, and prints no result, when there is
no CUDA card (or fewer than the cell needs), and when the process has loaded
jax, jaxlib, flax or boda_tpu once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the checkout: the program
# Python's bytecode, PyTorch's above all, cached at a fixed place in the checkout: where the
# environment writes none (PYTHONDONTWRITEBYTECODE), every run would compile PyTorch's sources
# again on import, some six seconds of each set-up.
sys.pycache_prefix = str(Path(__file__).resolve().parents[1] / "build" / "pycache")
sys.dont_write_bytecode = False

from portbench import harness as H  # noqa: E402


class Run:
    """One run's settings and state, handed to the traffic driver."""

    def __init__(self, cell: dict, cfg: dict, seed: int, seconds: float, trace: bool,
                 dev, t_start: float, overrides: dict | None = None, fault: str | None = None):
        self.cell, self.cfg = cell, cfg
        self.params = {**cell["params"], **(overrides or {})}
        self.seed, self.seconds, self.trace = int(seed), float(seconds), bool(trace)
        self.dev, self.t_start, self.fault = dev, t_start, fault
        self.spans = H.Spans(self.trace)
        self.size = self.params.get("image_size", cfg["image_size"])

    def reference(self):
        import importlib
        return importlib.import_module(f"portbench.reference.{self.cfg['reference']}")

    def engine(self):
        """The configuration's engine of the program, on this run's device."""
        from boda_tpu_torch import graph  # noqa: F401  (registers the engines)
        from boda_tpu_torch.config import make
        e = dict(self.cfg["engine"])
        return make("conv_fwd", e.pop("mode"), device=self.dev.type, **e)


def run_cell(name: str, seed: int, seconds: float, trace: bool, dev=None,
             overrides: dict | None = None, fault: str | None = None,
             t_start: float | None = None) -> dict:
    """One run of a cell: the result object (without printing it). ``dev``
    None takes the card(s) and raises without them; the tests pass the CPU,
    ``overrides`` (smaller sizes) and ``fault`` (a fault planted under the
    timed path, named by the traffic driver)."""
    import torch
    cell, cfg = H.load_cell(name)
    if dev is None:
        if not torch.cuda.is_available():
            raise H.BenchError("no CUDA card: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell["chips"]:
            raise H.BenchError(f"cell {name} needs {cell['chips']} cards, "
                               f"torch sees {torch.cuda.device_count()}")
        dev = torch.device("cuda", 0)
    r = Run(cell, cfg, seed, seconds, trace, dev, T_START if t_start is None else t_start,
            overrides, fault)
    out = H.traffic_driver(cell["kind"]).run(r)
    e2e, per = H.cell_metrics(H.benchmark(), name)
    metrics = {}
    if trace:
        for m in per:
            v = H.metric_reader(m["name"]).read(out["reading"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] not in out["e2e"]:
                raise H.BenchError(f"the {cell['kind']} driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
    checks = H.checks_of(out["checks"], cell["limits"])
    res = {"correct": H.judge(checks), "attempted": out["attempted"], "failed": out["failed"],
           "metrics": metrics, "device": out["device"]}
    if trace and out.get("trace") is not None:
        tr = out["trace"]
        res["device"]["busy_s"] = out.get("busy_s", tr.busy()[0])
        res["device"]["window_s"] = tr.window_s
        res["breakdown"] = tr.breakdown()
    res["readings"] = {k: float(v) for k, v in out["checks"].items() if k not in checks}
    res["checks"] = checks
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    os.environ.setdefault("TRITON_CACHE_DIR", str(H.CHECKOUT / "build" / "triton"))
    try:
        res = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    except H.BenchError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    bad = H.forbidden_loaded()
    if bad:
        print(f"portbench: the process has loaded {bad}; the benchmark measures "
              f"boda_tpu_torch alone", file=sys.stderr)
        return 3
    for k, c in res["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
