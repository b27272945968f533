"""The benchmark's machinery, shared by every traffic driver and metric
reader: cells and configurations found by name, inputs and weights made
from the seed on the device, host spans, the profiler's trace reduced to
kernel classes, busy time and idle gaps, the result line and the check of
what the process has loaded.

Nothing here imports the program under test: the traffic drivers do.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent          # portbench/
CHECKOUT = ROOT.parent                          # where BENCHMARK.json lies
FORBIDDEN = ("jax", "jaxlib", "flax", "boda_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a bad cell file, a module it
    must not load)."""


# -- cells, configurations, metrics ------------------------------------------------------

def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_names() -> list[str]:
    return sorted(p.stem for p in (ROOT / "workloads").glob("*.json"))


def load_cell(name: str) -> tuple[dict, dict]:
    """(cell, configuration) of the cell file ``workloads/<name>.json``."""
    path = ROOT / "workloads" / f"{name}.json"
    if not path.is_file():
        raise BenchError(f"no cell {name!r}: have {cell_names()}")
    cell = load_json(path)
    cell["name"] = name
    return cell, load_json(ROOT / "configs" / f"{cell['config']}.json")


def benchmark() -> dict:
    return load_json(CHECKOUT / "BENCHMARK.json")


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports: those
    whose ``workloads`` name it, or that have none; a per-layer metric
    without ``workloads`` where its ``moves`` metric is reported."""
    def mine(m):
        return cell in m["workloads"] if "workloads" in m else None
    e2e = [m for m in bench["end_to_end"] if mine(m) is not False]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"]
           if mine(m) or (mine(m) is None and m["moves"] in names)]
    return e2e, per


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic_driver(kind: str):
    return load_module(ROOT / "traffic" / f"{kind}.py", f"portbench_traffic_{kind}")


def metric_reader(name: str):
    return load_module(ROOT / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


# -- seeds -------------------------------------------------------------------------------

def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (weights, inputs, sample) of a run."""
    h = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def sampled(seed: int, i: int, every: int) -> bool:
    """Whether unit i is kept for the check: about one in ``every``, drawn
    from the seed."""
    return subseed(seed, f"keep{i}") % every == 0


def check_sample(kept, seed: int, most: int) -> list:
    """The kept units the check compares: the first and the last, and the
    rest drawn from the seed, ``most`` in all."""
    idx = sorted(kept)
    if len(idx) <= most:
        return idx
    rng = np.random.default_rng(subseed(seed, "check"))
    mid = rng.choice(idx[1:-1], most - 2, replace=False).tolist()
    return sorted([idx[0], idx[-1]] + mid)


def generator(seed: int, tag: str, dev):
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(subseed(seed, tag))
    return g


def seeded_params(spec: list, seed: int, dev, dtype) -> dict:
    """Every parameter of a reference's ``spec`` on ``dev`` in ``dtype``,
    drawn from the seed in three calls (one normal, one uniform draw for all,
    then each leaf's slice scaled)."""
    import torch
    g = generator(seed, "weights", dev)
    normal = [s for s in spec if s[2][0] in ("he", "normal")]
    uniform = [s for s in spec if s[2][0] == "uniform"]
    zn = torch.randn(sum(math.prod(s[1]) for s in normal), generator=g, device=dev)
    zu = torch.rand(sum(math.prod(s[1]) for s in uniform), generator=g, device=dev)
    out, on, ou = {}, 0, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init[0] == "he":
            _, fan_in, gain = init
            t = zn[on:on + n] * (gain * math.sqrt(2.0 / fan_in))
            on += n
        elif init[0] == "normal":
            t = zn[on:on + n] * init[2] + init[1]
            on += n
        elif init[0] == "uniform":
            t = zu[ou:ou + n] * (init[2] - init[1]) + init[1]
            ou += n
        else:
            t = torch.full((n,), float(init[1]), device=dev)
        out[name] = t.reshape(shape).to(dtype)
    return out


def seeded_images(seed: int, tag: str, shape: tuple, dev):
    """uint8 RGBA images, uniform over 0..255, drawn on ``dev``."""
    import torch
    g = generator(seed, tag, dev)
    return torch.randint(0, 256, shape, generator=g, device=dev, dtype=torch.uint8)


# -- host spans ----------------------------------------------------------------------------

class Spans:
    """Host time per span name, from the benchmark's own clock around the
    program's calls; under the profiler each span is also a
    ``record_function`` range, so the trace can name what the host did."""

    def __init__(self, on: bool):
        self.on = on
        self.total: dict[str, float] = {}
        self.count: dict[str, int] = {}

    def span(self, name: str):
        return _Span(self, name) if self.on else _NULL


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.s, self.name = spans, name

    def __enter__(self):
        import torch
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.rf.__exit__(*exc)
        self.s.total[self.name] = self.s.total.get(self.name, 0.0) + dt
        self.s.count[self.name] = self.s.count.get(self.name, 0) + 1
        return False


# -- statistics ----------------------------------------------------------------------------

def p95(values: list) -> float:
    """The 95th percentile of all values (``statistics.quantiles``' default
    method, 20 groups)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20)[18]


def union_busy(intervals: list, lo: float, hi: float) -> tuple[float, list]:
    """(total length of the union of [start, end) intervals clipped to
    [lo, hi), the gaps between them as (start, end))."""
    busy, gaps, cur = 0.0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if hi > cur:
        gaps.append((cur, hi))
    return busy, gaps


# -- kernel classes ------------------------------------------------------------------------

def kernel_rules() -> list[tuple[str, str]]:
    """(class, name fragment) rules from ``kernel_classes/<NN>.<class>[.<tag>].txt``,
    files in the order of NN, fragments in file order; a line's text after
    ``#`` is a comment."""
    rules = []
    files = sorted((ROOT / "kernel_classes").glob("*.txt"),
                   key=lambda p: (int(p.name.split(".")[0]), p.name))
    for p in files:
        cls = p.name.split(".")[1]
        for line in p.read_text().splitlines():
            frag = line.split("#", 1)[0].strip()
            if frag:
                rules.append((cls, frag.lower()))
    return rules


def kernel_class(name: str, rules: list) -> str:
    """The class of the first rule whose fragment the kernel's name holds
    (case aside); ``pytorch`` where none does."""
    low = name.lower()
    for cls, frag in rules:
        if frag in low:
            return cls
    return "pytorch"


# -- the profiler's trace ------------------------------------------------------------------

class Trace:
    """What one profiled sub-window saw: the device's kernels and the
    benchmark's host spans, on the profiler's clock (microseconds), and the
    window's bounds (the ``pb.window`` range, which closes after a
    synchronize)."""

    def __init__(self, kernels: list, spans: list, window: tuple, units: int):
        self.kernels = kernels      # (name, start_us, end_us)
        self.spans = spans          # (name, start_us, end_us)
        self.window = window
        self.units = units          # batches, requests or steps in the window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> tuple[float, list]:
        """(device-busy seconds, idle gaps in us) over the window."""
        b, gaps = union_busy([(s, e) for _, s, e in self.kernels], *self.window)
        return b / 1e6, gaps

    def class_ms(self, rules: list) -> dict:
        """Device ms per kernel class over the window."""
        out: dict = {}
        for n, s, e in self.kernels:
            c = kernel_class(n, rules)
            out[c] = out.get(c, 0.0) + (e - s) / 1e3
        return out

    def breakdown(self) -> dict:
        by: dict = {}
        for n, s, e in self.kernels:
            by[n] = by.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by.items(), key=lambda kv: -kv[1])[:10]
        _, gaps = self.busy()
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
            open_ = [sp for sp in self.spans if sp[1] <= s < sp[2] and sp[0] != "pb.window"]
            what = max(open_, key=lambda sp: sp[1])[0] if open_ else "no span"
            named.append([what, (e - s) / 1e6])
        return {"device_ops": [[n[:160], v] for n, v in ops], "idle_gaps": named}


def profile(fn, units: int) -> Trace:
    """Run ``fn`` (which runs ``units`` units and returns once the device has
    finished them) under ``torch.profiler`` with CPU and CUDA activity. A
    lead-in kernel runs first, since the profiler can drop the first device
    records of its window (frozen from chip_smoke.py:1792, ``device_kernels``);
    it is not counted."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        with torch.profiler.record_function("pb.window"):
            fn()
            torch.cuda.synchronize()
    kernels, spans, window = [], [], None
    for e in prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the device side of a host range (a user annotation) is no kernel
            if e.name.startswith("pb.") or getattr(e, "is_user_annotation", False) or \
                    "Memcpy" in e.name or "Memset" in e.name or "spin_kernel" in e.name:
                continue
            kernels.append((e.name, s, t))
        elif e.name.startswith("pb."):
            spans.append((e.name, s, t))
            if e.name == "pb.window":
                window = (s, t)
    if window is None:
        raise BenchError("the profiler recorded no pb.window range")
    return Trace(kernels, spans, window, units)


def cuda_ms(fn, n: int) -> float:
    """Device ms per call of ``fn`` over ``n`` calls back to back, between
    two CUDA events, after two calls of warm-up."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


# -- the result ----------------------------------------------------------------------------

def forbidden_loaded() -> list[str]:
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``boda_tpu_torch`` is not ``boda_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def judge(checks: dict) -> bool:
    """Every compared number at or under its limit (and a number at all)."""
    return all(isinstance(c["value"], (int, float)) and math.isfinite(c["value"])
               and c["value"] <= c["limit"] for c in checks.values())


def checks_of(values: dict, limits: dict) -> dict:
    missing = sorted(set(limits) - set(values))
    if missing:
        raise BenchError(f"the check gave no number for {missing}")
    return {k: {"value": float(values[k]), "limit": float(limits[k])} for k in limits}


def device_info(dev, count: int) -> dict:
    import torch
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
