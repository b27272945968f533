"""Offline batch serving (kind ``serve``): the program's served entry
(boda_tpu_torch/modes/serve_bench.py: ``ServedNet``, ``Uploader``,
``serve_batches``) at full speed. A pool of ``pool`` distinct batches of
``batch`` uint8 RGBA images is made from the seed and pinned; the window
cycles them through upload, preprocess and net (one CUDA graph) with
``pipeline_depth`` batches in flight, every batch started before the
window's end finished and counted.

Check: the ``out`` node of a sample of the window's batches (about one in
``sample_every``, drawn from the seed, at most ``check_max``) against the
reference's float32 forward of the same images and weights: the widest
relative gap ||program - reference|| / ||reference|| over the images.

Fault ``answer``: one sampled batch's output altered where the graph
produces it (image 0's logits shifted by one class).
"""

from __future__ import annotations

import time

import torch

from portbench import harness as H
from portbench import program as P
from portbench.reference import common as RC


class Keep:
    """The ``outs`` list that ``serve_batches`` appends each batch's output
    to: keeps those of the sampled batches."""

    def __init__(self, seed: int, every: int):
        self.seed, self.every, self.i, self.kept = seed, every, 0, {}

    def append(self, t):
        if H.sampled(self.seed, self.i, self.every):
            self.kept[self.i] = t
        self.i += 1


class SpannedServed:
    def __init__(self, served, spans, alter_at=None):
        self.s, self.spans, self.alter_at, self.calls = served, spans, alter_at, 0

    def run(self, u8=None, ready=None):
        with self.spans.span("pb.replay"):
            out = self.s.run(u8, ready)
        if self.calls == self.alter_at:
            out = out.clone()
            out[0] = out[0].roll(1)
        self.calls += 1
        return out


class SpannedUploader:
    def __init__(self, up, spans):
        self.up, self.spans, self.n, self.dev = up, spans, up.n, up.dev

    def upload(self, i, src):
        with self.spans.span("pb.upload"):
            return self.up.upload(i, src)

    def release(self, i):
        with self.spans.span("pb.release"):
            self.up.release(i)


def batches(pool: list, n: int = 0, until: float = 0.0):
    """(i, pool[i % len(pool)]) for n batches, or until the clock passes
    ``until``."""
    i = 0
    while (i < n) if n else (time.perf_counter() < until):
        yield i, pool[i % len(pool)]
        i += 1


def run(r) -> dict:
    from boda_tpu_torch.modes.serve_bench import ServedNet, Uploader, serve_batches
    p, dev = r.params, r.dev
    B, depth = p["batch"], p["pipeline_depth"]
    pipe, d, w = P.net_with_weights(r, B, torch.bfloat16)
    eng = r.engine()
    eng.init(pipe)
    served = ServedNet(eng, p["out"], B, d["y"], d["x"]).build()
    images = H.seeded_images(r.seed, "images", (p["pool"] * B, d["y"], d["x"], 4), dev)
    pool = P.pinned_pool(images, p["pool"], B, dev)
    up = Uploader((B, d["y"], d["x"], 4), dev, depth + 1)
    alter_at = None
    if r.fault == "answer":
        alter_at = next(i for i in range(1 << 20) if H.sampled(r.seed, i, p["sample_every"]))
    elif r.fault is not None:
        raise H.BenchError(f"serve: no fault {r.fault!r}")
    svc = SpannedServed(served, r.spans)
    upl = SpannedUploader(up, r.spans)
    serve_batches(svc, upl, batches(pool, p["warm_batches"]), depth)
    sink = Keep(r.seed, p["sample_every"])
    svc.calls, svc.alter_at = 0, alter_at

    t0 = time.perf_counter()
    n, _ = serve_batches(svc, upl, batches(pool, until=t0 + r.seconds), depth, outs=sink)
    secs = time.perf_counter() - t0
    out = {"e2e": {"serve_img_per_s": n * B / secs, "setup_s": t0 - r.t_start},
           "attempted": n, "failed": 0}

    reading = {"kind": "serve", "training": False, "images_per_unit": B,
               "rate_img_s": n * B / secs, "spans": r.spans,
               "layers": r.reference().layers(r.cfg, B, r.size)}
    if r.trace and dev.type == "cuda":
        reading["trace"] = H.profile(
            lambda: serve_batches(svc, upl, batches(pool, p["profile_units"]), depth),
            p["profile_units"])
        reading["replay_ms"] = H.cuda_ms(served.captured.graph.replay, p["replay_timing"])
    out["reading"], out["trace"] = reading, reading.get("trace")
    out["device"] = H.device_info(dev, 1) if dev.type == "cuda" else {"platform": "cpu"}
    del served, up, eng, pool, svc, upl
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["checks"] = {"logit_err": check(r, w, images, sink.kept, B)}
    return out


def check(r, w: dict, images: torch.Tensor, kept: dict, B: int) -> float:
    """The widest per-image relative gap of the sampled batches' logits."""
    p = r.params
    idx = H.check_sample(kept, r.seed, p["check_max"])
    if not idx:
        return float("nan")
    ref = r.reference()
    pw = {k: v.float() for k, v in w.items()}
    want = {}
    worst = 0.0
    with RC.float32_exact(), torch.no_grad():
        for i in idx:
            j = i % p["pool"]
            if j not in want:
                x = RC.preprocess(images[j * B:(j + 1) * B])
                want[j] = ref.forward(pw, x, r.cfg).float()
            got = kept[i].float().reshape(want[j].shape)
            gap = (got - want[j]).norm(dim=1) / want[j].norm(dim=1)
            worst = max(worst, float(gap.max()))
    return worst


def control(r, quant: str = "fp8") -> dict:
    """The control: the reference in the program's place, computed with
    ``quant``, on the run's weights and the pool's first ``check_max``
    batches, by the same number."""
    p = r.params
    B = p["batch"]
    ref = r.reference()
    pw = {k: v.float() for k, v in H.seeded_params(ref.spec(r.cfg), r.seed, r.dev,
                                                    torch.bfloat16).items()}
    images = H.seeded_images(r.seed, "images", (p["pool"] * B, r.size, r.size, 4), r.dev)
    worst = 0.0
    with RC.float32_exact(), torch.no_grad():
        for j in range(min(p["pool"], p["check_max"])):
            x = RC.preprocess(images[j * B:(j + 1) * B])
            want = ref.forward(pw, x, r.cfg)
            got = ref.forward(pw, x, r.cfg, quant=quant)
            worst = max(worst, float(((got - want).norm(dim=1) / want.norm(dim=1)).max()))
    return {"logit_err": worst}
