"""Training steps (kind ``train``): the program's SGD step
(boda_tpu_torch/parallel/train.py ``make_train_step``) with momentum,
decoupled weight decay, train-mode BatchNorm and float32 master weights
under ``compute_dtype`` bfloat16, captured once as one CUDA graph
(``cuda_graph=True``) and replayed, its weights and momenta donated. A pool
of ``pool`` batches (images minus the mean, and labels) is made from the
seed on the device; each step's batch is copied into the step's static
inputs by the step's own call. At most ``in_flight`` steps are queued.

Set-up builds the step once, and drives it through its first
``checked_steps`` steps on distinct batches by the window's own call: the
first captures the graph. The window then goes on with the same object.

Check, against the reference's float32 steps from the same weights on the
same batches, each leaf's number over the larger of the reference's norm of
that leaf and of the median leaf (of its kind):

* ``stat_diff``: BatchNorm's running statistics after the first step (the
  batch's mean and variance, folded in by ``bn_momentum``): the median
  leaf's norm of the difference between the program's change and the
  reference's, means and variances each over their own median. It reads
  the forward pass alone, and a difference keeps each element's rounding:
  a step computed in float8 fails it.
* ``grad_gap``: the worst filter leaf's gap between the norms of the first
  step's gradient (the program's momentum after one step) and the
  reference's; ``change_gap``, the same of the weights' change over the
  checked steps; ``vec_change_gap``, the median of that gap over the other
  trainable leaves (BatchNorm's scale and shift, the fc bias). A step that
  leaves its state unchanged or steps on half the batch fails these.

Leaves whose reference gradient is under a thousandth of the median leaf's
(a conv bias before train-mode BatchNorm) are left out. The gradients are
not compared by their difference: through the backward pass the rounding of
bfloat16 as well as of float8 turns a deep filter's first gradient nearly
orthogonal to the float32 one, while the gap of their norms stays small.
The worst statistic (``stat_diff_worst``, the last stage's variances) and
the worst scale or shift vector are not held by their worst leaf: they read
as high in the reference computed in bfloat16 as in the program, on every
seed. The losses' gaps (``loss1_gap``, ``loss_gap``), the worst statistic
and the worst leaf of all (``*_all``) are reported beside them, not
compared.

Faults: ``unchanged``, a step that returns its state unchanged; ``half``,
a step on half of the batch, its mean over the rest.
"""

from __future__ import annotations

import statistics
import time
from collections import deque

import torch

from portbench import harness as H
from portbench.reference import common as RC


OPT = ("lr", "momentum", "weight_decay", "bn_momentum")


def stat(name: str) -> bool:
    """Whether a leaf is one of BatchNorm's running statistics."""
    return name.endswith(("__means", "__vars"))


def faulty(step, fault):
    """The step with one of the faults planted under its call."""
    if fault is None:
        return step
    if fault == "unchanged":
        def f(w, inputs, labels, m):
            keep_w = {k: v.clone() for k, v in w.items()}
            keep_m = None if m is None else {k: v.clone() for k, v in m.items()}
            loss, _, m2 = step(w, inputs, labels, m)
            return loss, keep_w, keep_m if keep_m is not None else \
                {k: torch.zeros_like(v) for k, v in m2.items()}
        return f
    if fault == "half":
        def f(w, inputs, labels, m):
            h = labels.shape[0] // 2
            return step(w, {k: v[:h] for k, v in inputs.items()}, labels[:h], m)
        return f
    raise H.BenchError(f"train: no fault {fault!r}")


def run(r) -> dict:
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.parallel.train import find_logits_node, make_train_step
    p, dev, cfg = r.params, r.dev, r.cfg
    B = p["batch"]
    cuda = dev.type == "cuda"
    ref = r.reference()
    pipe, _ = build_model(cfg["model"], img=B, in_sz=r.size)
    spec = ref.spec(cfg)
    if {k: tuple(w.dims.shape) for k, w in pipe.weights.items()} != \
            {k: tuple(s) for k, s, _ in spec}:
        raise H.BenchError("the reference's parameters differ from the zoo's net")
    w0 = H.seeded_params(spec, r.seed, dev, torch.float32)
    g = H.generator(r.seed, "labels", dev)
    ys = torch.randint(0, cfg["num_classes"], (p["pool"], B), generator=g, device=dev)
    u8 = H.seeded_images(r.seed, "images", (p["pool"] * B, r.size, r.size, 4), dev)
    xs = RC.preprocess(u8).to(torch.bfloat16).reshape(p["pool"], B, 3, r.size, r.size)
    del u8
    step = make_train_step(pipe, find_logits_node(pipe), lr=p["lr"], momentum=p["momentum"],
                           weight_decay=p["weight_decay"], bn_momentum=p["bn_momentum"],
                           compute_dtype=torch.bfloat16, kernel_policy="gen",
                           cuda_graph=True)
    call = faulty(step, r.fault)

    # the checked steps: the same object and call as the window's
    losses, w, m = [], w0, None
    for i in range(p["checked_steps"]):
        loss, w, m = call(w, {"data": xs[i]}, ys[i], m)
        losses.append(float(loss))
        if i == 0:
            g1 = {k: v.float().cpu() for k, v in m.items()}
            s1 = {k: (w[k].float() - w0[k]).cpu() for k in w0 if stat(k)}
    change = {k: (w[k].float() - w0[k]).cpu() for k in g1}
    w0_host = {k: v.cpu() for k, v in w0.items()}
    del w0

    fl: deque = deque()
    i = p["checked_steps"]
    t0 = time.perf_counter()
    end = t0 + r.seconds
    while time.perf_counter() < end:
        with r.spans.span("pb.step"):
            loss, w, m = call(w, {"data": xs[i % p["pool"]]}, ys[i % p["pool"]], m)
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            fl.append(ev)
            with r.spans.span("pb.wait"):
                while len(fl) > p["in_flight"]:
                    fl.popleft().synchronize()
        i += 1
    with r.spans.span("pb.wait"):
        while fl:
            fl.popleft().synchronize()
    steps = i - p["checked_steps"]
    secs = time.perf_counter() - t0
    out = {"e2e": {"train_img_per_s": steps * B / secs, "setup_s": t0 - r.t_start},
           "attempted": steps, "failed": 0}

    reading = {"kind": "train", "training": True, "images_per_unit": B,
               "rate_img_s": steps * B / secs, "spans": r.spans,
               "layers": ref.layers(cfg, B, r.size)}
    if r.trace and cuda:
        k = p["profile_units"]

        def some():
            nonlocal w, m
            for j in range(k):
                with r.spans.span("pb.step"):
                    _, w, m = call(w, {"data": xs[j % p["pool"]]}, ys[j % p["pool"]], m)
        reading["trace"] = H.profile(some, k)
        reading["step_ms"] = H.cuda_ms(step.captured.graph.replay, p["replay_timing"])
    out["reading"], out["trace"] = reading, reading.get("trace")
    out["device"] = H.device_info(dev, 1) if cuda else {"platform": "cpu"}
    step.release()
    del step, call, w, m
    if cuda:
        torch.cuda.empty_cache()
    n = p["checked_steps"]
    out["checks"] = check(r, w0_host, [(xs[j].float(), ys[j]) for j in range(n)],
                          losses, g1, s1, change)
    return out


def check(r, w0: dict, batches: list, losses: list, g1: dict, s1: dict,
          change: dict) -> dict:
    ref = r.reference()
    opt = {k: r.params[k] for k in OPT}
    w0 = {k: v.to(r.dev) for k, v in w0.items()}
    with RC.float32_exact():
        res = ref.train_steps(w0, batches, r.cfg, opt)
    return compare(res, w0, losses, *({k: v.to(r.dev) for k, v in d.items()}
                                      for d in (g1, s1, change)))


def compare(res: dict, w0: dict, losses: list, g1: dict, s1: dict, change: dict,
            worst: dict | None = None) -> dict:
    """The compared numbers of the program's losses, first gradient ``g1``,
    running statistics' first change ``s1`` and weights' change ``change``
    (tensors by leaf) against the reference's steps ``res`` from ``w0``.
    ``worst``, where given, gets the leaf that each worst-of-all number
    names."""
    g_ref = res["grad1"]
    c_ref = {k: res["weights"][k] - w0[k] for k in g_ref}
    s_ref = {k: v - w0[k] for k, v in res["stats1"].items()}
    gn = {k: float(v.norm()) for k, v in g_ref.items()}
    cn = {k: float(v.norm()) for k, v in c_ref.items()}
    sn = {k: float(v.norm()) for k, v in s_ref.items()}
    med = statistics.median(gn.values())
    keep = [k for k in gn if gn[k] >= 1e-3 * med]
    filts = [k for k in keep if k.endswith("__filts")]
    vecs = [k for k in keep if not k.endswith("__filts")]

    def rel(num: dict, den: dict, ks: list) -> dict:
        md = statistics.median(den[k] for k in ks)
        return {k: num[k] / max(den[k], md) for k in ks}

    gg = rel({k: abs(float(g1[k].norm()) - gn[k]) for k in keep}, gn, keep)
    cg = rel({k: abs(float(change[k].norm()) - cn[k]) for k in keep}, cn, keep)
    sd = {}
    for kind in ("__means", "__vars"):
        ks = [k for k in sn if k.endswith(kind)]
        sd.update(rel({k: float((s1[k] - s_ref[k]).norm()) for k in ks}, sn, ks))
    loss = [abs(a - b) / abs(b) for a, b in zip(losses, res["losses"])]
    if worst is not None:
        worst.update(grad_gap_all=max(gg, key=gg.get), change_gap_all=max(cg, key=cg.get),
                     stat_diff_worst=max(sd, key=sd.get))
    return {"loss1_gap": loss[0], "loss_gap": max(loss),
            "grad_gap": max(gg[k] for k in filts), "change_gap": max(cg[k] for k in filts),
            "vec_change_gap": statistics.median(cg[k] for k in vecs),
            "stat_diff": statistics.median(sd.values()), "stat_diff_worst": max(sd.values()),
            "grad_gap_all": max(gg.values()), "change_gap_all": max(cg.values())}


def control(r, quant: str = "fp8") -> dict:
    """The control: the reference in the program's place, computed with
    ``quant``, on the run's weights and checked batches, by the same numbers;
    beside them the leaf that each worst-of-all number names."""
    p, dev, cfg = r.params, r.dev, r.cfg
    B, n = p["batch"], p["checked_steps"]
    ref = r.reference()
    w0 = H.seeded_params(ref.spec(cfg), r.seed, dev, torch.float32)
    g = H.generator(r.seed, "labels", dev)
    ys = torch.randint(0, cfg["num_classes"], (p["pool"], B), generator=g, device=dev)
    u8 = H.seeded_images(r.seed, "images", (p["pool"] * B, r.size, r.size, 4), dev)
    xs = RC.preprocess(u8).to(torch.bfloat16).reshape(p["pool"], B, 3, r.size, r.size)
    batches = [(xs[j].float(), ys[j]) for j in range(n)]
    opt = {k: p[k] for k in OPT}
    with RC.float32_exact():
        want = ref.train_steps(w0, batches, cfg, opt)
        got = ref.train_steps(w0, batches, cfg, opt, quant=quant)
    worst: dict = {}
    out = compare(want, w0, got["losses"], got["grad1"],
                  {k: v - w0[k] for k, v in got["stats1"].items()},
                  {k: got["weights"][k] - w0[k] for k in got["grad1"]}, worst)
    return {**out, **{f"{k}_leaf": v for k, v in worst.items()}}
