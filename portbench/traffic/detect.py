"""Detection requests in a closed loop (kind ``detect``): one caller that
waits for each reply, one request in flight (zmq_det's request-reply shape,
without the socket). A request is ``batch`` uint8 RGBA images; its clock
runs from the upload (``Uploader``), through the served graph of the
program's ``ServedNet`` (preprocess, trunk and the DetectionOutput head as
one CUDA graph), to the detections copied into pinned host memory. A pool
of ``pool`` distinct requests is made from the seed and cycled.

Check, on a sample of the window's requests (about one in ``sample_every``,
drawn from the seed, at most ``check_max``), each image's:

* ``det_unmatched``: the window's ``detection_out`` against the reference's
  DetectionOutput of the program's own head inputs: the share of
  detections (of both sides) that find no partner of the same label within
  bfloat16's rounding in score and box;
* ``loc_err``, ``conf_err``: those head inputs (``mbox_loc``, the class
  logits ``mbox_conf``) against the reference's float32 trunk on the same
  images and weights, ||program - reference|| / ||reference||;
* ``softmax_err``: the program's class softmax (``mbox_conf_flatten``)
  against the reference's softmax of the program's own logits, the widest
  absolute gap.

The widest of each over the images checked. The head and the softmax are
checked from the program's own inputs, stage by stage: a bf16 trunk flips
near-tied scores, after which no two NMS runs compare. The window's graph
hands out only its detections, so once it has closed the program's
``ServedNet`` is captured again, on the same engine at the same batch, up
to each head input, and replayed on the sampled requests' images.

Fault ``answer``: one sampled request's detections altered on the host
where the caller receives them (image 0's boxes moved).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench import harness as H
from portbench import program as P
from portbench.reference import common as RC

HEAD_INPUTS = ["mbox_loc", "mbox_conf_flatten", "mbox_priorbox"]
CHECKED = ["mbox_loc", "mbox_conf", "mbox_conf_flatten"]


def run(r) -> dict:
    from boda_tpu_torch.modes.serve_bench import Uploader
    p, dev = r.params, r.dev
    B = p["batch"]
    cuda = dev.type == "cuda"
    pipe, d, w = P.net_with_weights(r, B, torch.bfloat16)
    eng = r.engine()
    eng.init(pipe)
    served = P.served(eng, ["detection_out"], B, d["y"], d["x"])
    images = H.seeded_images(r.seed, "images", (p["pool"] * B, d["y"], d["x"], 4), dev)
    pool = P.pinned_pool(images, p["pool"], B, dev)
    up = Uploader((B, d["y"], d["x"], 4), dev, 2)
    det_shape = tuple(pipe.must_dims("detection_out").shape)
    det_host = torch.empty(det_shape, dtype=torch.bfloat16, pin_memory=cuda)
    done = torch.cuda.Event() if cuda else None
    alter_at = None
    if r.fault == "answer":
        alter_at = next(i for i in range(1 << 20) if H.sampled(r.seed, i, p["sample_every"]))
    elif r.fault is not None:
        raise H.BenchError(f"detect: no fault {r.fault!r}")
    sp = r.spans

    def request(i):
        with sp.span("pb.upload"):
            u8, ev = up.upload(i, pool[i % len(pool)])
        with sp.span("pb.replay"):
            out = served.run(u8, ev)
            up.release(i)
        with sp.span("pb.d2h"):
            det_host.copy_(out, non_blocking=cuda)
            if cuda:
                done.record()
        with sp.span("pb.wait"):
            if cuda:
                done.synchronize()

    for i in range(p["warm_requests"]):
        request(i)
    lat, kept = [], {}
    t0 = time.perf_counter()
    end, i = t0 + r.seconds, 0
    while time.perf_counter() < end:
        ts = time.perf_counter()
        request(i)
        lat.append(time.perf_counter() - ts)
        if H.sampled(r.seed, i, p["sample_every"]):
            det = det_host.clone()
            if i == alter_at:
                det.view(B, -1, 7)[0, :, 3:] += 0.25
            kept[i] = det
        i += 1
    secs = time.perf_counter() - t0
    out = {"e2e": {"request_ms_p95": H.p95(lat) * 1e3, "request_per_s": i / secs,
                   "setup_s": t0 - r.t_start},
           "attempted": i, "failed": 0}

    reading = {"kind": "detect", "training": False, "images_per_unit": B,
               "rate_img_s": i * B / secs, "spans": sp,
               "layers": r.reference().layers(r.cfg, B, r.size)}
    if r.trace and cuda:
        k = p["profile_units"]
        reading["trace"] = H.profile(lambda: [request(j) for j in range(k)], k)
        reading["replay_ms"] = H.cuda_ms(served.captured.graph.replay, p["replay_timing"])
        trunk = P.served(eng, HEAD_INPUTS, B, d["y"], d["x"])
        g = trunk.captured.graph
        reading["trunk_ms"] = H.cuda_ms(g.replay, p["replay_timing"])
        reading["conv_trace"] = H.profile(lambda: [g.replay() for _ in range(k)], k)
        del trunk, g
    out["reading"], out["trace"] = reading, reading.get("trace")
    out["device"] = H.device_info(dev, 1) if cuda else {"platform": "cpu"}
    del served, up, pool
    if cuda:
        torch.cuda.empty_cache()
    idx = H.check_sample(kept, r.seed, p["check_max"])
    heads = head_inputs(eng, images, sorted({j % p["pool"] for j in idx}), B, d)
    del eng
    if cuda:
        torch.cuda.empty_cache()
    out["checks"] = check(r, w, images, {j: kept[j] for j in idx}, heads, B)
    return out


def head_inputs(eng, images: torch.Tensor, batches: list, B: int, d) -> dict:
    """{pool batch: {node: output}} of the program's ``ServedNet`` captured up
    to each checked head input, replayed on each of ``batches``."""
    out = {j: {} for j in batches}
    for name in CHECKED:
        net = P.served(eng, [name], B, d["y"], d["x"])
        for j in batches:
            out[j][name] = net.run(images[j * B:(j + 1) * B]).clone()
        del net
    return out


def matched_share(got: np.ndarray, want: np.ndarray) -> float:
    """Share of the valid detections of two (rows, 7) tables, both sides
    counted, that find no partner: the same label, and score and box within
    bfloat16's rounding (2**-7 of the reference's value)."""
    g, w = got[got[:, 1] >= 0], want[want[:, 1] >= 0]
    total = len(g) + len(w)
    if total == 0:
        return 0.0
    tol = 2.0 ** -7 * np.abs(w[:, 2:]) + 1e-6
    close = (w[:, None, 1] == g[None, :, 1]) & \
        np.all(np.abs(w[:, None, 2:] - g[None, :, 2:]) <= tol[:, None, :], axis=2)
    free = np.ones(len(g), bool)
    pairs = 0
    for row in close:
        hit = np.flatnonzero(row & free)
        if len(hit):
            free[hit[0]] = False
            pairs += 1
    return (total - 2 * pairs) / total


def check(r, w: dict, images: torch.Tensor, kept: dict, heads: dict, B: int) -> dict:
    """The compared numbers of the window's detections ``kept`` (by
    request) and the program's head inputs ``heads`` (by pool batch)."""
    p, cfg = r.params, r.cfg
    nan = float("nan")
    if not kept:
        return dict.fromkeys(("loc_err", "conf_err", "softmax_err", "det_unmatched"), nan)
    ref = r.reference()
    pri = ref.priors(cfg, r.size)
    pw = {k: v.float() for k, v in w.items()}
    n_cls = cfg["num_classes"]
    worst = dict.fromkeys(("loc_err", "conf_err", "softmax_err", "det_unmatched"), 0.0)
    want = {}

    def rel(a, b):
        return float(((a.float() - b).norm(dim=1) / b.norm(dim=1)).max())

    with RC.float32_exact(), torch.no_grad():
        for i in sorted(kept):
            j = i % p["pool"]
            if j not in want:
                want[j] = ref.trunk(pw, RC.preprocess(images[j * B:(j + 1) * B]), cfg)
            k, t = heads[j], want[j]
            worst["loc_err"] = max(worst["loc_err"], rel(k["mbox_loc"].reshape(B, -1), t["loc"]))
            worst["conf_err"] = max(worst["conf_err"],
                                    rel(k["mbox_conf"].reshape(B, -1), t["conf_logits"]))
            lg = k["mbox_conf"].float().reshape(B, -1, n_cls)
            sm = torch.softmax(lg, dim=2).reshape(B, -1)
            worst["softmax_err"] = max(worst["softmax_err"], float(
                (k["mbox_conf_flatten"].float().reshape(B, -1) - sm).abs().max()))
            dets = ref.detection_out(k["mbox_loc"].reshape(B, -1),
                                     k["mbox_conf_flatten"].reshape(B, -1), pri, cfg)
            got = kept[i].float().reshape(B, -1, 7).numpy()
            for img in range(B):
                worst["det_unmatched"] = max(worst["det_unmatched"],
                                             matched_share(got[img], dets[img]))
    return worst


def control(r, quant: str = "fp8") -> dict:
    """The control, on the run's weights and the pool's first ``check_max``
    requests, by the same numbers: the reference's trunk computed with
    ``quant`` in the program's place; its softmax, and the head's
    detections (from the bf16 head inputs the program would be given), each
    rounded to float8 (e4m3) where the program rounds to bf16."""
    p, cfg = r.params, r.cfg
    B = p["batch"]
    ref = r.reference()
    pri = ref.priors(cfg, r.size)
    pw = {k: v.float() for k, v in H.seeded_params(ref.spec(cfg), r.seed, r.dev,
                                                    torch.bfloat16).items()}
    images = H.seeded_images(r.seed, "images", (p["pool"] * B, r.size, r.size, 4), r.dev)
    worst = dict.fromkeys(("loc_err", "conf_err", "softmax_err", "det_unmatched"), 0.0)

    def rel(a, b):
        return float(((a - b).norm(dim=1) / b.norm(dim=1)).max())

    def f8(t):
        return t.to(torch.float8_e4m3fn).float()

    with RC.float32_exact(), torch.no_grad():
        for j in range(min(p["pool"], p["check_max"])):
            x = RC.preprocess(images[j * B:(j + 1) * B])
            want, got = ref.trunk(pw, x, cfg), ref.trunk(pw, x, cfg, quant=quant)
            worst["loc_err"] = max(worst["loc_err"], rel(got["loc"], want["loc"]))
            worst["conf_err"] = max(worst["conf_err"],
                                    rel(got["conf_logits"], want["conf_logits"]))
            worst["softmax_err"] = max(worst["softmax_err"],
                                       float((f8(want["conf"]) - want["conf"]).abs().max()))
            dets = ref.detection_out(want["loc"].to(torch.bfloat16),
                                     want["conf"].to(torch.bfloat16), pri, cfg)
            rounded = dets.copy()
            rounded[..., 2:] = f8(torch.from_numpy(dets[..., 2:])).numpy()
            for img in range(B):
                worst["det_unmatched"] = max(worst["det_unmatched"],
                                             matched_share(rounded[img], dets[img]))
    return worst
