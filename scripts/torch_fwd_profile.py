#!/usr/bin/env python3
"""Where a forward's time goes on the card: boda_tpu_torch's ResNet-50
forward under torch.profiler, per engine configuration.

For each configuration (gen: the hand kernels; lib: cuDNN/cuBLAS; fused:
fuse_block=1, tune=(use_s2d=1,pool_pallas=1)) it warms up, then profiles
`--iters` eager forwards (the engine's net function launch by launch, as
under cuda_graph=0) and prints, per forward: wall ms (host clock around the
window, ended by a synchronize), device busy ms (the union of kernel
intervals), the busy share, the kernel count, and the device ms by kernel
group. One JSON line per configuration; the card's name and power limit
first.

    python3 scripts/torch_fwd_profile.py [--batch 32] [--iters 10] [--configs gen,lib,fused]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boda_tpu_torch.config import make  # noqa: E402
from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net  # noqa: E402
from boda_tpu_torch.utils.lexp import parse_lexp  # noqa: E402

CONFIGS = {
    "gen": {},
    "lib": {"kernel_policy": "lib"},
    "fused": {"fuse_block": True, "tune": "(use_s2d=1,pool_pallas=1)"},
}
# kernel name substring -> group, first match wins: the hand kernels by
# their C++ names (csrc/), then the library's
GROUPS = [("bottleneck_kernel", "block (hand)"), ("pool_kernel", "pool (hand)"),
          ("boda::gemm", "sgemm/conv (hand)"), ("atb", "atb (hand)"),
          ("xmma", "conv/gemm (library)"), ("cutlass", "conv/gemm (library)"),
          ("conv", "conv/gemm (library)"), ("gemm", "conv/gemm (library)"),
          ("pool", "pool (library)"), ("elementwise", "elementwise"),
          ("copy", "copy/layout"), ("nchw", "copy/layout"), ("nhwc", "copy/layout"),
          ("reduce", "reduce")]


def group(name: str) -> str:
    low = name.lower()
    return next((g for key, g in GROUPS if key in low), "other")


def profile(eng, ins, iters: int) -> dict:
    from torch.profiler import ProfilerActivity, profile as tprofile
    eng.time_fwd(ins, ["prob"], n_iters=3, warmup=3)  # builds, warms
    with eng._run_ctx():
        dev_ins = eng._put_inputs(ins)
        torch.cuda.synchronize()
        with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                eng._fn(eng._weights_dev, dev_ins)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    spans, by_group = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t_start = ev.time_range.start
        t_end = ev.time_range.end
        spans.append((t_start, t_end))
        by_group[group(ev.name)] = by_group.get(group(ev.name), 0.0) + (t_end - t_start)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    n = iters
    return {"wall_ms": wall * 1e3 / n, "device_busy_ms": busy / 1e3 / n,
            "busy_share": busy / 1e6 / wall if wall else 0.0,
            "kernels_per_fwd": len(spans) / n,
            "device_ms_by_group": {k: v / 1e3 / n for k, v in
                                   sorted(by_group.items(), key=lambda kv: -kv[1])}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--configs", default="gen,lib,fused")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fwd_profile: no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    pipe, in_dims = load_net("resnet50", a.batch)
    ins = gen_data_inputs(in_dims)
    for name in a.configs.split(","):
        kw = dict(CONFIGS[name])
        if "tune" in kw:
            kw["tune"] = parse_lexp(kw["tune"])
        eng = make("conv_fwd", "cuda", compute_tn="bfloat16", **kw)
        eng.init(pipe)
        r = profile(eng, ins, a.iters)
        print(json.dumps({"config": name, "batch": a.batch, **r,
                          "device": torch.cuda.get_device_name(0)}))
        del eng
    return 0


if __name__ == "__main__":
    sys.exit(main())
