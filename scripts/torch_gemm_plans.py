#!/usr/bin/env python3
"""Every wgmma tile plan of the GEMM core (csrc/gemm.cuh) at the ResNet-50
b32 bf16 forward's GEMM and conv signatures, timed on one card: the data
behind ops/kernels/common.py:plan_gemm.

For each signature (from the engine's own dispatch, as chip_smoke.py takes
them) it launches the C entry points directly with each plan: 64 or 128
rows, 64, 128 or 256 columns, and every split of the 64-deep K chunks up to
16 that divides them (and the planner's). Each plan's device time is that of 20 calls in one
CUDA graph (chip_smoke.py's graph_ms), and its output is checked against the
planner's own plan (within 1e-2 of max|ref|: one bf16 rounding).
Prints the card's name and power limit, then per signature the planner's
plan and time, the fastest plan and time, and the five fastest; last, one
JSON object with the per-forward sums of both.

    python3 scripts/torch_gemm_plans.py
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_plans: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.config import make
    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import (PATH_CODES, WGMMA_CHUNK, GemmPlan, cdiv,
                                                   plan_gemm, sm_count)

    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    sms = sm_count(dev)
    pipe, _ = load_net("resnet50", cs.BATCH)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    gemm, conv = cs.layer_shapes(pipe, eng)
    lib = build.load().lib
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def launcher(kind, sig):
        """fn(plan) -> output of one launch of that plan on fixed inputs."""
        if kind == "sgemm":
            M, K, N, res, relu = sig
            a, b, bias = rnd((M, K)), rnd((K, N), K ** -0.5), rnd((N,), 0.1)
            r = rnd((M, N)) if res else None
            dims, conv_c = (M, N, K), None

            def call(plan, out, ws):
                return lib.boda_gemm(a.data_ptr(), b.data_ptr(), bias.data_ptr(),
                                     None if r is None else r.data_ptr(), out.data_ptr(),
                                     None if ws is None else ws.data_ptr(), M, N, K, int(relu),
                                     1, PATH_CODES[plan.path], plan.bm, plan.bn, plan.split,
                                     torch.cuda.current_stream().cuda_stream)
        else:
            n, h, c, oc, k, s, p, res, relu = sig
            oh = (h + 2 * p - k) // s + 1
            x, w = rnd((n, h, h, c)), rnd((k, k, c, oc), (k * k * c) ** -0.5)
            bias = rnd((oc,), 0.1)
            r = rnd((n, oh, oh, oc)) if res else None
            dims, conv_c = (n * oh * oh, oc, k * k * c), c

            def call(plan, out, ws):
                return lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                       None if r is None else r.data_ptr(), out.data_ptr(),
                                       None if ws is None else ws.data_ptr(), n, h, h, c, oh,
                                       oh, oc, k, k, s, s, p, p, int(relu), 1,
                                       PATH_CODES[plan.path], plan.bm, plan.bn, plan.split,
                                       torch.cuda.current_stream().cuda_stream)
        M, N, K = dims

        def fn(plan):
            out = torch.empty((M, N), dtype=bf, device=dev)
            ws = (torch.empty((plan.split * M * N,), dtype=torch.float32, device=dev)
                  if plan.split > 1 else None)
            build.check(call(plan, out, ws), f"{kind} {sig} {plan}")
            return out
        return fn, dims, conv_c

    tot = {"planner": 0.0, "best": 0.0}
    print(f"[plans] kind sig x count: planner plan us | best plan us | 5 fastest ({card})")
    for kind, shapes in (("sgemm", gemm), ("conv", conv)):
        for sig, count in shapes.items():
            fn, (M, N, K), conv_c = launcher(kind, sig)
            mine = plan_gemm(M, N, K, sms, bf, conv_c=conv_c)
            if mine.path != "wgmma":
                continue
            ref = fn(mine).float()
            chunks = cdiv(K, WGMMA_CHUNK)
            times = []
            for bm in (64, 128):
                for bn in (64, 128, 256):
                    for split in sorted({d for d in range(1, min(16, chunks) + 1)
                                         if chunks % d == 0} | {mine.split}):
                        plan = GemmPlan("wgmma", bm, bn, split, 0)
                        out = fn(plan).float()
                        err = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                        if err > 1e-2:
                            raise RuntimeError(f"{kind} {sig} {plan}: {err:.3g} from the planner's")
                        times.append((cs.graph_ms(lambda: fn(plan)) * 1e3, bm, bn, split))
            times.sort()
            t_mine = next(t for t, bm, bn, sp in times
                          if (bm, bn, sp) == (mine.bm, mine.bn, mine.split))
            tot["planner"] += t_mine * count
            tot["best"] += times[0][0] * count
            print(f"[plans] {kind} {sig} x{count}: {mine.bm}x{mine.bn}/{mine.split} "
                  f"{t_mine:.1f} | {times[0][1]}x{times[0][2]}/{times[0][3]} {times[0][0]:.1f} | "
                  + ", ".join(f"{bm}x{bn}/{sp} {t:.1f}" for t, bm, bn, sp in times[:5]))
    print(json.dumps({"card": card, "sms": sms, "per_forward_us": tot}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
