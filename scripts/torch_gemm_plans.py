#!/usr/bin/env python3
"""Every wgmma tile plan of the GEMM core (csrc/gemm.cuh) at the ResNet-50
b32 bf16 forward's GEMM and conv signatures, and at its gradient graph's
weight-gradient signatures (K5, csrc/atb.cu on the same core), timed on one
card: the data behind ops/kernels/common.py:plan_gemm and
ops/kernels/bconv.py:plan_atb.

For each signature (from the engine's own dispatch, as chip_smoke.py takes
them) it launches the C entry points directly with each plan: 64 or 128
rows, 64, 128 or 256 columns, and every split of the 64-deep K chunks up to
16 that divides them (and the planner's). Each plan's device time is that of 20 calls in one
CUDA graph (rtc/backends.py's graph_time), and its output is checked against the
planner's own plan (within 1e-2 of max|ref|: one bf16 rounding). K5's
plans: the same tiles, and K splits from 1 to 256 (plan_atb's range, on a
geometric grid, and the planner's), each split's chunk the longest split's.
Prints the card's name and power limit, then per signature the planner's
plan and time, the fastest plan and time, and the five fastest (K5: and
whether the planner is more than 10% off the fastest); last, one JSON object
with the per-forward (per-gradient-pass for K5) sums of both.

    python3 scripts/torch_gemm_plans.py [--only fwd|atb]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("fwd", "atb"), default=None,
                    help="sweep only the forward's GEMM/conv plans or only K5's")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_plans: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph.autodiff import add_bck_ops
    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.bconv import atb_workspace, plan_atb
    from boda_tpu_torch.ops.kernels.common import (PATH_CODES, WGMMA_CHUNK, GemmPlan, cdiv,
                                                   plan_gemm, sm_count)
    from boda_tpu_torch.rtc.backends import graph_time

    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    sms = sm_count(dev)
    pipe, _ = load_net("resnet50", img=cs.BATCH)
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
                                     K, N, torch.cuda.current_stream().cuda_stream)
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
                                       oc, torch.cuda.current_stream().cuda_stream)
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
    for kind, shapes in (() if args.only == "atb" else (("sgemm", gemm), ("conv", conv))):
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
                        times.append((graph_time(lambda: fn(plan)) * 1e6, bm, bn, split))
            times.sort()
            t_mine = next(t for t, bm, bn, sp in times
                          if (bm, bn, sp) == (mine.bm, mine.bn, mine.split))
            tot["planner"] += t_mine * count
            tot["best"] += times[0][0] * count
            print(f"[plans] {kind} {sig} x{count}: {mine.bm}x{mine.bn}/{mine.split} "
                  f"{t_mine:.1f} | {times[0][1]}x{times[0][2]}/{times[0][3]} {times[0][0]:.1f} | "
                  + ", ".join(f"{bm}x{bn}/{sp} {t:.1f}" for t, bm, bn, sp in times[:5]))
    # -- K5: the weight gradients of the b32 gradient graph ------------------------
    atb_tot = {"planner": 0.0, "best": 0.0}
    off = []
    if args.only != "fwd":
        bpipe, _ = load_net("resnet50", img=cs.BATCH)
        add_bck_ops(bpipe)
        beng = make("conv_fwd", "cuda", compute_tn="bfloat16")
        beng.init(bpipe)
        wgrads = cs.bck_shapes(bpipe, beng)
        del beng
        grid = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 14, 16, 20, 24, 28, 32, 40, 48, 56, 64, 80,
                96, 112, 128, 160, 192, 224, 256)
        print(f"[plans-atb] sig (n, h, c, oc, k, p) x count: planner tile/split us | best "
              f"tile/split us | 5 fastest ({card})")
        for sig, count in wgrads.items():
            n, h, c, oc, k, p = sig
            oh = h + 2 * p - k + 1
            x, dy = rnd((n, h, h, c)), rnd((n, oh, oh, oc))
            M, N, K, taps = c, oc, n * oh * oh, k * k
            # a 1x1 takes the dense form (x as it lies), as conv2d_bck_filts does
            gather = k > 1
            geom = (h, h, oh, oh, k, k, p, p) if gather else (0, 0, 0, 0, 1, 1, 0, 0)
            mine = plan_atb(M, N, K, taps, sms, bf, True, gather)
            chunks = cdiv(K, WGMMA_CHUNK)

            def fn(bm, bn, split, per):
                plan = mine._replace(bm=bm, bn=bn, split=split, chunk=per * WGMMA_CHUNK)
                out = torch.empty((k, k, M, N), dtype=torch.float32, device=dev)
                ws = atb_workspace(plan, taps, M, N, dev)
                build.check(lib.boda_atb(x.data_ptr(), dy.data_ptr(), out.data_ptr(),
                                         None if ws is None else ws.data_ptr(), M, N, K,
                                         split, per * WGMMA_CHUNK, int(gather), *geom, 1,
                                         PATH_CODES["wgmma"], bm, bn, N,
                                         torch.cuda.current_stream().cuda_stream),
                            f"atb {sig} {plan}")
                return out
            ref = fn(mine.bm, mine.bn, mine.split, mine.chunk // WGMMA_CHUNK)
            splits = {cdiv(chunks, cdiv(chunks, s)) for s in grid if s <= chunks} | {mine.split}
            times = []
            for bm in (64, 128):
                for bn in (64, 128, 256):
                    if bn > max(64, cdiv(N, 64) * 64):
                        continue
                    for split in sorted(splits):
                        per = cdiv(chunks, split)
                        out = fn(bm, bn, split, per)
                        err = float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
                        if err > 1e-2:
                            raise RuntimeError(f"atb {sig} {bm}x{bn}/{split}: {err:.3g} from "
                                               "the planner's")
                        times.append((graph_time(lambda: fn(bm, bn, split, per)) * 1e6, bm, bn,
                                      split))
            times.sort()
            t_mine = next(t for t, bm, bn, sp in times
                          if (bm, bn, sp) == (mine.bm, mine.bn, mine.split))
            atb_tot["planner"] += t_mine * count
            atb_tot["best"] += times[0][0] * count
            if t_mine > 1.1 * times[0][0]:
                off.append(sig)
            print(f"[plans-atb] {sig} x{count}: {mine.bm}x{mine.bn}/{mine.split} {t_mine:.1f} | "
                  f"{times[0][1]}x{times[0][2]}/{times[0][3]} {times[0][0]:.1f}"
                  f"{' (planner >10% off)' if t_mine > 1.1 * times[0][0] else ''} | "
                  + ", ".join(f"{bm}x{bn}/{sp} {t:.1f}" for t, bm, bn, sp in times[:5]))
            del x, dy, ref
    print(json.dumps({"card": card, "sms": sms, "per_forward_us": tot,
                      "atb_per_grad_pass_us": atb_tot, "atb_planner_off_10pct": off}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
