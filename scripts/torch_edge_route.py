#!/usr/bin/env python3
"""The GEMM core's edge route (``wgmma_edge``: csrc/gemm.cuh's wgmma ring for
N % 8 != 0 and even, B's rows padded to 16 bytes, the output stored from the
accumulators) against the mma.sync loop that such products took before it,
the library and the bound, on one card.

At each of chip_smoke.py's EDGE_SHAPES (ssd300's six mbox_conf heads at b4,
K2, no ReLU, as the engine runs them) and EDGE_GEMMS (fc1000's (tp=2) slice,
K1), on seeded bf16 operands with B in the engine's padded rows
(``pad_rows``):

* the planned edge launch, and the mma.sync loop through the same C entry
  point past the plan, each against the plain version (within 1e-2 of
  max|ref|), and the library's call (cuDNN's ``F.conv2d`` on the
  channels_last views, cuBLAS's ``torch.addmm``); each timed as 20 calls in
  one CUDA graph (``graph_time``, L2 warm), in turns: mma, edge, edge, mma
  (each time the mean of its two turns);
* every edge plan (64 or 128 rows; 64 or 128 columns as N allows; each K
  split that divides the 64-deep chunks, up to 16), beside the planner's
  choice (ops/kernels/common.py:plan_gemm).

``--replays 1``: ssd300 b4 bf16 gen, its forward captured twice: with the
heads on wgmma_edge, and on the mma.sync loop (``conv.plan_gemm`` wrapped to
give them the plan they had before), ms per replay (``time_fwd``, 20
replays, the median of 3) in turns mma, edge, edge, mma; the two forwards'
mbox_conf_softmax and detection_out against each other.

Prints the card's name and power limit first and last, and as its last line
one JSON object with every number.

    python3 scripts/torch_edge_route.py [--replays 1]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replays", type=int, default=0,
                    help="1: also time ssd300's replay with the heads on both routes")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_edge_route: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels import conv as convmod
    from boda_tpu_torch.ops.kernels.common import (PATH_CODES, WGMMA_CHUNK, GemmPlan, cdiv,
                                                   check_rows, pad_rows, plan_gemm, sm_count,
                                                   splitk_workspace)
    from boda_tpu_torch.ops.kernels.conv import conv2d_plain
    from boda_tpu_torch.ops.kernels.sgemm import matmul_plain
    from boda_tpu_torch.rtc.backends import graph_time

    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    kb = build.load()
    print(f"[build] {kb.build_secs:.1f} s")
    edge_fn = False
    for ln in kb.log.splitlines():  # ptxas on the edge kernels: registers, spills
        if "Compiling entry function" in ln or "Function properties for" in ln:
            edge_fn = "gemm_wgmma" in ln and "Lb0ELb1E" in ln  # <..., NARROW false, EDGE true>
        if edge_fn:
            print(f"[build] {ln.strip()}")
    lib = kb.lib
    sms = sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(25)

    def launcher(sig, x, w, bias):
        """fn(plan) -> one launch of that plan through the C entry point."""
        ldb = check_rows("w", w, w.device, bf, tuple(w.shape))
        if len(sig) == 7:
            n, h, c, oc, k, s, p = sig
            oh = (h + 2 * p - k) // s + 1
            M = n * oh * oh

            def fn(plan):
                out = torch.empty((n, oh, oh, oc), dtype=bf, device=dev)
                ws = splitk_workspace(plan, M, oc, dev)
                build.check(lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(), None,
                                            out.data_ptr(), None if ws is None else ws.data_ptr(),
                                            n, h, h, c, oh, oh, oc, k, k, s, s, p, p, 0, 1,
                                            PATH_CODES[plan.path], plan.bm, plan.bn, plan.split,
                                            ldb, build.stream_ptr(x)), f"conv {plan}")
                return out
            return fn
        M, K, N = sig

        def fn(plan):
            out = torch.empty((M, N), dtype=bf, device=dev)
            ws = splitk_workspace(plan, M, N, dev)
            build.check(lib.boda_gemm(x.data_ptr(), w.data_ptr(), bias.data_ptr(), None,
                                      out.data_ptr(), None if ws is None else ws.data_ptr(),
                                      M, N, K, 0, 1, PATH_CODES[plan.path], plan.bm, plan.bn,
                                      plan.split, ldb, build.stream_ptr(x)), f"gemm {plan}")
            return out
        return fn

    result = {"card": card, "sms": sms, "shapes": {}, "replays": {}}
    print(f"[shape] sig: edge plan | edge, mma.sync loop, library, bound us | errors ({card})")
    for sig, where in {**cs.EDGE_SHAPES, **cs.EDGE_GEMMS}.items():
        bias_n = sig[3] if len(sig) == 7 else sig[2]
        if len(sig) == 7:
            n, h, c, oc, k, s, p = sig
            x = torch.randn((n, h, h, c), generator=gen, device=dev).to(bf)
            dense = (torch.randn((k, k, c, oc), generator=gen, device=dev)
                     * (k * k * c) ** -0.5).to(bf)
            oh = (h + 2 * p - k) // s + 1
            M, N, K, conv_c = n * oh * oh, oc, k * k * c, c
            bias = (torch.randn((bias_n,), generator=gen, device=dev) * 0.1).to(bf)
            ref = conv2d_plain(x, dense, bias, stride=(s, s), pad=(p, p)).float()
            xn = x.permute(0, 3, 1, 2)
            wn = dense.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)

            def library():
                return F.conv2d(xn, wn, bias, stride=s, padding=p)
            b_ms, o_ms = cs.work("conv", sig + (False,))
        else:
            M, K, N = sig
            conv_c = None
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            dense = (torch.randn((K, N), generator=gen, device=dev) * K ** -0.5).to(bf)
            bias = (torch.randn((bias_n,), generator=gen, device=dev) * 0.1).to(bf)
            ref = matmul_plain(x, dense, bias).float()

            def library():
                return torch.addmm(bias, x, dense)
            b_ms, o_ms = cs.work("sgemm", (M, K, N, False, False))
        w = pad_rows(dense)
        fn = launcher(sig, x, w, bias)
        mine = plan_gemm(M, N, K, sms, bf, conv_c=conv_c)
        mma = GemmPlan("mma", 128, 128, 1, cdiv(M, 128) * cdiv(N, 128))

        def err(plan):
            out = fn(plan).float()
            return float((out - ref).abs().max()) / float(ref.abs().max())
        errs = {"edge": err(mine), "mma": err(mma)}
        if mine.path != "wgmma_edge" or max(errs.values()) > 1e-2:
            raise RuntimeError(f"{sig}: plan {mine}, {errs} above 1e-2 of max|ref|")
        turns = {"mma": [], "edge": []}
        for route in ("mma", "edge", "edge", "mma"):
            turns[route].append(graph_time(lambda: fn(mine if route == "edge" else mma)) * 1e6)
        lib_us = graph_time(library) * 1e6
        row = {"where": where, "plan": mine._asdict(), "errors": errs,
               "edge_us": statistics.mean(turns["edge"]), "mma_us": statistics.mean(turns["mma"]),
               "turns": turns, "library_us": lib_us, "bound_us": max(b_ms, o_ms) * 1e3,
               "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        print(f"[shape] {where} {sig}: {mine.bm}x{mine.bn}/{mine.split} {mine.ctas} blocks | "
              f"{row['edge_us']:.2f}, {row['mma_us']:.2f}, {lib_us:.2f}, "
              f"{row['bound_us']:.2f} ({row['bound_by']}) | edge {errs['edge']:.3e}, "
              f"mma {errs['mma']:.3e} ({card})")
        # every edge plan
        chunks = cdiv(K, WGMMA_CHUNK)
        sweep = []
        for bm in (128, 64):
            for bn in (128, 64):
                if bn > max(64, cdiv(N, 64) * 64):
                    continue
                for split in [d for d in range(1, min(16, chunks) + 1) if chunks % d == 0]:
                    plan = GemmPlan("wgmma_edge", bm, bn, split, 0)
                    if err(plan) > 1e-2:
                        raise RuntimeError(f"{sig} {plan}: above 1e-2 of max|ref|")
                    sweep.append({"bm": bm, "bn": bn, "split": split,
                                  "us": graph_time(lambda: fn(plan)) * 1e6})
        sweep.sort(key=lambda r: r["us"])
        row["sweep"] = sweep
        print(f"[sweep] {sig}: planner {mine.bm}x{mine.bn}/{mine.split}; fastest " + ", ".join(
            f"{r['bm']}x{r['bn']}/{r['split']} {r['us']:.1f} us" for r in sweep[:6]))
        result["shapes"][str(sig)] = row
        del x, w, dense, ref
    heads = [result["shapes"][str(sig)] for sig in cs.EDGE_SHAPES]
    result["heads_sum_us"] = {k: sum(r[k] for r in heads)
                              for k in ("edge_us", "mma_us", "library_us", "bound_us")}
    print(f"[heads] the six mbox_conf heads, summed: edge {result['heads_sum_us']['edge_us']:.2f}"
          f" us, mma.sync loop {result['heads_sum_us']['mma_us']:.2f}, cuDNN "
          f"{result['heads_sum_us']['library_us']:.2f}, bound "
          f"{result['heads_sum_us']['bound_us']:.2f} ({card})")

    if args.replays:
        from boda_tpu_torch.config import make
        from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
        planned = convmod.plan_gemm

        @contextlib.contextmanager
        def on_mma():
            """The edge convs on the mma.sync loop, as they were planned before."""
            def plan(M, N, K, sms_, dtype, conv_c=None, aligned=True):
                got = planned(M, N, K, sms_, dtype, conv_c=conv_c, aligned=aligned)
                if got.path != "wgmma_edge":
                    return got
                return GemmPlan("mma", 128, 128, 1, cdiv(M, 128) * cdiv(N, 128))
            convmod.plan_gemm = plan
            try:
                yield
            finally:
                convmod.plan_gemm = planned
        nodes = ["mbox_conf_softmax", "detection_out"]
        pipe, dims = load_net("ssd300", img=cs.SSD_BATCH)
        ins = gen_data_inputs(dims)
        engines, outs = {}, {}
        for route in ("mma", "edge"):
            with on_mma() if route == "mma" else contextlib.nullcontext():
                e = engines[route] = make("conv_fwd", "cuda", compute_tn="bfloat16")
                e.init(pipe)
                before = dict(convmod.conv2d.paths)
                copies = convmod.conv2d.pad_copies
                e.prepare(ins, nodes)
                paths = {q: convmod.conv2d.paths[q] - before[q] for q in before}
                outs[route] = e.run_fwd(ins, nodes)
                print(f"[replay] ssd300 b{cs.SSD_BATCH} {route}: conv launches by path in the "
                      f"warm-up and the capture {paths}, weight copies "
                      f"{convmod.conv2d.pad_copies - copies}")
        turns = {"mma": [], "edge": []}
        for route in ("mma", "edge", "edge", "mma"):
            e = engines[route]
            turns[route].append(statistics.median(e.time_fwd(ins, nodes, n_iters=20)
                                                  for _ in range(3)) * 1e3)
        diffs = {}
        for nd in nodes:
            a, b = (np.asarray(outs[r][nd].data, np.float64) for r in ("edge", "mma"))
            diffs[nd] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        row = {"mma_ms": statistics.mean(turns["mma"]), "edge_ms": statistics.mean(turns["edge"]),
               "turns": turns, "out_rel_err": diffs}
        result["replays"][f"ssd300 b{cs.SSD_BATCH}"] = row
        print(f"[replay] ssd300 b{cs.SSD_BATCH} bf16 gen: mma.sync loop / edge "
              f"{row['mma_ms']:.3f} / {row['edge_ms']:.3f} ms ({turns}); edge vs mma "
              f"{diffs} ({card})")
    print(cs.smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
