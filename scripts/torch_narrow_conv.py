#!/usr/bin/env python3
"""K2's narrow route (``wgmma_narrow``: csrc/gemm.cuh's wgmma ring with the
conv's A built element by element, for C % 8 != 0) against the mma.sync loop
that such convs took before it, cuDNN and the bound, on one card.

At each of chip_smoke.py's NARROW_SHAPES (the C = 3 convs the port's paths
launch), with ReLU fused as the engine fuses it, on seeded bf16 operands:

* the planned narrow launch, and the mma.sync loop through the same C entry
  point past the plan, each against ``conv2d_plain`` (within 1e-2 of
  max|ref|), and cuDNN's ``F.conv2d`` in bf16 on the channels_last views;
  each timed as 20 calls in one CUDA graph (``graph_time``, L2 warm), in
  turns: mma, narrow, narrow, mma (each time the mean of its two turns);
* every narrow plan (64 rows; 64 or 128 columns as N allows; each K split
  that divides the 64-deep chunks, up to 16), beside the planner's choice
  (ops/kernels/common.py:plan_gemm).

``--parts 1``: where the narrow route's time goes, as
scripts/torch_block_parts.py measures K6's: copies of conv.cu and gemm.cuh
(never the shipped sources) with parts left out by PATCHES (a switch
``kDrop``, ``-DNARROW_DROP``: 1 the element loads, 2 the fill's proxy fence,
4 the consumers' epilogue, 8 the wgmmas, 16 the whole fill but its arrival;
sums combine them), each build
compiled by nvcc for sm_90a into the git-ignored build/narrow_parts/ (all
started together) and timed at each shape. A build with a part left out
computes garbage; only its time is read.

``--replays 1``: ResNet-50 (``input_s2d=0``), GoogLeNet and VGG-16 at b32 and
ssd300 at b4, bf16 gen, each forward captured twice: with the narrow convs
on wgmma_narrow, and on the mma.sync loop (``conv.plan_gemm`` wrapped to give
them the plan they had before), ms per replay (``time_fwd``, 20 replays,
the median of 3) in turns mma, narrow, narrow, mma; the two forwards' outputs
against each other.

Prints the card's name and power limit first and last, and as its last line
one JSON object with every number.

    python3 scripts/torch_narrow_conv.py [--parts 1] [--replays 1]
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

# (text of gemm.cuh, what the measurement copy has in its place)
PATCHES = [
    ("constexpr int kChunk = 64;  // K per stage\n",
     "constexpr int kChunk = 64;  // K per stage\nconstexpr int kDrop = NARROW_DROP;\n"),
    ("          v[q][e] = ok ? __ldg(xrow[q] + toff[e]) : 0u;\n",
     "          v[q][e] = (kDrop & 1) ? (uint32_t)ok : ok ? __ldg(xrow[q] + toff[e]) : 0u;\n"),
    ("          fence_proxy_async();  // the stores, visible to wgmma's async proxy\n",
     "          if (!(kDrop & 2)) fence_proxy_async();\n"),
    ("      if constexpr (!TRANS_A) {\n",
     "      if constexpr (!TRANS_A) {\n        if (kDrop & 4) continue;\n"),
    ("            Wgmma<BN, 0>::mma(acc, sw128_desc(sa + kk * 32, 16, 1024), db);\n",
     "            if (!(kDrop & 8)) Wgmma<BN, 0>::mma(acc, sw128_desc(sa + kk * 32, 16, 1024), db);\n"),
    ("        fill_loads(va);  // the item's first chunk, before its stage is free\n",
     "        if (!(kDrop & 16)) fill_loads(va);\n"),
    ("        if (MODE == kModeConv && NARROW) {\n          if (i > 0) fill_loads(va);",
     "        if (MODE == kModeConv && NARROW && (kDrop & 16)) {\n          mbar_arrive(fb);\n"
     "        } else if (MODE == kModeConv && NARROW) {\n          if (i > 0) fill_loads(va);"),
]
DROPS = {0: "whole", 1: "no element loads", 2: "no proxy fence", 4: "no epilogue",
         8: "no wgmma", 12: "the fill alone (no wgmma, no epilogue)",
         13: "the fill alone, no element loads", 16: "no fill (stores, loads, index math)",
         28: "no fill, no wgmma, no epilogue"}


def parts_libs(build) -> dict:
    """{drop: the ctypes library of conv.cu built from the copy with kDrop}"""
    import ctypes
    import subprocess
    src = (build.CSRC / "gemm.cuh").read_text()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"torch_narrow_conv: gemm.cuh no longer matches the patch {old!r}")
        src = src.replace(old, new)
    out_dir = HERE / "build" / "narrow_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "gemm.cuh").write_text(src)
    (out_dir / "conv.cu").write_text((build.CSRC / "conv.cu").read_text())
    procs = {d: subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, f"-DNARROW_DROP={d}",
                                  "-shared", "-o", str(out_dir / f"conv_{d}.so"),
                                  str(out_dir / "conv.cu")],
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for d in DROPS}
    libs = {}
    for d, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(log[-4000:])
        lib = ctypes.CDLL(str(out_dir / f"conv_{d}.so"))
        lib.boda_conv2d.argtypes = build._SIGS["boda_conv2d"]
        libs[d] = lib
    return libs


# the nets whose replays move with the narrow convs: (zoo name, batch, output)
REPLAY_NETS = (("resnet50", 32, "prob"), ("googlenet_conv", 32, "prob"),
               ("vgg16", 32, "prob"), ("ssd300", 4, "detection_out"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", type=int, default=0,
                    help="1: also time builds with parts of the narrow route left out")
    ap.add_argument("--replays", type=int, default=0,
                    help="1: also time each net's replay on both routes")
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_narrow_conv: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels import conv as convmod
    from boda_tpu_torch.ops.kernels.common import (PATH_CODES, WGMMA_CHUNK, GemmPlan, cdiv,
                                                   plan_gemm, sm_count, splitk_workspace)
    from boda_tpu_torch.ops.kernels.conv import conv2d_plain
    from boda_tpu_torch.rtc.backends import graph_time

    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    kb = build.load()
    part_libs = parts_libs(build) if args.parts else {}
    narrow_fn = False
    for ln in kb.log.splitlines():  # ptxas on the narrow kernels: registers, spills
        if "Compiling entry function" in ln or "Function properties for" in ln:
            narrow_fn = "gemm_wgmma" in ln and "Lb1E" in ln  # <..., NARROW = true>
        if narrow_fn:
            print(f"[build] {ln.strip()}")
    lib = kb.lib
    sms = sm_count(dev)
    gen = torch.Generator(device=dev).manual_seed(24)

    def launcher(x, w, bias, s, p, lib=lib):
        n, h, _, c = x.shape
        k, oc = w.shape[0], w.shape[3]
        oh = (h + 2 * p - k) // s + 1

        def fn(plan):
            out = torch.empty((n, oh, oh, oc), dtype=bf, device=dev)
            ws = splitk_workspace(plan, n * oh * oh, oc, dev)
            build.check(lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(), None,
                                        out.data_ptr(), None if ws is None else ws.data_ptr(),
                                        n, h, h, c, oh, oh, oc, k, k, s, s, p, p, 1, 1,
                                        PATH_CODES[plan.path], plan.bm, plan.bn, plan.split,
                                        oc, build.stream_ptr(x)), f"conv {plan}")
            return out
        return fn

    result = {"card": card, "sms": sms, "shapes": {}, "replays": {}}
    print(f"[shape] sig: narrow plan | narrow, mma.sync loop, cuDNN, bound us | errors ({card})")
    for sig, where in cs.NARROW_SHAPES.items():
        n, h, c, oc, k, s, p = sig
        x = torch.randn((n, h, h, c), generator=gen, device=dev).to(bf)
        w = (torch.randn((k, k, c, oc), generator=gen, device=dev) * (k * k * c) ** -0.5).to(bf)
        bias = (torch.randn((oc,), generator=gen, device=dev) * 0.1).to(bf)
        ref = conv2d_plain(x, w, bias, stride=(s, s), pad=(p, p), relu=True).float()
        fn = launcher(x, w, bias, s, p)
        oh = (h + 2 * p - k) // s + 1
        M, K = n * oh * oh, k * k * c
        mine = plan_gemm(M, oc, K, sms, bf, conv_c=c)
        mma = GemmPlan("mma", 128, 128, 1, cdiv(M, 128) * cdiv(oc, 128))

        def err(plan):
            out = fn(plan).float()
            return float((out - ref).abs().max()) / float(ref.abs().max())
        errs = {"narrow": err(mine), "mma": err(mma)}
        if max(errs.values()) > 1e-2:
            raise RuntimeError(f"{sig}: {errs} above 1e-2 of max|ref|")
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)

        def cudnn():
            return torch.relu(F.conv2d(xn, wn, bias, stride=s, padding=p))
        turns = {"mma": [], "narrow": []}
        for route in ("mma", "narrow", "narrow", "mma"):
            turns[route].append(graph_time(lambda: fn(mine if route == "narrow" else mma)) * 1e6)
        lib_us = graph_time(cudnn) * 1e6
        b_ms, o_ms = cs.work("conv", sig + (False,))
        row = {"where": where, "plan": mine._asdict(), "errors": errs,
               "narrow_us": statistics.mean(turns["narrow"]), "mma_us": statistics.mean(turns["mma"]),
               "turns": turns, "cudnn_us": lib_us, "bound_us": max(b_ms, o_ms) * 1e3,
               "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        print(f"[shape] {where} {sig}: {mine.bm}x{mine.bn}/{mine.split} | "
              f"{row['narrow_us']:.2f}, {row['mma_us']:.2f}, {lib_us:.2f}, "
              f"{row['bound_us']:.2f} ({row['bound_by']}) | narrow {errs['narrow']:.3e}, "
              f"mma {errs['mma']:.3e} ({card})")
        # every narrow plan
        chunks = cdiv(K, WGMMA_CHUNK)
        sweep = []
        for bn in (64, 128):
            if bn > max(64, cdiv(oc, 64) * 64):
                continue
            for split in [d for d in range(1, min(16, chunks) + 1) if chunks % d == 0]:
                plan = GemmPlan("wgmma_narrow", 64, bn, split, 0)
                if err(plan) > 1e-2:
                    raise RuntimeError(f"{sig} {plan}: above 1e-2 of max|ref|")
                sweep.append({"bn": bn, "split": split, "us": graph_time(lambda: fn(plan)) * 1e6})
        sweep.sort(key=lambda r: r["us"])
        row["sweep"] = sweep
        print(f"[sweep] {sig}: planner 64x{mine.bn}/{mine.split}; " + ", ".join(
            f"64x{r['bn']}/{r['split']} {r['us']:.1f} us" for r in sweep))
        if part_libs:  # the planned narrow launch with parts left out
            row["parts_us"] = {name: graph_time(lambda d=d: launcher(x, w, bias, s, p,
                                                                    part_libs[d])(mine)) * 1e6
                               for d, name in DROPS.items()}
            print(f"[parts] {sig}: " + ", ".join(f"{k} {v:.1f} us"
                                                 for k, v in row["parts_us"].items()))
        result["shapes"][str(sig)] = row
        del x, w, ref, xn, wn

    if args.replays:
        from boda_tpu_torch.config import make
        from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
        planned = convmod.plan_gemm

        @contextlib.contextmanager
        def on_mma():
            """The narrow convs on the mma.sync loop, as they were planned before."""
            def plan(M, N, K, sms_, dtype, conv_c=None, aligned=True):
                got = planned(M, N, K, sms_, dtype, conv_c=conv_c, aligned=aligned)
                if got.path != "wgmma_narrow":
                    return got
                return GemmPlan("mma", 128, 128, 1, cdiv(M, 128) * cdiv(N, 128))
            convmod.plan_gemm = plan
            try:
                yield
            finally:
                convmod.plan_gemm = planned
        print(f"[replay] net b: ms per replay mma.sync loop / narrow (turns); outputs "
              f"narrow vs mma max|err|/max|ref| ({card})")
        for net, batch, node in REPLAY_NETS:
            pipe, dims = load_net(net, img=batch)
            ins = gen_data_inputs(dims)
            engines, outs = {}, {}
            for route in ("mma", "narrow"):
                with on_mma() if route == "mma" else contextlib.nullcontext():
                    e = engines[route] = make("conv_fwd", "cuda", compute_tn="bfloat16")
                    e.init(pipe)
                    before = dict(convmod.conv2d.paths)
                    e.prepare(ins, [node])
                    paths = {q: convmod.conv2d.paths[q] - before[q] for q in before}
                    outs[route] = e.run_fwd(ins, [node])[node].data
                    print(f"[replay] {net} b{batch} {route}: conv launches by path in the "
                          f"warm-up and the capture {paths}")
            turns = {"mma": [], "narrow": []}
            for route in ("mma", "narrow", "narrow", "mma"):
                e = engines[route]
                turns[route].append(statistics.median(e.time_fwd(ins, [node], n_iters=20)
                                                      for _ in range(3)) * 1e3)
            a, b = (np.asarray(outs[r], np.float64) for r in ("narrow", "mma"))
            diff = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
            row = {"mma_ms": statistics.mean(turns["mma"]),
                   "narrow_ms": statistics.mean(turns["narrow"]), "turns": turns,
                   "out_rel_err": diff}
            result["replays"][f"{net} b{batch}"] = row
            print(f"[replay] {net} b{batch} bf16 gen: {row['mma_ms']:.3f} / "
                  f"{row['narrow_ms']:.3f} ms ({turns}); {node} {diff:.3e} ({card})")
            del engines, outs
            torch.cuda.empty_cache()
    print(cs.smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
