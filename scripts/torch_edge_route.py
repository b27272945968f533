#!/usr/bin/env python3
"""The GEMM core's edge route (``wgmma_edge``: csrc/gemm.cuh's wgmma ring for
N % 8 != 0 and even, B's rows padded to 16 bytes, the output stored from the
accumulators) against the mma.sync loop that such products took before it,
the library and the bound, on one card.

At each of chip_smoke.py's EDGE_SHAPES (ssd300's six mbox_conf heads at b4,
K2, no ReLU, as the engine runs them) and EDGE_GEMMS' K1 forward (fc1000's
(tp=2) slice), on seeded bf16 operands with B in the engine's padded rows
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

At EDGE_GEMMS' backward products (fc1000's (tp=2) slice: K1's dgrad dY @ W^T
on the wgmma route with A at lda = 504, K5's wgrad x^T @ dY on wgmma_edge
with B at ldb = 504), on seeded bf16 operands as the step lays them out
(``copy_rows``): the planned route and the mma.sync loop on a dense dY, as
the parent commit launched it (the C entry past the plan), each held to its
plain version (1e-2 of max|ref|), the route bit-equal over two launches;
cuBLAS's ``torch.mm`` / ``a.t() @ b`` on the same padded layout; timed as
above in turns loop, route, route, loop.

``--replays 1``: ssd300 b4 bf16 gen, its forward captured twice: with the
heads on wgmma_edge, and on the mma.sync loop (``conv.plan_gemm`` wrapped to
give them the plan they had before), ms per replay (``time_fwd``, 20
replays, the median of 3) in turns mma, edge, edge, mma; the two forwards'
mbox_conf_softmax and detection_out against each other.

``--parent DIR`` (a checkout of the parent commit): in each tree, in its own
process, in turns parent, this, this, parent: ms per replay of the ResNet-50
b32 bf16 gen forward (prob), GoogLeNet and VGG-16 b32 (prob) and ssd300 b4
(detection_out), each the median of 3 ``time_fwd`` runs of 20 replays; the
(tp=2) ResNet-50 b32 bf16 gen train-mode training step (chip_smoke.py's
TP_KW) captured and replayed (CUDA events over 10 calls, cuDNN's
deterministic algorithms, as chip_smoke.py's ``[tp-train]``), and its second
eager step's K1/K5 launches per path and weight copies
(``matmul.pad_copies``, ``conv2d.pad_copies``).

Prints the card's name and power limit first and last, and as its last line
one JSON object with every number.

    python3 scripts/torch_edge_route.py [--replays 1] [--parent build/parent]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _chip_smoke(tree: Path):
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", tree / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def worker(tree: Path) -> dict:
    """The replays and the (tp=2) step's counts of the package in ``tree``."""
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    cs = _chip_smoke(tree)
    from boda_tpu_torch.config import make
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.ops.kernels import bconv, build, conv, sgemm
    from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern
    from boda_tpu_torch.parallel.mesh import make_mesh, shard_weights
    from boda_tpu_torch.parallel.train import make_train_step
    assert Path(sgemm.__file__).is_relative_to(tree), sgemm.__file__
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev = torch.device("cuda")
    out = {"tree": str(tree), "build_s": build.load().build_secs, "replay_ms": {}}
    for net, img, outs in (("resnet50", 32, ["prob"]), ("googlenet_conv", 32, ["prob"]),
                           ("vgg16", 32, ["prob"]), ("ssd300", 4, ["detection_out"])):
        pipe, dims = load_net(net, img=img)
        ins = gen_data_inputs(dims)
        e = make("conv_fwd", "cuda", compute_tn="bfloat16")
        e.init(pipe)
        e.prepare(ins, outs)
        out["replay_ms"][f"{net} b{img}"] = float(np.median(
            [e.time_fwd(ins, outs, n_iters=20, warmup=3) for _ in range(3)])) * 1e3
        del e, pipe
        torch.cuda.empty_cache()
    pipe, dims = load_net("resnet50", img=32)
    d = dims["data"]
    x = gen_data_pattern(d.shape, d.tn).to(dev, torch.bfloat16)
    labels = (torch.arange(32) % 1000).to(dev)
    w0 = {k: torch.from_numpy(np.asarray(w.data, np.float32)).to(dev, torch.bfloat16)
          for k, w in pipe.weights.items()}
    mesh = make_mesh({"tp": 2}, devices=cs.mesh_devices(2))
    torch.backends.cudnn.deterministic = True
    step = make_train_step(pipe, "fc1000", mesh=mesh, **cs.TP_KW)
    w, mom = shard_weights(w0, pipe, mesh), None
    for i in range(2):
        if i == 1:
            paths = {k: dict(f.paths) for k, f in (("sgemm", sgemm.matmul),
                                                   ("atb", bconv.matmul_atb))}
            copies = (sgemm.matmul.pad_copies, conv.conv2d.pad_copies)
        _, w, mom = step(w, {"data": x}, labels, mom)
    torch.cuda.synchronize()
    out["tp2_step_paths"] = {k: {q: v - paths[k][q] for q, v in f.paths.items() if v != paths[k][q]}
                             for k, f in (("sgemm", sgemm.matmul), ("atb", bconv.matmul_atb))}
    out["tp2_step_pad_copies"] = {"matmul": sgemm.matmul.pad_copies - copies[0],
                                  "conv2d": conv.conv2d.pad_copies - copies[1]}
    del step, w, mom
    graphed = make_train_step(pipe, "fc1000", mesh=mesh, cuda_graph=True, **cs.TP_KW)
    _, gw, gm = graphed(shard_weights(w0, pipe, mesh), {"data": x}, labels)
    out["tp2_replay_ms"] = cs.cuda_ms(lambda: graphed(gw, {"data": x}, labels, gm), 10, 1)
    return out


def per_call(cs, card: str) -> dict:
    """EDGE_GEMMS' backward products (fc1000's (tp=2) dgrad and wgrad on dY's
    padded rows) on their routes, on the loop and on cuBLAS."""
    import torch

    from boda_tpu_torch.ops.kernels.bconv import matmul_atb, matmul_atb_plain
    from boda_tpu_torch.ops.kernels.common import copy_rows
    from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain
    from boda_tpu_torch.rtc.backends import graph_time
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(28)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)
    rows = {}
    for (kname, sig), where in cs.EDGE_GEMMS.items():
        if kname == "sgemm" and sig[1] % 8 == 0:
            continue  # the forward: main's edge rows
        if kname == "sgemm":  # dY (M, K) @ W^T (K, N)
            M, K, N = sig
            dy, b = rnd((M, K)), rnd((K, N), K ** -0.5)
            a = copy_rows(dy, bf)
            route, want = (lambda: matmul(a, b)), "wgmma"
            loop = (lambda: cs.mma_gemm(dy, b))
            lib = (lambda: torch.mm(a, b))
            ref = matmul_plain(a, b)
            counter = matmul
            b_ms, o_ms = cs.work("sgemm", (M, K, N, False, False))
        else:  # x^T (M, K) @ dY (K, N)
            K, M, N = sig
            x, dy = rnd((K, M)), rnd((K, N))
            bp = copy_rows(dy, bf)
            route, want = (lambda: matmul_atb(x, bp)), "wgmma_edge"
            loop = (lambda: cs.mma_atb(x, dy))
            lib = (lambda: x.t() @ bp)
            ref = matmul_atb_plain(x, bp)
            counter = matmul_atb
            b_ms, o_ms = cs.work("atb_dense", sig)
        before = dict(counter.paths)
        got = route()
        ran = [q for q in before if counter.paths[q] != before[q]]
        errs = {"route": cs.rel_err(got, ref)[1], "loop": cs.rel_err(loop(), ref)[1]}
        if ran != [want] or max(errs.values()) > 1e-2 or not torch.equal(route(), got):
            raise RuntimeError(f"{where}: ran {ran}, errors {errs}, plan {counter.last_plan}")
        turns = {"loop": [], "route": []}
        for t in ("loop", "route", "route", "loop"):
            turns[t].append(graph_time(loop if t == "loop" else route) * 1e6)
        row = {"where": where, "plan": counter.last_plan._asdict(), "errors": errs,
               "route_us": statistics.mean(turns["route"]),
               "loop_us": statistics.mean(turns["loop"]), "turns": turns,
               "library_us": graph_time(lib) * 1e6, "bound_us": max(b_ms, o_ms) * 1e3,
               "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        rows[f"{kname} {sig}"] = row
        print(f"[call] {where} {sig}: {want} {row['route_us']:.2f} us, mma.sync loop "
              f"{row['loop_us']:.2f}, cuBLAS {row['library_us']:.2f}, bound "
              f"{row['bound_us']:.2f} ({row['bound_by']}); errors {errs}; plan "
              f"{cs.plan_str(counter.last_plan)} ({card})")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--replays", type=int, default=0,
                    help="1: also time ssd300's replay with the heads on both routes")
    ap.add_argument("--parent", default="", help="a checkout of the parent commit")
    ap.add_argument("--worker", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_edge_route: needs a CUDA card", file=sys.stderr)
        return 1
    if args.worker:
        print(json.dumps(worker(Path(args.worker).resolve())))
        return 0
    sys.path.insert(0, str(HERE))
    cs = _chip_smoke(HERE)
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
                                      plan.split, K, ldb, build.stream_ptr(x)), f"gemm {plan}")
            return out
        return fn

    result = {"card": card, "sms": sms, "shapes": {}, "replays": {}}
    print(f"[shape] sig: edge plan | edge, mma.sync loop, library, bound us | errors ({card})")
    fwd = {sig: where for (kname, sig), where in cs.EDGE_GEMMS.items()
           if kname == "sgemm" and sig[1] % 8 == 0}  # K1's forward: N % 8 != 0
    for sig, where in {**cs.EDGE_SHAPES, **fwd}.items():
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
    result["calls"] = per_call(cs, card)

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
    if args.parent:
        trees = {"parent": Path(args.parent).resolve(), "this": HERE}
        turns: dict = {"parent": [], "this": []}
        for tag in ("parent", "this", "this", "parent"):
            r = subprocess.run([sys.executable, __file__, "--worker", str(trees[tag])],
                               cwd=trees[tag], capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout[-4000:], r.stderr[-4000:], sep="\n", file=sys.stderr)
                raise RuntimeError(f"worker {tag} failed ({r.returncode})")
            got = json.loads(r.stdout.strip().splitlines()[-1])
            turns[tag].append(got)
            print(f"[replay] {tag}: ms per replay {got['replay_ms']}, (tp=2) step replayed "
                  f"{got['tp2_replay_ms']:.3f}; its eager step's paths {got['tp2_step_paths']}, "
                  f"weight copies {got['tp2_step_pad_copies']}; kernels built in "
                  f"{got['build_s']:.1f} s ({card})")
        mean = {tag: {k: statistics.mean(t["replay_ms"][k] for t in turns[tag])
                      for k in turns[tag][0]["replay_ms"]} for tag in turns}
        for tag in turns:
            mean[tag]["(tp=2) step"] = statistics.mean(t["tp2_replay_ms"] for t in turns[tag])
        ratio = {k: mean["this"][k] / mean["parent"][k] for k in mean["this"]}
        print("[replay] this / parent: " + ", ".join(
            f"{k} {mean['this'][k]:.3f} / {mean['parent'][k]:.3f} ({ratio[k]:.4f})"
            for k in ratio) + f" ({card})")
        result.update(turns=turns, mean_ms=mean, ratio=ratio)
    print(cs.smi())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
