#!/usr/bin/env python3
"""K1 (matmul) and K2 (conv2d) per shape at the ResNet-50 b32 bf16 forward's
GEMM and conv signatures, and K5 (conv2d_bck_filts) at its gradient graph's
46 weight gradients, beside one library call for the same function (cuDNN's
``conv2d_weight`` for K5) and the bound, on one card.

The shapes come from the engine's own dispatch (gen, bf16, batch 32), as in
chip_smoke.py. Each call is timed as chip_smoke.py times it: 3 warm-ups, then
20 back-to-back calls between two CUDA events, L2 warm ("launch"); and its
device time alone, 20 calls captured in one CUDA graph and replayed
("device"); and the host's µs per call over those 20 launches. The bound is the
larger of the bytes (each input read once, each output written once) over
3.35 TB/s and the operations over 989 TFLOP/s (bf16, NVIDIA's H100 SXM data
sheet). ``--root`` names the checkout whose ``boda_tpu_torch`` is timed, so
that the parent commit and a change can be timed on one card in one command
(run parent, change, change, parent); the plan is printed where that tree
has one. Prints the card's name and power limit, a line per signature and,
last, one JSON object with the totals per forward.

    python3 scripts/torch_gemm_shapes.py [--root DIR] [--tag NAME]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose boda_tpu_torch to time")
    ap.add_argument("--tag", default="", help="a name for this tree in the output")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_gemm_shapes: needs a CUDA card", file=sys.stderr)
        return 1
    # chip_smoke.py's shape extraction, timing and bound, from this checkout
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph.autodiff import add_bck_ops
    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.ops.kernels.bconv import conv2d_bck_filts, matmul_atb
    from boda_tpu_torch.ops.kernels.conv import conv2d
    from boda_tpu_torch.ops.kernels.sgemm import matmul

    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    pipe, _ = load_net("resnet50", img=cs.BATCH)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    gemm, conv = cs.layer_shapes(pipe, eng)
    bpipe, _ = load_net("resnet50", img=cs.BATCH)
    add_bck_ops(bpipe)
    beng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    beng.init(bpipe)
    wgrads = cs.bck_shapes(bpipe, beng)
    del beng
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def plan_of(fn) -> str:
        return cs.plan_str(getattr(fn, "last_plan", None))

    def gemm_case(M, K, N, res, relu):
        a, b, bias = rnd((M, K)), rnd((K, N), K ** -0.5), rnd((N,), 0.1)
        r = rnd((M, N)) if res else None

        def lib():
            o = torch.addmm(bias, a, b)
            o = o + r if r is not None else o
            return torch.relu(o) if relu else o
        return lambda: matmul(a, b, bias, relu=relu, residual=r), lib

    def conv_case(n, h, c, oc, k, s, p, res, relu):
        x, w = rnd((n, h, h, c)), rnd((k, k, c, oc), (k * k * c) ** -0.5)
        bias = rnd((oc,), 0.1)
        oh = (h + 2 * p - k) // s + 1
        r = rnd((n, oh, oh, oc)) if res else None
        w_lib = w.permute(3, 0, 1, 2).contiguous()  # OHWI: channels_last OIHW view

        def lib():
            o = F.conv2d(x.permute(0, 3, 1, 2), w_lib.permute(0, 3, 1, 2), bias,
                         stride=s, padding=p).permute(0, 2, 3, 1)
            o = o + r if r is not None else o
            return torch.relu(o) if relu else o
        return lambda: conv2d(x, w, bias, stride=(s, s), pad=(p, p), relu=relu,
                              residual=r), lib

    def atb_case(n, h, c, oc, k, p):
        oh = h + 2 * p - k + 1
        x, dy = rnd((n, h, h, c)), rnd((n, oh, oh, oc))
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels_last views
        return (lambda: conv2d_bck_filts(x, dy, pad=(p, p)),
                lambda: torch.nn.grad.conv2d_weight(xn, (oc, c, k, k), dyn, padding=p))

    def host_us(fn, reps: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = time.perf_counter() - t0
        torch.cuda.synchronize()
        return t / reps * 1e6

    keys = ("kernel", "kernel_device", "host", "library", "library_device", "bound")
    tot = {k: dict.fromkeys(keys, 0.0) for k in ("sgemm", "conv", "atb")}
    print(f"[shapes {args.tag}] kernel sig: us of kernel launch / device / host per call, "
          f"library launch / device, bound; count; plan ({card})")
    for kname, shapes, case, fn in (("sgemm", gemm, gemm_case, matmul),
                                    ("conv", conv, conv_case, conv2d),
                                    ("atb", wgrads, atb_case, matmul_atb)):
        for sig, count in shapes.items():
            fk, fl = case(*sig)
            fk()
            plan = plan_of(fn)
            v = dict(zip(keys, (cs.cuda_ms(fk) * 1e3, cs.graph_ms(fk) * 1e3, host_us(fk),
                                cs.cuda_ms(fl) * 1e3, cs.graph_ms(fl) * 1e3,
                                max(cs.work(kname, sig)) * 1e3)))
            for k in keys:
                tot[kname][k] += v[k] * count
            print(f"[shapes {args.tag}] {kname} {sig}: " + " ".join(f"{v[k]:.1f}" for k in keys)
                  + f" x{count} {plan}")
            del fk, fl
    # sgemm and conv per forward, atb per gradient pass
    print(json.dumps({"tag": args.tag, "card": card, "per_forward_ms": {
        kn: {k: v / 1e3 for k, v in t.items()} for kn, t in tot.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
