#!/usr/bin/env python3
"""K8 (the pooling kernel, csrc/pool.cu) at the ResNet-50 b32 fused forward's
two pools and K9 (the elementwise kernel, csrc/eltwise.cu) at the rtc
corpus's largest residual add, beside the library call for the same function
and the bound, on one card.

pool1 is the 3x3 s2 max over 32x112x112x64 (ceil mode, the last window
clipped), pool5 the 7x7 avg over 32x7x7x2048; K9 runs add, mul and relu over
32x256x56x56 bf16. Each is timed as chip_smoke.py times it: its device time,
20 calls captured in one CUDA graph and replayed ("device"), and 20
back-to-back calls between two CUDA events ("launch"), L2 warm. The bound is
the bytes (each input read once, each output written once) over 3.35 TB/s
(NVIDIA's H100 SXM data sheet). ``--root`` names the checkout whose
``boda_tpu_torch`` is timed, so that the parent commit and a change can be
timed on one card in one command (run parent, change, change, parent); the
route and plan are printed where that tree keeps them.

``--sweep`` (a tree whose C entry points take their plans from Python)
also times other plans than the shipped ones, launched through those entry
points: K9's stage size, stage count and blocks per SM, K8's ring of input
rows and grid at pool1 and its lanes and slices at pool5. Nothing is
rebuilt for it.

Prints the card's name and power limit, a line per case and, last, one JSON
object.

    python3 scripts/torch_pool_eltwise.py [--root DIR] [--tag NAME] [--sweep]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
# chip_smoke.py's pool signatures: (n, h, c, k, s, oy, avg)
POOLS = {"pool1": (32, 112, 64, 3, 2, 56, False), "pool5": (32, 7, 2048, 7, 1, 1, True)}
ELT_N = 32 * 256 * 56 * 56


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose boda_tpu_torch to time")
    ap.add_argument("--tag", default="", help="a name for this tree in the output")
    ap.add_argument("--sweep", action="store_true", help="time other plans too")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_pool_eltwise: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels import elementwise as elt
    from boda_tpu_torch.ops.kernels import pool as pl
    from boda_tpu_torch.rtc.backends import graph_time

    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    rng = np.random.default_rng(0)

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf)

    res = {}

    def timed(name, fk, lib, bound_ms, note=""):
        r = {"device_ms": graph_time(fk) * 1e3, "launch_ms": cs.cuda_ms(fk),
             "library_device_ms": graph_time(lib) * 1e3, "library_launch_ms": cs.cuda_ms(lib),
             "bound_ms": bound_ms, "note": note}
        res[name] = r
        print(f"[{args.tag}] {name}: device {r['device_ms'] * 1e3:.2f} us (launched "
              f"{r['launch_ms'] * 1e3:.2f}), library device {r['library_device_ms'] * 1e3:.2f} "
              f"us (launched {r['library_launch_ms'] * 1e3:.2f}), bound "
              f"{bound_ms * 1e3:.2f} us, {bound_ms / r['device_ms'] * 100:.1f}% of it; {note}")
        return r

    for name, sig in POOLS.items():
        n, h, c, k, s, oy, avg = sig
        x = rnd((n, h, h, c))
        pad = (0, max(0, (oy - 1) * s + k - h))
        geom = ((k, k), (s, s), pad, pad, oy, oy, avg)
        out, ref = pl.pool2d(x, *geom), pl.pool2d_plain(x, *geom)
        torch.cuda.synchronize()
        _, err = cs.rel_err(out, ref)
        if err > 1e-2 or (not avg and not torch.equal(out, ref)):
            print(f"torch_pool_eltwise: {name} rel err {err:.3g}", file=sys.stderr)
            return 1
        plan = cs.pool_plan_str(getattr(pl.pool2d, "last_plan", None))
        lib_pool = F.avg_pool2d if avg else F.max_pool2d
        xn = x.permute(0, 3, 1, 2)
        timed(name, lambda: pl.pool2d(x, *geom),
              lambda: lib_pool(xn, k, s, ceil_mode=True), max(cs.work("pool", sig)),
              f"plan {plan}, rel err {err:.2e}")
        if args.sweep:
            def launch(p):
                o = torch.empty_like(ref)
                params = (p.blocks, p.slots) if p.route == "rows" else (p.lanes, p.slices)
                rc = build.load().lib.boda_pool2d(
                    x.data_ptr(), o.data_ptr(), n, h, h, c, oy, oy, k, k, s, s, 0, 0, int(avg),
                    1, pl.ROUTES.index(p.route), *params, build.stream_ptr(x))
                build.check(rc, f"boda_pool2d {p}")
                return o
            if name == "pool1":
                plans = []
                for slots in (1, 2, 3, 4, 6):
                    p0 = pl.rows_plan(n, h, c, (k, k), oy, oy, avg, slots)
                    plans += [p0, p0._replace(blocks=p0.blocks // 2)]
            else:
                plans = [pl.PoolPlan("window", 0, 0, lanes, slices, 0)
                         for lanes, slices in ((32, 8), (32, 4), (16, 16), (32, 2), (8, 32),
                                               (32, 1))]
            for p in plans:
                got = launch(p)
                torch.cuda.synchronize()
                _, e = cs.rel_err(got, ref)
                if e > 1e-2 or (not avg and not torch.equal(got, ref)):
                    print(f"torch_pool_eltwise: {name} plan {p} rel err {e:.3g}",
                          file=sys.stderr)
                    return 1
                timed(f"{name} sweep {cs.pool_plan_str(p)}", lambda p=p: launch(p),
                      lambda: lib_pool(xn, k, s, ceil_mode=True),
                      max(cs.work("pool", sig)), f"plan {cs.pool_plan_str(p)}")
        del x, out, ref

    a, b = rnd((ELT_N,)), rnd((ELT_N,))
    for func, lib, nin in (("add", torch.add, 2), ("mul", torch.mul, 2),
                           ("relu", torch.relu, 1)):
        ins = (a, b)[:nin]
        out = elt.eltwise(func, *ins)
        torch.cuda.synchronize()
        if not torch.equal(cs.bits(out), cs.bits(elt.eltwise_plain(func, *ins))):
            print(f"torch_pool_eltwise: eltwise {func} not bit-equal", file=sys.stderr)
            return 1
        plan = getattr(elt.eltwise, "last_plan", None)
        timed(f"eltwise {func}", lambda: elt.eltwise(func, *ins), lambda: lib(*ins),
              (nin + 1) * ELT_N * 2 / cs.HBM_BPS * 1e3, f"plan {plan}")
    if args.sweep:
        want = elt.eltwise_plain("add", a, b)

        def launch(blocks, stage_bytes, stages):
            o = torch.empty_like(a)
            rc = build.load().lib.boda_eltwise(
                a.data_ptr(), b.data_ptr(), o.data_ptr(), ELT_N, elt.FUNC_CODES["add"],
                elt.ELT_DTYPES[bf], elt.PATHS.index("ring"), blocks, stage_bytes, stages,
                build.stream_ptr(a))
            build.check(rc, "boda_eltwise")
            return o
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for stage_bytes in (2048, 4096, 8192, 16384, 32768):
            for stages in (2, 3, 4, 6, 8):
                for per_sm in (1, 2, 3):
                    if 128 + 2 * stages * stage_bytes + 1024 > 233472 // per_sm:
                        continue
                    cfg = (sms * per_sm, stage_bytes, stages)
                    got = launch(*cfg)
                    torch.cuda.synchronize()
                    if not torch.equal(cs.bits(got), cs.bits(want)):
                        print(f"torch_pool_eltwise: eltwise ring {cfg} not bit-equal",
                              file=sys.stderr)
                        return 1
                    timed(f"eltwise add sweep {stage_bytes}B x{stages} {per_sm}/SM",
                          lambda cfg=cfg: launch(*cfg), lambda: torch.add(a, b),
                          3 * ELT_N * 2 / cs.HBM_BPS * 1e3,
                          f"{cfg[0]} blocks, {stage_bytes} B x {stages} stages")
    print(json.dumps({"tag": args.tag, "card": card, "cases": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
