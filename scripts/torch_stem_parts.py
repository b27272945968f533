#!/usr/bin/env python3
"""K7 (the fused stem, csrc/stem.cu) at the ResNet-50 b32 stem (x6
32x115x112x48 bf16, w2 192x64, pooled to 32x56x56x64): its device time, what
sets its pace, and its plan's two knobs, on one card.

* Always: the wrapper ``stem_fused`` of the checkout named by ``--root`` (so
  that the parent commit and a change can be timed on one card in one
  command: run parent, change, change, parent), beside cuDNN's conv + bias/ReLU
  + ``max_pool2d`` on the same s2d fold, each as device time: 20 calls
  captured in one CUDA graph and replayed (chip_smoke.py's ``graph_ms``).
* ``--parts``: the mma route built whole and with parts left out or changed,
  in copies of stem.cu, never in the shipped source: PATCHES put a switch
  ``kVar`` into the copy (``-DSTEM_VARIANT``, bits that combine: 1 the
  products left out, the fragments' loads kept; 2 the staging left out, each
  ring slot's barrier completed without a copy; 4 each input row staged by
  16-byte cp.async at a pixel pitch of CP + 8 bf16, 112 bytes at CP = 48, in
  place of one bulk copy at CP's 96, which costs ldmatrix a 2-way bank
  conflict; 8 the pool left out, the accumulators kept; 64 x6's fragment
  loads left out; 128 the product loop's depth taken at run time, as for
  shapes other than the stem's; 256 clock64 per phase, printed by lane 0 of
  every warp of two blocks, not timed; 512 one block per SM, at 4 bands and
  a ring of 5), and each patch must match stem.cu exactly once, or the
  script stops. A build with a part left out computes garbage; only its time
  is read. Each build is the copy alone, compiled by nvcc for sm_90a into the
  git-ignored build/stem_parts/ (all builds started together).
* ``--sweep``: other plans than ``ops/kernels/stem.py:plan``'s through the
  shipped build's C entry point: bands per image (so pooled rows per block,
  and blocks per SM where two fit) and the ring's depth.

Prints the card's name and power limit, a line per measurement and, last,
one JSON object.

    python3 scripts/torch_stem_parts.py [--root DIR] [--tag NAME] [--parts] [--sweep]
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
VARIANTS = {0: "whole", 1: "no products", 2: "no staging", 3: "neither",
            4: "cp.async at a 112-byte pitch", 8: "no pool", 11: "no products, staging or pool",
            64: "no x6 fragment loads", 128: "the product loop's depth at run time",
            256: "clock64 per phase (printed, not timed)", 512: "one block per SM (4 bands, ring 5)"}
# (text of stem.cu, what the measurement copy has in its place)
PATCHES = [
    ("#include <cmath>\n", "#include <cmath>\n#include <cstdio>\n"),
    ("constexpr int kMaxWarps = 8;        // mma: one warp per 16-pixel strip\n",
     "constexpr int kMaxWarps = 8;\nconstexpr int kVar = STEM_VARIANT;\n"
     "constexpr int kPad = (kVar & 4) ? 8 : 0;\n"),
    ("  return kBarBytes + (size_t)a.slots * a.ow * a.cp * 2 + ",
     "  return kBarBytes + (size_t)a.slots * a.ow * (a.cp + kPad) * 2 + "),
    ("  const uint32_t row_bytes = (uint32_t)a.ow * a.cp * 2;\n",
     "  const uint32_t row_bytes = (uint32_t)a.ow * (a.cp + kPad) * 2;\n"
     "  const uint32_t gbytes = (uint32_t)a.ow * a.cp * 2;\n"),
    ("      boda::mbar_expect_tx(bar, row_bytes);\n"
     "      boda::bulk_load_1d(ring + slot * row_bytes, x6 + (size_t)(c0 + issued) * a.ow * a.cp,\n"
     "                         row_bytes, bar, policy);\n",
     "      if (kVar & 4) {\n"
     "        const bf16* src = x6 + (size_t)(c0 + issued) * a.ow * a.cp;\n"
     "        for (int c = threadIdx.x; c < a.ow * a.cp / 8; c += blockDim.x)\n"
     "          boda::cp_async16(ring + slot * row_bytes +\n"
     "                               ((c / (a.cp / 8)) * (a.cp + kPad) + (c % (a.cp / 8)) * 8) * 2,\n"
     "                           src + (size_t)c * 8, true);\n"
     "        boda::cp_async_arrive(bar);\n"
     "      } else if (kVar & 2) {\n"
     "        boda::mbar_arrive(bar);\n"
     "      } else {\n"
     "        boda::mbar_expect_tx(bar, gbytes);\n"
     "        boda::bulk_load_1d(ring + slot * row_bytes, x6 + (size_t)(c0 + issued) * a.ow * a.cp,\n"
     "                           gbytes, bar, policy);\n"
     "      }\n"),
    ("    for (int i = 0; i < a.slots; ++i) boda::mbar_init(bars + 8 * i, 1);\n",
     "    for (int i = 0; i < a.slots; ++i) boda::mbar_init(bars + 8 * i, (kVar & 4) ? blockDim.x : 1);\n"),
    ("    issue_to(a.slots);\n  }\n",
     "    if (!(kVar & 4)) issue_to(a.slots);\n  }\n"
     "  if (kVar & 4) {\n    __syncthreads();\n    issue_to(a.slots);\n  }\n"),
    ("* a.cp + ((lane >> 3) & 1) * 8) * 2);\n",
     "* (a.cp + kPad) + ((lane >> 3) & 1) * 8) * 2);\n"),
    ("  if (kh == 4 && cp == 48 && oc == 64) return launch(stem_mma<4, 4, 3>, ",
     "  if (!(kVar & 128) && kh == 4 && cp == 48 && oc == 64) return launch(stem_mma<4, 4, 3>, "),
    ("          ldsm_x4(ring + sl * row_bytes + x_lane + 32 * j, xf[r]);\n",
     "          if (kVar & 64)\n"
     "            xf[r][0] = xf[r][1] = xf[r][2] = xf[r][3] = sl + 32 * j;\n"
     "          else\n"
     "            ldsm_x4(ring + sl * row_bytes + x_lane + 32 * j, xf[r]);\n"),
    ("              mma16816(acc[r][mt][nt], wf[mt], xf[r][2 * nt], xf[r][2 * nt + 1]);\n",
     "              if (!(kVar & 1))\n"
     "                mma16816(acc[r][mt][nt], wf[mt], xf[r][2 * nt], xf[r][2 * nt + 1]);\n"
     "              else  // keep the fragments' loads\n"
     "                acc[r][mt][nt][0] += __uint_as_float(wf[mt][0] ^ xf[r][2 * nt + 1]);\n"),
    ("    if (threadIdx.x == 0) issue_to(2 * t + 1 + a.slots);\n",
     "    if ((kVar & 4) || threadIdx.x == 0) issue_to(2 * t + 1 + a.slots);\n"
     "    if (kVar & 8) {  // keep every accumulator alive, pool nothing\n"
     "      float z = 0.f;\n"
     "#pragma unroll\n"
     "      for (int r = 0; r < 2; ++r)\n"
     "#pragma unroll\n"
     "        for (int mt = 0; mt < NF; ++mt)\n"
     "#pragma unroll\n"
     "          for (int nt = 0; nt < 2; ++nt)\n"
     "            z += acc[r][mt][nt][0] + acc[r][mt][nt][1] + acc[r][mt][nt][2] + acc[r][mt][nt][3];\n"
     "      if (lane == 0) edge[s] += z;\n"
     "      continue;\n"
     "    }\n"),
    # one block per SM (variant 512)
    ("__launch_bounds__(kMaxWarps * 32, NF <= 4 ? 2 : 1)",
     "__launch_bounds__(kMaxWarps * 32, (NF <= 4 && !(kVar & 512)) ? 2 : 1)"),
    # clock64 per phase, printed by two blocks' lane 0s (variant 256)
    ("  const int strips = a.ow / 16, s = threadIdx.x >> 5, nthr = blockDim.x;\n",
     "  const int strips = a.ow / 16, s = threadIdx.x >> 5, nthr = blockDim.x;\n"
     "  const long long ck_in = (kVar & 256) ? clock64() : 0;\n"
     "  long long ck_mma = 0, ck_sync = 0, ck_pool = 0, ck_prev = 0, ck_first = 0;\n"),
    ("  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n",
     "  asm volatile(\"cp.async.wait_all;\\n\" ::: \"memory\");\n"
     "  const long long ck_w2 = (kVar & 256) ? clock64() : 0;\n"),
    ("  for (int t = 0; t <= p1 - p0; ++t) {\n",
     "  for (int t = 0; t <= p1 - p0; ++t) {\n"
     "    const long long ck0 = (kVar & 256) ? clock64() : 0;\n"
     "    if (t > 0) ck_pool += ck0 - ck_prev; else ck_first = ck0;\n"),
    ("    // the strip's first pixel",
     "    const long long ck1 = (kVar & 256) ? clock64() : 0;\n"
     "    ck_mma += ck1 - ck0;\n    // the strip's first pixel"),
    ("    __syncthreads();  // every read of this step's input rows and edges is ordered before\n",
     "    __syncthreads();  // every read of this step's input rows and edges is ordered before\n"
     "    ck_prev = (kVar & 256) ? clock64() : 0;\n    ck_sync += ck_prev - ck1;\n"),
    ("    }\n  }\n}\n\n// ---- fma",
     "    }\n  }\n"
     "  if ((kVar & 256) && lane == 0 && (blockIdx.x + blockIdx.y == 0 ||\n"
     "                                    (blockIdx.x == 2 && blockIdx.y == 15))) {\n"
     "    ck_pool += clock64() - ck_prev;\n"
     "    printf(\"[clocks] block (%d, %d) warp %d: w2 staged %lld, before the steps %lld, waits and \"\n"
     "           \"products %lld, edges and barrier %lld, pool %lld\\n\", blockIdx.x, blockIdx.y, s,\n"
     "           ck_w2 - ck_in, ck_first - ck_in, ck_mma, ck_sync, ck_pool);\n"
     "  }\n}\n\n// ---- fma"),
]


def patched_source(src: str) -> str:
    """stem.cu with the switch ``kVar`` put in by PATCHES."""
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"torch_stem_parts: stem.cu no longer matches the patch {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE), help="checkout whose boda_tpu_torch to time")
    ap.add_argument("--tag", default="", help="a name for this tree in the output")
    ap.add_argument("--parts", action="store_true", help="time the patched builds")
    ap.add_argument("--sweep", action="store_true", help="time other plans")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("torch_stem_parts: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.stem import stem_fused, stem_fused_plain
    card = cs.smi()
    print(card)
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    bf = torch.bfloat16
    (x6, w2, sb), xsd, wf, kh, pooled = cs.stem_inputs(32, 224, 64, bf, np.random.default_rng(7))
    n, xs_h, ow, cp = x6.shape
    oc = w2.shape[1]
    kw = dict(kh=kh, poh=pooled, pow_=pooled, relu=True)
    ref = stem_fused_plain(x6, w2, sb, **kw)
    out = stem_fused(x6, w2, sb, **kw)
    err = cs.rel_err(out, ref)[1]
    w_lib = wf.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    xs_lib = xsd.permute(0, 3, 1, 2)
    result = {"card": card, "tag": args.tag, "root": str(root),
              "plan": getattr(stem_fused, "last_plan", None), "rel_err": err,
              "us": cs.graph_ms(lambda: stem_fused(x6, w2, sb, **kw)) * 1e3,
              "library_us": cs.graph_ms(lambda: F.max_pool2d(
                  torch.relu(F.conv2d(xs_lib, w_lib, sb)), 3, 2, ceil_mode=True)) * 1e3}
    if result["plan"] is not None:
        result["plan"] = result["plan"]._asdict()
    print(f"[{args.tag}] stem_fused b32: {result['us']:.2f} us, cuDNN chain "
          f"{result['library_us']:.2f} us, max|err|/max|ref| {err:.2e}, plan {result['plan']}")

    if not (args.parts or args.sweep):
        print(json.dumps(result))
        return 0
    from boda_tpu_torch.ops.kernels.stem import ROUTES, plan
    p0 = plan(n, xs_h, ow, cp, kh, oc, pooled, pooled, bf)
    b32 = sb.float().contiguous()
    o = torch.empty_like(out)

    def caller(lib, p):
        def call():
            rc = lib.boda_stem(x6.data_ptr(), w2.data_ptr(), b32.data_ptr(), o.data_ptr(), n,
                               xs_h, ow, cp, kh, oc, pooled, pooled, 1, 1,
                               ROUTES.index(p.route), p.band, p.bands, p.slots,
                               torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"boda_stem {p}: error {rc}")
        return call

    if args.parts:
        out_dir = HERE / "build" / "stem_parts"
        out_dir.mkdir(parents=True, exist_ok=True)
        copy = out_dir / "stem_parts.cu"
        copy.write_text(patched_source((build.CSRC / "stem.cu").read_text()))
        procs = {}
        for var in VARIANTS:
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DSTEM_VARIANT={var}",
                   f"-I{build.CSRC}", "-shared", "-o", str(out_dir / f"stem_{var}.so"), str(copy)]
            procs[var] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True)
        parts = {}
        for var, proc in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                print(log[-4000:], file=sys.stderr)
                return 1
            lib = ctypes.CDLL(str(out_dir / f"stem_{var}.so"))
            lib.boda_stem.argtypes = build._SIGS["boda_stem"]
            call = caller(lib, p0 if not var & 512 else
                          p0._replace(band=-(-pooled // 4), bands=4, slots=5))
            call()
            torch.cuda.synchronize()
            if var & 256:  # the clocks are printed by the kernel
                continue
            e = cs.rel_err(o, ref)[1] if var in (0, 4, 128, 512) else None
            parts[VARIANTS[var]] = {"us": cs.graph_ms(call) * 1e3, "rel_err": e}
            print(f"[parts] {VARIANTS[var]}: {parts[VARIANTS[var]]['us']:.2f} us"
                  + (f", max|err|/max|ref| {e:.2e}" if e is not None else ""))
        result["parts"] = parts
    if args.sweep:
        lib = build.load().lib
        sweep = []
        for bands in (4, 8, 14, 28):
            band = -(-pooled // bands)
            for slots in (5, 6, 7, 9, 12, 16):
                p = p0._replace(band=band, bands=-(-pooled // band), slots=slots)
                try:
                    us = cs.graph_ms(caller(lib, p)) * 1e3
                except RuntimeError as e:  # a ring that does not fit
                    print(f"[sweep] {p}: {e}")
                    continue
                sweep.append({"band": p.band, "bands": p.bands, "slots": slots, "us": us})
                print(f"[sweep] band {p.band} ({p.bands * n} blocks), ring {slots}: {us:.2f} us")
        result["sweep"] = sweep
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
