#!/usr/bin/env python3
"""Where K6's time goes on its wgmma route (csrc/block.cu): the kernel at the
ResNet-50 b32 fused forward's four stage shapes, built whole and with parts
left out, each build's device µs per call in a CUDA graph on one card.

The parts are left out of a copy of block.cu, never of the shipped source:
PATCHES below put a switch ``kDrop`` into the copy (``-DBOTTLENECK_DROP``:
1 the epilogues, 2 the weight loads and their waits, 4 the wgmmas, 8/16/32
the epilogue of h1/h2/y; sums combine them), and each patch must match
block.cu exactly once, or the script stops. A build with a part left out
computes garbage; only its time is read. Each build is the copy alone,
compiled by nvcc for sm_90a into the git-ignored build/block_parts/ (all
builds started together). Prints the card's name and power limit, a line
per stage and, last, one JSON object.

    python3 scripts/torch_block_parts.py
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
DROPS = {0: "whole", 1: "no epilogues", 8: "no h1 epilogue", 16: "no h2 epilogue",
         32: "no y epilogue", 2: "no weight loads", 4: "no wgmma", 7: "none of the three"}
# (text of block.cu, what the measurement copy has in its place)
PATCHES = [
    ("constexpr int kASlots = 3;\n",
     "constexpr int kASlots = 3;\nconstexpr int kDrop = BOTTLENECK_DROP;\n"),
    ("      mbar_wait(st.bars + 8 * s, (uint32_t)(g / S) & 1);\n",
     "      if (!(kDrop & 2)) mbar_wait(st.bars + 8 * s, (uint32_t)(g / S) & 1);\n"),
    ("      st.issue_w(g + S - 1);\n", "      if (!(kDrop & 2)) st.issue_w(g + S - 1);\n"),
    ("  for (int g = 0; g < L.stages - 1; ++g) st.issue_w(g);\n",
     "  if (!(kDrop & 2))\n    for (int g = 0; g < L.stages - 1; ++g) st.issue_w(g);\n"),
    ("        boda::WgmmaRA<WN>::mma(acc, a[kk], sw128_desc(sb + kk * 2048, kBoxBytes, 1024));\n",
     "        if (!(kDrop & 4))\n"
     "          boda::WgmmaRA<WN>::mma(acc, a[kk], sw128_desc(sb + kk * 2048, kBoxBytes, 1024));\n"
     "        else  // keep the fragments' loads\n"
     "          acc[kk] += __uint_as_float(a[kk][0] ^ a[kk][3]);\n"),
    ("    if constexpr (EM::kSmem)\n      wg_emit_sm",
     "    if ((kDrop & 1) || (kDrop & (8 << p)))\n      ;\n"
     "    else if constexpr (EM::kSmem)\n      wg_emit_sm"),
]


def patched_source(src: str) -> str:
    """block.cu with the switch ``kDrop`` put in by PATCHES."""
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"torch_block_parts: block.cu no longer matches the patch {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_block_parts: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import PATH_CODES
    from boda_tpu_torch.rtc.backends import graph_time
    sys.path.insert(0, str(HERE / "scripts"))
    from torch_block_stages import NAMES, STAGES

    out_dir = HERE / "build" / "block_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    copy = out_dir / "block_parts.cu"
    copy.write_text(patched_source((build.CSRC / "block.cu").read_text()))
    procs = {}
    for drop in DROPS:
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DBOTTLENECK_DROP={drop}", f"-I{build.CSRC}",
               "-shared", "-o", str(out_dir / f"block_{drop}.so"), str(copy)]
        procs[drop] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for drop, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-4000:], file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(out_dir / f"block_{drop}.so"))
        lib.boda_bottleneck.argtypes = build._SIGS["boda_bottleneck"]
        libs[drop] = lib
    card = cs.smi()
    print(card)
    dev, bf = torch.device("cuda"), torch.bfloat16
    rng = np.random.default_rng(0)

    def rnd(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev, bf)

    result = {}
    for (n, h, c, k), count in STAGES.items():
        ops = (rnd((n, h, h, c)), rnd((c, k), c ** -0.5), rnd((k,), 0.1),
               rnd((3, 3, k, k), (9 * k) ** -0.5), rnd((k,), 0.1), rnd((k, c), k ** -0.5),
               rnd((c,), 0.1))
        out = torch.empty_like(ops[0])
        row = {}
        for drop, lib in libs.items():
            def call(lib=lib):
                rc = lib.boda_bottleneck(*(t.data_ptr() for t in ops), out.data_ptr(), n, h, h,
                                         c, k, 1, PATH_CODES["wgmma"], None,
                                         torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"boda_bottleneck: error {rc}")
            row[DROPS[drop]] = graph_time(call) * 1e6
        result[NAMES[h]] = {"count": count, "us": row}
        print(f"{NAMES[h]} {(n, h, c, k)} x{count}: " +
              ", ".join(f"{name} {us:.1f} us" for name, us in row.items()))
    print(json.dumps({"card": card, "stages": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
