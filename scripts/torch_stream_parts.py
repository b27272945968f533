#!/usr/bin/env python3
"""What holds K9's ring (csrc/eltwise.cu) and K8's rows route (csrc/pool.cu)
back: each built whole and with one choice of its design undone, each
build's device µs per call in a CUDA graph on one card, at the b32 bf16 add
(32x256x56x56) and at pool1 (3x3 s2 max over 32x112x112x64).

The choices are undone in a copy of each source, never in the shipped one:
PATCHES below put a switch ``kVar`` into the copy (``-DSTREAM_VARIANT``, bits
that combine): 1 loads under the L2 evict-normal policy in place of
evict-first; 2 (K9) plain 16-byte stores in place of st.global.cs; 4 (K9)
one contiguous span of the array per block in place of the stage-sized
chunks dealt to the blocks in turn; 8 (K9) the consumers load from global
memory themselves, no bulk copies; 16 (K8) loads under evict-last; 32 (K9)
the results written over a's stage and stored by one bulk copy
(cp.async.bulk.global.shared::cta); 128 (K9) no ring at all: the same
chunks, each loaded by its block's threads with 4 16-byte loads of a and
of b in flight per thread; 256 (K9) each stage's copies cut into 4 KB
pieces; 512 (K9) the copies without an L2 cache hint. Each patch must
match its source
exactly once, or the script stops. Each build is the copy alone, compiled by nvcc for sm_90a into
the git-ignored build/stream_parts/ (all builds started together), and
called through its C entry point with the plans of ops/kernels/
{elementwise,pool}.py. Every build's output is held against the plain
version (K9 bit for bit, the max pool exact). Prints the card's name and
power limit, a line per build and plan and, last, one JSON object.

    python3 scripts/torch_stream_parts.py
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ELT_VARIANTS = {0: "shipped", 1: "evict-normal loads", 2: "plain stores",
                4: "one contiguous span per block", 8: "no bulk copies",
                32: "bulk stores from the stage", 128: "no ring: 4 loads in flight a thread",
                256: "copies of 4 KB", 512: "copies without an L2 hint"}
POOL_VARIANTS = {0: "shipped", 1: "evict-normal loads", 16: "evict-last loads"}
KVAR = "constexpr int kVar = STREAM_VARIANT;\n"
# variant 128: the ring's chunks dealt alike, each loaded by its block's 256
# threads themselves, 4 units of a and of b per thread in flight, no shared
# memory (a stage of 1,024 units)
LDG_KERNEL = r"""
template <typename T, int F>
__global__ void __launch_bounds__(256)
    eltwise_ldg(const T* a, const T* b, T* out, long long n, int su) {
  constexpr bool kBinary = F >= kMul;
  constexpr int kVec = 16 / sizeof(T);
  union Pack {
    uint4 u;
    T e[kVec];
  };
  const long long units = n / kVec;
  const int tid = threadIdx.x;
  for (long long c0 = (long long)blockIdx.x * su; c0 < units; c0 += (long long)gridDim.x * su) {
    uint4 va[4], vb[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long u = c0 + tid + k * 256;
      if (u < units && tid + k * 256 < su) {
        va[k] = __ldg((const uint4*)a + u);
        if (kBinary) vb[k] = __ldg((const uint4*)b + u);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long u = c0 + tid + k * 256;
      if (u < units && tid + k * 256 < su) {
        Pack pa, pb, po;
        pa.u = va[k];
        pb.u = vb[k];
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          po.e[e] = from_f32<T>(apply<F>(to_f32(pa.e[e]), kBinary ? to_f32(pb.e[e]) : 0.f));
        st_cs((uint4*)out + u, po.u);
      }
    }
  }
  if (blockIdx.x == 0)
    for (long long j = units * kVec + tid; j < n; j += 256) out[j] = elt<T, F>(a, b, j);
}

"""
PATCHES = {
    "eltwise.cu": [
        ("constexpr int kMaxSmem = 232448;\n", "constexpr int kMaxSmem = 232448;\n" + KVAR),
        ("      const uint64_t policy = boda::l2_evict_first();\n",
         "      uint64_t policy = boda::l2_evict_first();\n"
         "      if (kVar & 1)\n"
         "        asm volatile(\"createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\\n\""
         " : \"=l\"(policy));\n"),
        ("      st_cs(o + u, po.u);\n",
         "      if (kVar & 32) ((uint4*)sa)[u] = po.u;\n"
         "      else if (kVar & 2) o[u] = po.u; else st_cs(o + u, po.u);\n"),
        ("    __syncwarp();\n    if ((tid & 31) == 0) boda::mbar_arrive(bars + 64 + 8 * s);\n",
         "    if (kVar & 32) {\n"
         "      boda::fence_proxy_async();\n"
         "      boda::named_bar_sync(1, kConsumers);\n"
         "      if (tid == 0) {\n"
         "        asm volatile(\"cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n\""
         " :: \"l\"(o), \"r\"(boda::smem_u32(sa)), \"r\"(cnt * 16) : \"memory\");\n"
         "        boda::bulk_commit();\n"
         "        boda::bulk_wait<true>();\n"
         "      }\n"
         "    }\n"
         "    __syncwarp();\n    if ((tid & 31) == 0) boda::mbar_arrive(bars + 64 + 8 * s);\n"),
        ("  if (blockIdx.x == 0)\n    for (long long j",
         "  if ((kVar & 32) && tid == 0) boda::bulk_wait<false>();\n"
         "  if (blockIdx.x == 0)\n    for (long long j"),
        ("template <typename T, int F>\n__global__ void __launch_bounds__(256)\n    eltwise_scalar(",
         LDG_KERNEL + "template <typename T, int F>\n__global__ void __launch_bounds__(256)\n"
         "    eltwise_scalar("),
        ("  if (path == kScalar) {\n",
         "  if (kVar & 128) {\n"
         "    eltwise_ldg<T, F><<<blocks, 256, 0, s>>>((const T*)a, (const T*)b, (T*)out, n,\n"
         "                                            stage_bytes / 16);\n"
         "    return (int)cudaGetLastError();\n"
         "  }\n"
         "  if (path == kScalar) {\n"),
        ("  const long long nst =\n"
         "      (long long)blockIdx.x < chunks ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;\n"
         "  auto first = [&](long long it) { return (it * gridDim.x + blockIdx.x) * su; };\n"
         "  auto count = [&](long long it) { return (int)min((long long)su, units - first(it)); };\n",
         "  const long long q = units / gridDim.x, r = units % gridDim.x;\n"
         "  const long long u0 = (long long)blockIdx.x * q + min((long long)blockIdx.x, r);\n"
         "  const long long len = q + ((long long)blockIdx.x < r ? 1 : 0);\n"
         "  const long long nst = (kVar & 4) ? (len + su - 1) / su : ((long long)blockIdx.x < chunks\n"
         "      ? (chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0);\n"
         "  auto first = [&](long long it) {\n"
         "    return (kVar & 4) ? u0 + it * su : (it * gridDim.x + blockIdx.x) * su; };\n"
         "  auto count = [&](long long it) {\n"
         "    return (int)min((long long)su, (kVar & 4) ? len - it * su : units - first(it)); };\n"),
        ("    if (tid == kConsumers) {", "    if (tid == kConsumers && !(kVar & 8)) {"),
        ("        boda::bulk_load_1d(dst, (const uint4*)a + off, bytes, bars + 8 * s, policy);\n"
         "        if (kBinary)\n"
         "          boda::bulk_load_1d(dst + stage_bytes, (const uint4*)b + off, bytes, bars + 8 * s,\n"
         "                             policy);\n",
         "        if (kVar & (256 | 512)) {\n"
         "          const uint32_t piece = (kVar & 256) ? 4096 : bytes;\n"
         "          for (uint32_t o = 0; o < bytes; o += piece) {\n"
         "            const uint32_t nb = min(piece, bytes - o);\n"
         "            for (int op = 0; op < (kBinary ? 2 : 1); ++op) {\n"
         "              const char* src = (const char*)((const uint4*)(op ? b : a) + off) + o;\n"
         "              const uint32_t d = dst + op * stage_bytes + o;\n"
         "              if (kVar & 512)\n"
         "                asm volatile(\"cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes\"\n"
         "                             \" [%0], [%1], %2, [%3];\\n\" :: \"r\"(d), \"l\"(src), \"r\"(nb),\n"
         "                             \"r\"(bars + 8 * s) : \"memory\");\n"
         "              else\n"
         "                boda::bulk_load_1d(d, src, nb, bars + 8 * s, policy);\n"
         "            }\n"
         "          }\n"
         "        } else {\n"
         "        boda::bulk_load_1d(dst, (const uint4*)a + off, bytes, bars + 8 * s, policy);\n"
         "        if (kBinary)\n"
         "          boda::bulk_load_1d(dst + stage_bytes, (const uint4*)b + off, bytes, bars + 8 * s,\n"
         "                             policy);\n"
         "        }\n"),
        ("    boda::mbar_wait(bars + 8 * s, (uint32_t)((it / stages) & 1));\n",
         "    if (!(kVar & 8)) boda::mbar_wait(bars + 8 * s, (uint32_t)((it / stages) & 1));\n"),
        ("      pa.u = sa[u];\n      if (kBinary) pb.u = sb[u];\n",
         "      if (kVar & 8) {\n"
         "        pa.u = __ldg((const uint4*)a + first(it) + u);\n"
         "        if (kBinary) pb.u = __ldg((const uint4*)b + first(it) + u);\n"
         "      } else {\n"
         "        pa.u = sa[u];\n        if (kBinary) pb.u = sb[u];\n      }\n"),
    ],
    "pool.cu": [
        ("constexpr int kThreads = 256;\n", "constexpr int kThreads = 256;\n" + KVAR),
        ("    policy = boda::l2_evict_first();\n",
         "    policy = boda::l2_evict_first();\n"
         "    if (kVar & 1)\n"
         "      asm volatile(\"createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\\n\""
         " : \"=l\"(policy));\n"
         "    if (kVar & 16)\n"
         "      asm volatile(\"createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\\n\""
         " : \"=l\"(policy));\n"),
    ],
}


def patched_source(name: str, src: str) -> str:
    for old, new in PATCHES[name]:
        if src.count(old) != 1:
            raise SystemExit(f"torch_stream_parts: {name} no longer matches the patch {old!r}")
        src = src.replace(old, new)
    return src


def main() -> int:
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_stream_parts: needs a CUDA card", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers", HERE / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels import elementwise as elt
    from boda_tpu_torch.ops.kernels import pool as pl
    from boda_tpu_torch.rtc.backends import graph_time

    out_dir = HERE / "build" / "stream_parts"
    out_dir.mkdir(parents=True, exist_ok=True)
    builds, procs = {}, []
    for name, variants in (("eltwise.cu", ELT_VARIANTS), ("pool.cu", POOL_VARIANTS)):
        src = patched_source(name, (build.CSRC / name).read_text())
        copy = out_dir / f"{Path(name).stem}_parts.cu"
        copy.write_text(src)
        for v in variants:
            so = out_dir / f"{Path(name).stem}_{v}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DSTREAM_VARIANT={v}",
                   f"-I{build.CSRC}", "-shared", "-o", str(so), str(copy)]
            procs.append((name, v, so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                        stderr=subprocess.STDOUT, text=True)))
    for name, v, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"torch_stream_parts: nvcc failed on {name} variant {v}:\n{log}",
                  file=sys.stderr)
            return 1
        lib = ctypes.CDLL(str(so))
        fn = lib.boda_eltwise if name == "eltwise.cu" else lib.boda_pool2d
        fn.argtypes = build._SIGS[fn.__name__]
        fn.restype = ctypes.c_int
        builds[name, v] = fn

    dev, bf = torch.device("cuda"), torch.bfloat16
    card = cs.smi()
    print(card)
    rng = np.random.default_rng(0)

    def rnd(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev, bf)

    res = {}
    stream = lambda t: build.stream_ptr(t)  # noqa: E731
    n = cs.BATCH * 256 * 56 * 56
    a, b = rnd((n,)), rnd((n,))
    ref = elt.eltwise_plain("add", a, b)
    bound = 3 * n * 2 / cs.HBM_BPS * 1e3
    for blocks in (264, 132):
        p = elt.plan(n, bf, True)._replace(blocks=blocks)
        for v, what in ELT_VARIANTS.items():
            fn = builds["eltwise.cu", v]

            def call(fn=fn, p=p):
                out = torch.empty_like(a)
                rc = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, elt.FUNC_CODES["add"],
                        elt.ELT_DTYPES[bf], elt.PATHS.index(p.path), p.blocks, p.stage_bytes,
                        p.stages, stream(a))
                build.check(rc, f"eltwise variant {v}")
                return out
            out = call()
            torch.cuda.synchronize()
            if not torch.equal(cs.bits(out), cs.bits(ref)):
                print(f"torch_stream_parts: eltwise variant {v} not bit-equal", file=sys.stderr)
                return 1
            ms = graph_time(call) * 1e3
            res[f"eltwise {blocks} blocks {what}"] = ms
            print(f"[eltwise add b32] {blocks} blocks, {what}: {ms * 1e3:.2f} us device "
                  f"({bound / ms * 100:.1f}% of the {bound * 1e3:.2f} us bound)")
    ms = graph_time(lambda: torch.add(a, b)) * 1e3
    res["torch.add"] = ms
    print(f"[eltwise add b32] torch.add: {ms * 1e3:.2f} us device")
    del a, b, ref

    nb, h, c, k, s, oy = 32, 112, 64, 3, 2, 56
    x = rnd((nb, h, h, c))
    pad = (0, (oy - 1) * s + k - h)
    geom = ((k, k), (s, s), pad, pad, oy, oy, False)
    ref = pl.pool2d_plain(x, *geom)
    bound = max(cs.work("pool", (nb, h, c, k, s, oy, False)))
    plans = [pl.rows_plan(nb, h, c, (k, k), oy, oy, False, slots) for slots in (6, 3)]
    plans.append(pl.plan(nb, h, h, c, (k, k), (s, s), oy, oy, False, torch.float32))
    for p in plans:
        params = (0, 0) if p.route == "thread" else (p.blocks, p.slots)
        for v, what in POOL_VARIANTS.items():
            if p.route == "thread" and v:
                continue
            fn = builds["pool.cu", v]

            def call(fn=fn, params=params, p=p):
                out = torch.empty_like(ref)
                rc = fn(x.data_ptr(), out.data_ptr(), nb, h, h, c, oy, oy, k, k, s, s, 0, 0, 0,
                        1, pl.ROUTES.index(p.route), *params, stream(x))
                build.check(rc, f"pool variant {v}")
                return out
            out = call()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                print(f"torch_stream_parts: pool variant {v} {p} not exact", file=sys.stderr)
                return 1
            ms = graph_time(call) * 1e3
            key = f"pool1 {cs.pool_plan_str(p)}, {what}"
            res[key] = ms
            print(f"[pool1] {key}: {ms * 1e3:.2f} us device ({bound / ms * 100:.1f}% of the "
                  f"{bound * 1e3:.2f} us bound)")
    print(json.dumps({"card": card, "device_ms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
