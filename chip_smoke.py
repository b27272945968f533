#!/usr/bin/env python3
"""Smoke run of boda_tpu_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from boda_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes of the ResNet-50 batch-32
forward, then runs that forward (bf16, 224x224, kernel_policy=gen) through
the kernels and checks it against the library path (kernel_policy=lib,
cuDNN/cuBLAS) and an f32 reference. Prints per-phase lines, one JSON line
describing each kernel, the card's name and power limit, and as its last
line {"ok": true, "device": {...}}. Any failure raises (exit code != 0).

    python3 chip_smoke.py        # from the repo root; needs a CUDA card and nvcc
"""

from __future__ import annotations

import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import torch

BATCH = 32
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16 forward, gen vs lib: both round every activation to bf16 but at
# slightly different points (cuDNN adds the residual after its own bf16
# store), and the differences compound over 50 layers
SLICE_TOL = {"fc1000": 5e-2, "prob": 5e-2}
# f32, small input, gen vs lib per conv node: cuDNN may pick Winograd/FFT
# algorithms whose f32 error is ~1e-5 of the output scale
F32_NODE_TOL = 1e-4


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True, text=True,
                       timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def rel_err(out, ref) -> tuple[float, float]:
    d = float((out.float() - ref.float()).abs().max())
    return d, d / max(float(ref.float().abs().max()), 1e-30)


def layer_shapes(pipe, eng):
    """The GEMM and direct-conv calls one forward makes, from the engine's
    own dispatch: {signature: count} for each kernel."""
    from boda_tpu_torch.ops.kernels.conv import out_size
    gemm, conv = {}, {}
    log = eng.get_info_log().splitlines()
    k1 = {ln.split(":")[0] for ln in log if "nhwc-k1conv" in ln or "nhwc-ip gemm" in ln}
    direct = {ln.split(":")[0] for ln in log if "nhwc-direct_conv" in ln}
    for name, op in pipe.ops.items():
        if name not in k1 | direct:
            continue
        chain = [pipe.ops[c].type for c in eng._chains.get(name, [])]
        res, relu = "Eltwise" in chain, "ReLU" in chain
        ind = pipe.must_dims(op.bots[0])
        if op.type == "InnerProduct":
            fd = pipe.must_dims(op.bots[1])
            sig = (ind["img"], fd["in_feats"], fd["out_chan"], res, relu)
            gemm[sig] = gemm.get(sig, 0) + 1
            continue
        fd = pipe.must_dims(op.bots[1])
        k, s, p = op.kern_sz(), op.stride(), op.pad()
        if name in k1:
            oh, ow = out_size(ind["y"], ind["x"], 1, 1, s, (0, 0))
            sig = (ind["img"] * oh * ow, fd["in_chan"], fd["out_chan"], res, relu)
            gemm[sig] = gemm.get(sig, 0) + 1
        else:
            sig = (ind["img"], ind["y"], fd["in_chan"], fd["out_chan"], k[0], s[0],
                   p[0], res, relu)
            conv[sig] = conv.get(sig, 0) + 1
    return gemm, conv


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from boda_tpu_torch import cli
    from boda_tpu_torch.config import make
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.conv import conv2d, conv2d_plain
    from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    card = smi()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device_count {torch.cuda.device_count()}")

    # -- phase 1: build ---------------------------------------------------------
    kb = build.load()
    print(f"[build] nvcc sm_90a -> {kb.path.relative_to(build.BUILD_DIR.parents[1])}: "
          + (f"built in {kb.build_secs:.1f}s" if kb.build_secs else
             "reused (same source hash)"))
    for ln in kb.log.splitlines():
        if "registers" in ln or ("spill" in ln and " 0 bytes spill stores" not in ln):
            print(f"[build]   {ln.strip()}")

    # -- phase 2: each kernel vs its plain version --------------------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, dt, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    def gemm_case(M, K, N, res, relu, dt):
        a, b = rnd((M, K), dt), rnd((K, N), dt, K ** -0.5)
        bias, r = rnd((N,), dt, 0.1), (rnd((M, N), dt) if res else None)
        out = matmul(a, b, bias, relu=relu, residual=r)
        ref = matmul_plain(a, b, bias, relu=relu, residual=r)

        def lib():
            o = torch.addmm(bias, a, b)
            o = o + r if r is not None else o
            return torch.relu(o) if relu else o
        return out, ref, (lambda: matmul(a, b, bias, relu=relu, residual=r),
                          lambda: matmul_plain(a, b, bias, relu=relu, residual=r), lib)

    def conv_case(n, h, c, oc, k, s, p, res, relu, dt):
        x, w = rnd((n, h, h, c), dt), rnd((k, k, c, oc), dt, (k * k * c) ** -0.5)
        bias = rnd((oc,), dt, 0.1)
        oh = (h + 2 * p - k) // s + 1
        r = rnd((n, oh, oh, oc), dt) if res else None
        kw = dict(stride=(s, s), pad=(p, p), relu=relu, residual=r)
        out, ref = conv2d(x, w, bias, **kw), conv2d_plain(x, w, bias, **kw)
        w_lib = w.permute(3, 0, 1, 2).contiguous()  # OHWI: channels_last OIHW view

        def lib():
            o = F.conv2d(x.permute(0, 3, 1, 2), w_lib.permute(0, 3, 1, 2), bias,
                         stride=s, padding=p).permute(0, 2, 3, 1)
            o = o + r if r is not None else o
            return torch.relu(o) if relu else o
        return out, ref, (lambda: conv2d(x, w, bias, **kw),
                          lambda: conv2d_plain(x, w, bias, **kw), lib)

    pipe, in_dims = load_net("resnet50", BATCH)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    gemm_shapes, conv_shapes = layer_shapes(pipe, eng)
    summary = {}
    for kname, case, shapes, extra in (
            ("sgemm", gemm_case, gemm_shapes,
             [((77, 147, 100, True, True), 1), ((32, 2048, 1000, False, False), 1)]),
            ("conv", conv_case, conv_shapes,
             [((2, 13, 3, 20, 7, 2, 3, False, True), 1),
              ((2, 9, 24, 40, 3, 1, 1, True, True), 1),
              ((1, 11, 16, 136, 3, 2, 1, False, False), 1)])):
        tot = dict(ms=0.0, plain_ms=0.0, lib_ms=0.0, max_abs_err=0.0, max_rel_err=0.0)
        print(f"[{kname}] shape -> max|err|/max|ref|, kernel ms, plain f32 ms, "
              f"bf16 library ms, count per forward ({card})")
        for dt, cases in ((torch.float32, extra), (torch.bfloat16, list(shapes.items()))):
            for sig, count in cases:
                out, ref, (fk, fp, fl) = case(*sig, dt)
                torch.cuda.synchronize()
                ae, re = rel_err(out, ref)
                check(bool(torch.isfinite(out.float()).all()), f"{kname} {sig} non-finite")
                check(re <= TOL[dt], f"{kname} {sig} {dt}: rel err {re:.3g} > {TOL[dt]}")
                if dt == torch.bfloat16:
                    ms, pms, lms = cuda_ms(fk), cuda_ms(fp), cuda_ms(fl)
                    tot["ms"] += ms * count
                    tot["plain_ms"] += pms * count
                    tot["lib_ms"] += lms * count
                    tot["max_abs_err"] = max(tot["max_abs_err"], ae)
                    tot["max_rel_err"] = max(tot["max_rel_err"], re)
                    print(f"[{kname}] bf16 {sig}: {re:.2e} {ms:.4f} {pms:.4f} {lms:.4f} x{count}")
                else:
                    print(f"[{kname}] f32 {sig}: {re:.2e} (tol {TOL[dt]})")
                del out, ref
        print(f"[{kname}] per forward: kernel {tot['ms']:.3f} ms, plain f32 "
              f"{tot['plain_ms']:.3f} ms, bf16 library {tot['lib_ms']:.3f} ms")
        summary[kname] = tot

    # -- phase 3: the slice: ResNet-50 b32 bf16 through the kernels -----------------
    ins = gen_data_inputs(in_dims)
    log = eng.get_info_log().splitlines()
    n_gemm = len({ln.split(":")[0] for ln in log
                  if "nhwc-k1conv" in ln or "nhwc-ip gemm" in ln})
    n_conv = len({ln.split(":")[0] for ln in log if "nhwc-direct_conv" in ln})
    check(not any("nhwc-lib_conv" in ln for ln in log), "a conv went to the library")
    matmul.launches = conv2d.launches = 0
    outs = eng.run_fwd(ins, ["prob", "fc1000"])
    launches = {"sgemm": matmul.launches, "conv": conv2d.launches}
    print(f"[slice] resnet50 b{BATCH} bf16 gen: launches sgemm {launches['sgemm']} "
          f"(layers {n_gemm}), conv {launches['conv']} (layers {n_conv})")
    check(launches["sgemm"] >= n_gemm > 0, "sgemm launch count below its layers")
    check(launches["conv"] >= n_conv > 0, "conv launch count below its layers")
    prob = outs["prob"].data
    check(prob.shape == (BATCH, 1000) and bool(np.isfinite(prob).all()), "prob shape/finite")
    sums = prob.sum(axis=1)
    check(bool(((sums > 0.99) & (sums < 1.01)).all()), f"prob row sums {sums.min()}..{sums.max()}")

    lib = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib")
    lib.init(pipe)
    louts = lib.run_fwd(ins, ["prob", "fc1000"])
    f32 = make("conv_fwd", "cuda", kernel_policy="lib")
    f32.init(pipe)
    fouts = f32.run_fwd(ins, ["prob", "fc1000"])
    for n in ("fc1000", "prob"):
        a, b, c = (torch.from_numpy(o[n].data) for o in (outs, louts, fouts))
        _, e_lib = rel_err(a, b)
        _, e_f32 = rel_err(a, c)
        _, e_lib_f32 = rel_err(b, c)
        print(f"[slice] {n}: gen vs lib {e_lib:.3e} (tol {SLICE_TOL[n]}); vs f32 "
              f"gen {e_f32:.3e}, lib {e_lib_f32:.3e} (max|err|/max|ref|)")
        check(e_lib <= SLICE_TOL[n], f"{n} gen vs lib {e_lib:.3g}")
    top_gen = np.argmax(outs["prob"].data, axis=1)
    top_lib = np.argmax(louts["prob"].data, axis=1)
    print(f"[slice] top-1 agreement gen vs lib: {float(np.mean(top_gen == top_lib)):.3f}")
    del f32

    # f32 at a small input, every conv node: gen kernels vs cuDNN (TF32 off)
    spipe, sdims = load_net("resnet50", 2, 64)
    sins = gen_data_inputs(sdims)
    nodes = ["prob"] + [o.tops[0] for o in spipe.ops.values() if o.type == "Convolution"]
    res = {}
    for pol in ("gen", "lib"):
        e = make("conv_fwd", "cuda", kernel_policy=pol)
        e.init(spipe)
        res[pol] = e.run_fwd(sins, nodes)
    worst = max(rel_err(torch.from_numpy(res["gen"][n].data),
                        torch.from_numpy(res["lib"][n].data))[1] for n in nodes)
    print(f"[slice] f32 resnet50 b2 64x64, {len(nodes)} nodes gen vs lib: "
          f"worst {worst:.3e} (tol {F32_NODE_TOL})")
    check(worst <= F32_NODE_TOL, "f32 per-node gen vs lib")

    # the user's command line, in-process
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["run_cnet", "--model=resnet50", f"--img={BATCH}",
                       "--conv-fwd=(mode=cuda,compute_tn=bfloat16)", "--n-iters=10"])
    lines = buf.getvalue().splitlines()
    print(f"[run_cnet] rc={rc}: {lines[0] if lines else ''}")
    print(f"[run_cnet] {next((ln for ln in lines if ln.startswith('{')), '')}")
    check(rc == 0, "run_cnet failed")

    rates = {}
    for pol in ("gen", "lib"):
        e = eng if pol == "gen" else lib
        secs = e.time_fwd(ins, ["prob"], n_iters=20, warmup=5)
        rates[pol] = BATCH / secs
        print(f"[slice] resnet50 b{BATCH} bf16 {pol}: {secs * 1e3:.3f} ms/fwd, "
              f"{rates[pol]:.1f} img/s ({card})")

    kernels = []
    for kname, src, rep in (("sgemm", "boda_tpu_torch/csrc/sgemm.cu",
                             "boda_tpu/ops/kernels/sgemm.py:80"),
                            ("conv", "boda_tpu_torch/csrc/conv.cu",
                             "boda_tpu/ops/kernels/conv.py:575")):
        t = summary[kname]
        entry = {"name": kname, "route": "cuda", "source": src, "replaces": rep,
                 "launches": launches[kname], "max_abs_err": t["max_abs_err"],
                 "ms": t["ms"], "plain_ms": t["plain_ms"], "lib_ms": t["lib_ms"],
                 "max_rel_err": t["max_rel_err"]}
        if kname == "conv":
            entry["also_replaces"] = "boda_tpu/ops/kernels/conv.py:103"
        kernels.append(entry)
    print(json.dumps({"kernels": kernels, "img_per_s": rates, "card": card}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
