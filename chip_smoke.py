#!/usr/bin/env python3
"""Smoke run of boda_tpu_torch on one NVIDIA GPU.

Builds the hand-written CUDA kernels from boda_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes of the ResNet-50 batch-32
forward and backward (the GEMM and the direct conv at the forward shapes;
the conv again at the 46 dgrad shapes; the leading-axis GEMM at the 46
wgrad shapes; the bottleneck, the pooling kernel and the space-to-depth
conv at the fused forward's shapes), then drives three paths through the
kernels:

* the forward (bf16, b32, 224x224, kernel_policy=gen), checked against the
  library path (kernel_policy=lib, cuDNN/cuBLAS) and an f32 reference;
* the same forward in its fused configuration (fuse_block=1,
  tune=(use_s2d=1,pool_pallas=1): each identity bottleneck one kernel, the
  pools on the pooling kernel, the stem on the space-to-depth fold), checked
  against lib and gen, and at f32 node by node against lib;
* the graph-level backward (add_bck_ops): f32 at b8, every node gen vs lib
  under test_compute's own rule; bf16 at b32, the loss, the input gradient
  and every weight gradient gen vs lib, timed per policy; and the user's
  ``test_compute --add-bck-ops=1`` command line, in process;
* the rtc layer and its autotuning loop, in process through the CLI:
  ``rtc_test`` and ``sgemm_run`` on ``be=cuda``, the ResNet-50 b32 bf16
  op corpus (``gen_prof_ops``, plus the largest residual add as an
  ``eltwise`` op) profiled by ``ops_prof`` into a wisdom file, ``wis_ana``
  on it, and ``run_cnet`` reading it back through the engine's
  ``wisdom_fn``, checked against the library path.

Every engine runs as a user's does, under ``cuda_graph=1``: each forward
(and gradient graph) is captured once per key after one eager warm-up
forward, and replayed. The graph phases hold that capture to the eager
forward of the same engine (``cuda_graph=0``): [graph] the gen, lib and
fused b32 forwards (gen and fused bit-equal, lib within the bf16 gate, the
same launches, eager against graph ms and img/s, the capture's time and
peak memory); [graph-grad] the b32 bf16 gradient graph, gen and lib, every
output bit-equal under cuDNN's deterministic algorithms. In both, a second
batch of the same key goes through the same graph and must follow its
input as the eager forward does. Then [input_s2d] bench.py's configuration
(the batch folded on the host to the stem's space-to-depth layout,
``input_s2d=1``, ``input_pad_c`` 0 and 16, gen and lib) against the
unfolded forward: fc1000 and prob, and conv1 itself within 1e-2; under gen
the stem's K3 call on wgmma at the fold's shape against its plain version
on the engine's own operands; [stats] ``per_layer_stats`` and
``quantize`` on the card against the same engine on the CPU; [run_cnet]
``run_cnet --per-layer-fn`` (each op's lowering alone, timed in a CUDA
graph).

The elementwise kernel (K9) is held bit for bit against its plain version
for every func and dtype on both its paths (the b32 add must take the
ring), and the fused stem kernel (K7, on no path: no engine routes to it,
as in boda_tpu) against its plain version at the b32 stem, bf16 on its
mma route and f32 on fma. The nan phase plants NaN in small inputs of
every kernel with a ReLU or a max, on each of its paths (NAN_CASES), and
holds each against its plain version with NaN compared equal, as
boda_tpu's jnp.maximum propagates it.

Each path is run with the kernels' launch counts set to 0 just before it
and read just after: after the engine's warm-up (``prepare``), so that the
counts are those of the captured forward, which every replay launches. The
GEMM core (K1, K2/K3) and K5 also count their launches per path of their
plans: every b32 bf16 GEMM and conv of the gen and fused forwards, all 46
dgrads and all 46 wgrads must take the wgmma path, the gen forward's C = 3
stem alone the mma.sync loop; K6 counts its routes (bottleneck.paths), and
all 12 bottlenecks of the fused b32 forward must take its wgmma route; K8
counts its routes (pool2d.paths): the fused b32 forward's pool1 must take
rows, its pool5 window. fc1000's weights are scaled in every ResNet-50
pipe (scale_fc1000), so that prob is not one-hot and the forward's prob
gates compare something.

Prints per-phase lines, one JSON line describing each kernel (its time per
pass beside its bound: the larger of its bytes over HBM's 3.35 TB/s and its
operations over the peak rate of their type, from NVIDIA's H100 SXM data
sheet; for every kernel and its library call the time is the device time
of 20 calls captured in one CUDA graph, the median of 3 replays
(rtc/backends.py graph_time), since back-to-back launches of them time the
host; those launches are kept beside it as launch_ms), the card's name and
power limit, and as its last line
{"ok": true, "device": {...}}. Any failure raises (exit code != 0).

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
GRAD_F32_BATCH = 8
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# bf16 forward, gen vs lib: both round every activation to bf16 but at
# slightly different points (cuDNN adds the residual after its own bf16
# store), and the differences compound over 50 layers
SLICE_TOL = {"fc1000": 5e-2, "prob": 5e-2}
# f32, small input, gen vs lib per conv node: cuDNN may pick Winograd/FFT
# algorithms whose f32 error is ~1e-5 of the output scale
F32_NODE_TOL = 1e-4
# f32 gradient graph, every node gen vs lib: test_compute's rule at the
# gradient tolerance of testdata/test_all.xml:9-16, comp_vars(mrd_toler,
# atol=mrd_toler * max|lib|)
GRAD_F32_TOL = 1e-3
# bf16 gradient graph, max|err|/max|lib| per gradient, gen vs lib
GRAD_BF16_TOL = 5e-2
FUSED_TUNE = "(use_s2d=1,pool_pallas=1)"
# [input_s2d], bf16 b32: the stem on its fold (K3's entry on wgmma) against
# its plain version on the same operands, and the folded forward's conv1
# against the unfolded one's, max|err|/max|ref|: the two differ by the bf16
# rounding of the stores (one ulp is 2^-8 of a value), not by 50 layers
STEM_FOLD_TOL = 1e-2
# [stats]: the card's var_stats against the CPU's, f32 (min, max and sum_sq
# relative to themselves, the sum to sqrt(cnt * sum_sq), which bounds
# sum|x|); conv1 quantized to 4 bits of [0, 2]: equal or one quantum apart
STATS_TOL = 1e-3
STATS_QUANT = "(conv1=(max_val=2,keep_bits=4))"
STATS_QUANT_STEP = 2 / 16
# the fused b32 forward's launches per kernel: 12 identity bottlenecks; pool1
# and pool5; the stem (on the fold) and the 4 downsampling blocks' 3x3s; the
# 12 1x1s outside blocks and fc1000; the stem's fold
FUSED_LAUNCHES = {"block": 12, "pool": 2, "conv": 5, "sgemm": 13, "s2d": 1}
# K8's routes in the fused b32 forward: pool1 (3x3 s2 max) on rows, pool5 (7x7
# avg) on window
FUSED_POOL_PATHS = {"thread": 0, "rows": 1, "window": 1}
POOL_B32_ROUTES = {(BATCH, 112, 64, 3, 2, 56, False): "rows",
                   (BATCH, 7, 2048, 7, 1, 1, True): "window"}
# ops_prof's cross-tune check on the bf16 corpus: the kernel gates' 1e-2 (one
# bf16 rounding is 2^-8 of a value), per element, with its own atol of 1e-4
# of max|kg|
RTC_MRD_TOLER = 1e-2
RTC_TUNES = "(kg=(use_xla=1),gen=(),s2d=(use_s2d=1))"
ELT_FUNCS = ("relu", "copy", "neg", "mul", "add", "sub", "max")
# the nan phase: a NaN planted in small inputs of every kernel with a ReLU or
# a max (K1 with ReLU and a residual, K2/K3 with ReLU, K6, K7, K8's max), on
# each path of each; "<kernel> <path>" (nan_case)
NAN_CASES = ("sgemm wgmma", "sgemm wgmma split-K", "sgemm mma", "sgemm fma",
             "conv wgmma", "conv_nhwc wgmma split-K", "conv mma", "conv fma",
             "block wgmma", "block mma", "block fma", "stem mma", "stem fma",
             "pool rows", "pool window", "pool thread")
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM bytes/s, bf16 tensor-core
# and f32 FMA operations/s
HBM_BPS, BF16_OPS, F32_OPS = 3.35e12, 989e12, 67e12


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


def other_batch(ins: dict, seed: int) -> dict:
    """A second batch of the same shapes and dtypes: the data drawn from a
    seeded normal at the first batch's mean and spread, the labels rolled by
    one image. A replay fed it must follow it, as an eager forward does."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in ins.items():
        a = v.data
        b = np.roll(a, 1, axis=0) if k == "label" else \
            (rng.standard_normal(a.shape) * a.std() + a.mean()).astype(a.dtype)
        out[k] = type(v)(v.dims, b)
    return out


def replay_follows(e, ins: dict, outs: list[str]) -> tuple[dict, dict]:
    """Feed the engine's captured forward a second batch of its key: eager
    (cuda_graph=0) and replay outputs of that batch, after checking that no
    new graph was captured for it."""
    g = e._graph
    e.cuda_graph = False
    eager = e.run_fwd(ins, outs)
    e.cuda_graph = True
    replay = e.run_fwd(ins, outs)
    check(g is not None and e._graph is g, "a second batch of the same key was recaptured")
    return eager, replay


def bck_shapes(pipe, eng):
    """The eligible convs of a backward graph, from the engine's bck-conv
    dispatch: {(n, h, c, oc, k, p): count}, x (n,h,h,c), stride 1."""
    sig = {}
    for ln in eng.get_info_log().splitlines():
        name, _, rest = ln.partition(": ")
        if not rest.startswith("bck-conv"):
            continue
        op = pipe.ops[pipe.ops[name].p("fwd_op")]
        xd, fd = pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1])
        s = (xd["img"], xd["y"], fd["in_chan"], fd["out_chan"], op.kern_sz()[0],
             op.pad()[0])
        sig[s] = sig.get(s, 0) + 1
    return sig


def bits(t):
    """The raw bits of a float tensor: NaN and -0 compare bit for bit."""
    return t.view({4: torch.int32, 2: torch.int16}[t.element_size()])


def plan_str(plan) -> str:
    return (f"{plan.path} {plan.bm}x{plan.bn} split {plan.split} {plan.ctas} blocks"
            if plan is not None else "-")


def block_library(x, w1, b1, w2, b2, w3, b3):
    """K6's yardstick: the unfused library sequence for the same block
    (cuBLAS, cuDNN, cuBLAS), as a function of no arguments."""
    import torch.nn.functional as F
    n, h, w, c = x.shape
    k = w1.shape[1]
    w2_lib = w2.permute(3, 0, 1, 2).contiguous()  # OHWI: channels_last OIHW view

    def lib():
        x2 = x.reshape(-1, c)
        h1 = torch.relu(torch.addmm(b1, x2, w1)).reshape(n, h, w, k)
        h2 = torch.relu(F.conv2d(h1.permute(0, 3, 1, 2), w2_lib.permute(0, 3, 1, 2),
                                 b2, padding=1)).permute(0, 2, 3, 1).reshape(-1, k)
        return torch.relu(torch.addmm(b3, h2, w3) + x2)
    return lib


def block_plan_str(plan) -> str:
    return (f"{plan.path} tile {plan.tile} cluster {plan.cluster} {plan.blocks} blocks"
            if plan else "-")


def pool_plan_str(plan) -> str:
    return (" ".join(f"{k} {v}" for k, v in plan._asdict().items()) if plan is not None
            else "-")


def check_paths(what: str, paths: dict, launches: int, mma: int) -> None:
    """The launches per path of the GEMM core (K1, K2/K3/K4) or of K5: ``mma``
    on the mma.sync loop (the C = 3 stem), every other one on wgmma, none on
    the f32 path."""
    want = {"wgmma": launches - mma, "mma": mma, "fma": 0}
    print(f"[paths] {what}: {paths} (expected {want})")
    check(paths == want, f"{what}: GEMM-core paths {paths}, expected {want}")


def scale_fc1000(pipes, scale: float) -> None:
    """Multiply fc1000's weights by ``scale`` in each pipe (before an engine
    uploads them). The random-weight net's softmax is saturated: prob is
    one-hot, so a forward check on it passes trivially, and a saturated
    SoftmaxWithLoss passes no gradient at all. With ``scale`` = 1 /
    max|fc1000| of a forward (fc1000's biases are 0), its logits lie in
    [-1, 1]."""
    for p in pipes:
        p.weights["fc1000__filts"].data *= np.float32(scale)


def host_us_per_launch(eng, ins) -> dict:
    """Host µs per K1 / K2 launch (the wrapper's checks, plan, allocations and
    the ctypes launch) over 5 timed gen forwards: the lowering's calls are
    wrapped in a host clock for the run."""
    import time

    from boda_tpu_torch.graph import lowering_nhwc as low
    spent = {"sgemm": [0.0, 0], "conv": [0.0, 0]}
    orig = {"matmul": low.matmul, "conv2d_halo": low.conv2d_halo}

    def timed(key, fn):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[key][0] += time.perf_counter() - t0
            spent[key][1] += 1
            return out
        return wrapped
    low.matmul, low.conv2d_halo = timed("sgemm", orig["matmul"]), timed("conv", orig["conv2d_halo"])
    eng.cuda_graph = False  # eager: under a graph the wrappers run only at capture
    try:
        eng.time_fwd(ins, ["prob"], n_iters=5, warmup=1)
    finally:
        low.matmul, low.conv2d_halo = orig["matmul"], orig["conv2d_halo"]
        eng.cuda_graph = True
    return {k: t / max(n, 1) * 1e6 for k, (t, n) in spent.items()}


def run_cli(argv) -> tuple[int, list[str]]:
    """One CLI command in process: (exit code, its stdout lines)."""
    from boda_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def stem_inputs(n, hw, oc, dt, rng, dev="cuda"):
    """The fused stem's inputs for an n x hw x hw x 3 batch, 7x7 s2 p3 to oc
    channels: the host's s2d and dx folds of the input and of the weights
    (as boda_tpu's loader would make them). Returns ((x6, w2, bias), the
    s2d fold xsd, its HWIO weights wf, kh, pooled size)."""
    from boda_tpu_torch.graph.lowering_nhwc import host_stem_s2d, stem_s2d_geom
    from boda_tpu_torch.ops.kernels.stem import fold_stem_weights_dx, host_stem_dxfold
    c, kk, s, p = 3, 7, 2, 3
    o = (hw + 2 * p - kk) // s + 1
    geom = stem_s2d_geom({"chan": c, "y": hw, "x": hw}, {"y": o, "x": o}, (s, s),
                         (p, p), (kk, kk), (1, 1), 1)
    m = geom["m"]
    x = rng.standard_normal((n, hw, hw, c), dtype=np.float32)
    w = (rng.standard_normal((oc, c, kk, kk)) * (kk * kk * c) ** -0.5).astype(np.float32)
    wh = np.pad(w.transpose(2, 3, 1, 0), ((0, m * s - kk), (0, m * s - kk), (0, 0), (0, 0)))
    wf = wh.reshape(m, s, m, s, c, oc).transpose(0, 2, 1, 3, 4, 5).reshape(m, m, s * s * c, oc)
    xsd = host_stem_s2d(x, geom)
    x6 = host_stem_dxfold(xsd, m, o)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dt)
    bias = (rng.standard_normal(oc) * 0.1).astype(np.float32)
    return ((put(x6), put(fold_stem_weights_dx(wf)), put(bias)), put(xsd), put(wf), m,
            -(-(o - 3) // 2) + 1)


def nan_case(name: str, dev):
    """One case of the nan phase (NAN_CASES), its inputs from a seed with NaN
    planted: (kernel, plain version, operands, keywords, whether the gate is
    exact, the kernel's per-path launch counts, the path it must take)."""
    from boda_tpu_torch.ops.kernels import block, conv, pool, sgemm, stem
    kind, path = name.split()[:2]
    dt = torch.float32 if path in ("fma", "f32", "thread") else torch.bfloat16
    rng = np.random.default_rng(11)

    def t(shape, scale=1.0, nan=()):
        v = (rng.standard_normal(shape) * scale).astype(np.float32)
        for idx in nan:
            v[idx] = np.nan
        return torch.from_numpy(v).to(dev, dt)
    if kind == "sgemm":
        M, K, N = {"wgmma": (4096, 128, 128), "split-K": (32, 2048, 1000)}.get(
            name.split()[-1], (77, 147, 100))
        ops = (t((M, K), nan=[(1, 3), (M - 1, K - 1)]), t((K, N), K ** -0.5), t((N,), 0.1))
        kw = dict(relu=True, residual=t((M, N), nan=[(5, 2), (M - 2, N - 1)]))
        return sgemm.matmul, sgemm.matmul_plain, ops, kw, False, sgemm.matmul.paths, path
    if kind in ("conv", "conv_nhwc"):
        n, h, c, oc, k, s, p = {"wgmma": (8, 28, 64, 64, 3, 1, 1),
                                "split-K": (2, 14, 64, 64, 3, 1, 1)}.get(
            name.split()[-1], (2, 13, 3, 20, 7, 2, 3))
        oh = (h + 2 * p - k) // s + 1
        ops = (t((n, h, h, c), nan=[(0, 0, 0, c - 1), (n - 1, h // 2, h // 3, 1)]),
               t((k, k, c, oc), (k * k * c) ** -0.5), t((oc,), 0.1))
        kw = dict(stride=(s, s), pad=(p, p), relu=True)
        if kind == "conv":
            kw["residual"] = t((n, oh, oh, oc), nan=[(n - 1, oh - 1, 1, oc - 1)])
        fk = conv.conv2d if kind == "conv" else conv.conv2d_nhwc
        return fk, conv.conv2d_plain, ops, kw, False, conv.conv2d.paths, path
    if kind == "block":
        n, h, c, k = (2, 14, 64, 64) if path == "wgmma" else (2, 9, 24, 16)
        ops = (t((n, h, h, c), nan=[(0, 0, 0, 2), (n - 1, h // 2, h // 3, c - 1)]),
               t((c, k), c ** -0.5), t((k,), 0.1), t((3, 3, k, k), (9 * k) ** -0.5),
               t((k,), 0.1), t((k, c), k ** -0.5), t((c,), 0.1))
        return (block.bottleneck, block.bottleneck_plain, ops, {}, False,
                block.bottleneck.paths, path)
    if kind == "stem":
        (x6, w2, sb), _, _, kh, pooled = stem_inputs(2, 64, 64, dt, rng, dev)
        for i in ((0, 10, 5, 7), (1, x6.shape[1] - 1, x6.shape[2] - 1, 0)):
            x6[i] = float("nan")
        kw = dict(kh=kh, poh=pooled, pow_=pooled, relu=True)
        return (stem.stem_fused, stem.stem_fused_plain, (x6, w2, sb), kw, False,
                stem.stem_fused.paths, path)
    n, h, c, k, s, oy = {"rows": (2, 14, 16, 3, 2, 7), "window": (2, 7, 64, 7, 1, 1)}.get(
        path, (2, 13, 12, 3, 2, 6))
    pad = (0, max(0, (oy - 1) * s + k - h))
    ops = (t((n, h, h, c), nan=[(0, 0, 0, 1), (n - 1, h - 1, h - 1, c - 1), (1, 4, 6, 3)]),
           (k, k), (s, s), pad, pad, oy, oy, False)
    return pool.pool2d, pool.pool2d_plain, ops, {}, True, pool.pool2d.paths, path


def nan_check(name: str, dev) -> tuple[bool, str]:
    """Run one nan-phase case: the kernel on the card against its plain
    version on CPU copies of the same inputs (so that no library algorithm, a
    Winograd or FFT conv, spreads a NaN past its receptive field), NaN
    compared equal: the same isnan mask, which holds a NaN and is not all NaN,
    and the rest equal (max) or within TOL of max|ref|. Returns (ok, the
    [nan] line)."""
    fk, fp, ops, kw, exact, paths, want = nan_case(name, dev)
    before = dict(paths)
    out = fk(*ops, **kw)
    torch.cuda.synchronize()
    ran = [q for q in paths if paths[q] == before[q] + 1]

    def cpu(v):
        return v.cpu() if torch.is_tensor(v) else v
    ref = fp(*map(cpu, ops), **{k: cpu(v) for k, v in kw.items()})
    out, dt = out.cpu(), ops[0].dtype
    mask, want_mask = torch.isnan(out.float()), torch.isnan(ref.float())
    fin = ~want_mask
    d = float((out.float() - ref.float())[fin].abs().max())
    err = d / max(float(ref.float()[fin].abs().max()), 1e-30)
    ok = (ran == [want] and bool(want_mask.any()) and bool(fin.any())
          and torch.equal(mask, want_mask)
          and (torch.equal(out[fin], ref[fin]) if exact else err <= TOL[dt]))
    return ok, (f"[nan] {name} {str(dt)[6:]} {tuple(out.shape)}: path {ran}, NaN "
                f"{int(mask.sum())} of {out.numel()} (plain {int(want_mask.sum())}), "
                f"the rest {'equal' if exact else f'max|err|/max|ref| {err:.2e}'}: "
                f"{'ok' if ok else 'MISS'}")


def check_nodes(pipe):
    """test_compute's node set: every computed node that is not a weight."""
    return [n for n, node in pipe.nodes.items()
            if node.dims is not None and n not in pipe.weights and node.top_for]


def node_agreement(ref, got, nodes, toler):
    """test_compute's rule on each node: comp_vars(mrd_toler=toler,
    atol=toler * max|ref|). Returns (failures, (worst max|err|/max|ref|,
    node))."""
    from boda_tpu_torch.utils.digest import comp_vars
    fails, worst = [], (0.0, "")
    for n in nodes:
        a, b = ref[n].data, got[n].data
        check(a.shape == b.shape, f"{n}: shapes {a.shape} {b.shape}")
        check(bool(np.isfinite(b).all()), f"{n}: non-finite")
        scale = max(1e-30, float(np.abs(a).max()))
        r = comp_vars(a, b, mrd_toler=toler, atol=toler * scale)
        if r.mad / scale > worst[0]:
            worst = (r.mad / scale, n)
        if not r.ok():
            fails.append(f"{n}: {r} (max|ref| {scale:.3g})")
    return fails, worst


def weight_grads(pipe):
    return [n for n in pipe.nodes if pipe.nodes[n].dims is not None and
            any(n.startswith(w + "__grad") for w in pipe.weights)]


def fused_shapes(pipe, eng):
    """The bottleneck, pool and space-to-depth calls of one fused forward,
    from the engine's dispatch: {signature: count} for each."""
    block, pool, s2d = {}, {}, {}
    for a_name in eng._blocks:
        xd = pipe.must_dims(pipe.ops[a_name].bots[0])
        sig = (xd["img"], xd["y"], xd["chan"], pipe.must_dims(a_name)["chan"])
        block[sig] = block.get(sig, 0) + 1
    routed = {}  # op name -> route (a chained op's lowering is logged twice)
    for ln in eng.get_info_log().splitlines():
        name, _, rest = ln.partition(": ")
        routed[name] = rest
    for name, rest in routed.items():
        op = pipe.ops.get(name)
        if rest.startswith("nhwc-pool_pallas"):
            ind, od = pipe.must_dims(op.bots[0]), pipe.must_dims(op.tops[0])
            sig = (ind["img"], ind["y"], ind["chan"], op.kern_sz()[0], op.stride()[0],
                   od["y"], bool(op.p("avg_pool", False)))
            pool[sig] = pool.get(sig, 0) + 1
        elif rest.startswith("nhwc-s2d_conv"):
            ind, fd = pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1])
            sig = (ind["img"], ind["y"], fd["in_chan"], fd["out_chan"], op.kern_sz()[0],
                   op.stride()[0], op.pad()[0])
            s2d[sig] = s2d.get(sig, 0) + 1
    return block, pool, s2d


def work(kname: str, sig) -> tuple[float, float]:
    """(bytes, operations / peak in bf16-tensor-core units) of one bf16 call:
    each input read once, each output written once; a pool's operations at
    the f32 FMA rate, the rest at the bf16 tensor-core rate. Returns the two
    times in ms."""
    es = 2
    if kname == "sgemm":
        M, K, N, res, _ = sig
        ops, byts = 2 * M * K * N, es * (M * K + K * N + N + M * N * (1 + res))
    elif kname in ("conv", "s2d"):
        n, h, c, oc, k, st, p = sig[:7]
        res = sig[7] if kname == "conv" else False
        oh = (h + 2 * p - k) // st + 1
        ops = 2 * n * oh * oh * oc * k * k * c
        byts = es * (n * h * h * c + k * k * c * oc + oc + n * oh * oh * oc * (1 + res))
    elif kname == "atb":  # wgrad: x and dy in, an f32 HWIO gradient out
        n, h, c, oc, k, p = sig
        oh = h + 2 * p - k + 1
        ops = 2 * n * oh * oh * oc * k * k * c
        byts = es * (n * h * h * c + n * oh * oh * oc) + 4 * k * k * c * oc
    elif kname == "atb_dense":
        K, M, N = sig
        ops, byts = 2 * K * M * N, es * (K * M + K * N) + 4 * M * N
    elif kname == "dgrad":
        n, h, c, oc, k, p = sig
        oh = h + 2 * p - k + 1
        ops = 2 * n * h * h * c * k * k * oc
        byts = es * (n * oh * oh * oc + k * k * c * oc + n * h * h * c)
    elif kname == "block":
        n, h, c, k = sig
        ops = 2 * n * h * h * (2 * c * k + 9 * k * k)
        byts = es * (2 * n * h * h * c + 2 * c * k + 9 * k * k + 2 * k + c)
    elif kname == "pool":
        n, h, c, k, _, oy, _ = sig
        return (es * n * c * (h * h + oy * oy) / HBM_BPS * 1e3,
                n * oy * oy * c * k * k / F32_OPS * 1e3)
    else:
        raise KeyError(kname)
    return byts / HBM_BPS * 1e3, ops / BF16_OPS * 1e3


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


# -- the [caffe] phase: Caffe nets in, GoogLeNet b32 bf16 read back -------------------

# the testdata nets through run_cnet --ptt-fn on the card: shapesnet{,2,3}
# with their trained caffemodels; tinynet (it holds the LRN) with the seeded
# weights (its caffemodel is a wire-format fixture of another net)
CAFFE_NETS = {"tinynet": "", "shapesnet": "shapesnet.caffemodel",
              "shapesnet2": "shapesnet2.caffemodel", "shapesnet3": "shapesnet3.caffemodel"}
# bf16 prob of a trained net against its f32 forward, max|err|/max|ref|
CAFFE_BF16_TOL = 5e-2
GOOGLENET_LOGITS = "loss3/classifier"
# GoogLeNet's kernel calls: every 1x1 conv and the classifier on K1, every
# k x k conv on K2 (conv1 through K4's fold under fused), every pool on K8
# under fused; its 14 pools
GOOGLENET_POOLS = 14
# the other builders, f32 b2 gen vs lib on every node, at the smallest input
# each takes at its published widths (alexnet's fc6 is sized for a 6x6 pool5)
CAFFE_SMALL = {"alexnet_ng_conv": 199, "nin_imagenet": 55, "vgg16": 32,
               "squeezenet": 29, "firenet": 25}


def counted_wrappers() -> dict:
    """The kernel wrappers whose launches a path's run is held to, by the
    name the kernels line gives them."""
    from boda_tpu_torch.ops.kernels.bconv import matmul_atb
    from boda_tpu_torch.ops.kernels.block import bottleneck
    from boda_tpu_torch.ops.kernels.conv import conv2d, conv2d_nhwc, space_to_depth_conv
    from boda_tpu_torch.ops.kernels.pool import pool2d
    from boda_tpu_torch.ops.kernels.sgemm import matmul
    return {"sgemm": matmul, "conv": conv2d, "conv_nhwc": conv2d_nhwc,
            "s2d": space_to_depth_conv, "atb": matmul_atb, "block": bottleneck,
            "pool": pool2d}


def zero_counts(counted: dict) -> None:
    for f in counted.values():
        f.launches = 0
        if hasattr(f, "paths"):
            f.paths = dict.fromkeys(f.paths, 0)


def read_counts(counted: dict) -> dict:
    torch.cuda.synchronize()
    return {k: f.launches for k, f in counted.items()}


def kernel_shape_checks(net, pipe, gen, fused, cases) -> list[str]:
    """Each distinct K1 and K2 call of the gen forward, and, given the fused
    engine, each K8 and K4 call of the fused forward, at the net's own
    shapes on random bf16 operands (main's case builders ``cases``), against
    its plain version: max pools exact, the rest within TOL of max|ref|; K1
    on wgmma, K2 on wgmma but at C % 8 != 0 on mma.sync. Prints one line per
    call, with the kernel's and the library's device time and the bound;
    returns the miss lines."""
    from boda_tpu_torch.graph.lowering_nhwc import pool_geom
    from boda_tpu_torch.ops.kernels.conv import conv2d
    from boda_tpu_torch.ops.kernels.sgemm import matmul
    from boda_tpu_torch.rtc.backends import graph_time
    bf = torch.bfloat16
    gemm, conv = layer_shapes(pipe, gen)
    misses, worst = [], {}

    def held(kname, sig, what, case, path=None, want=None, exact=False):
        out, ref, (kernel, _, lib) = case
        err = rel_err(out, ref)[1]
        ok = (torch.equal(out, ref) if exact else err <= TOL[bf]) and path == want
        worst[kname] = max(worst.get(kname, 0.0), err)
        line = f"{kname} {what}: {err:.3e}" + (f" on {path}" if path else "")
        print(f"[caffe] {net} {line}: {'ok' if ok else 'MISS'}; kernel "
              f"{graph_time(kernel) * 1e6:.2f} us, library {graph_time(lib) * 1e6:.2f} us, "
              f"bound {max(work(kname, sig)) * 1e3:.2f} us")
        if not ok:
            misses.append(line)

    def ran(f, before):
        return [p for p in f.paths if f.paths[p] != before[p]]
    for sig, cnt in gemm.items():
        M, K, N, _, relu = sig
        before = dict(matmul.paths)
        case = cases["gemm"](*sig, bf)
        held("sgemm", sig, f"M={M} K={K} N={N} relu={int(relu)} x{cnt}", case,
             ran(matmul, before), ["wgmma"])
    for sig, cnt in conv.items():
        n, h, c, oc, k, s, p = sig[:7]
        before = dict(conv2d.paths)
        case = cases["conv"](*sig, bf)
        held("conv", sig, f"{h}x{h} C={c} OC={oc} k{k} s{s} p{p} x{cnt}", case,
             ran(conv2d, before), ["mma"] if c % 8 else ["wgmma"])
    log = fused.get_info_log() if fused is not None else ""
    for op in pipe.ops.values() if fused is not None else ():
        if op.type in ("Pooling", "Convolution"):
            ind = pipe.must_dims(op.bots[0])
            n, h, c = ind["img"], ind["y"], ind["chan"]
        if op.type == "Pooling":
            k, s, pad_y, pad_x, oy, _, avg = pool_geom(pipe, op)
            sig = (n, h, c, k[0], s[0], oy, avg)
            held("pool", sig, f"{op.name} {h}x{h} C={c} k{k[0]} s{s[0]} -> {oy}",
                 cases["pool"](*sig, bf, pads=(pad_y, pad_x)), exact=not avg)
        elif op.type == "Convolution" and f"{op.name}: nhwc-s2d_conv" in log:
            fd = pipe.must_dims(op.bots[1])
            sig = (n, h, c, fd["out_chan"], fd["y"], op.stride()[0], op.pad()[0])
            held("s2d", sig, f"{op.name} {h}x{h} C={c} OC={fd['out_chan']}",
                 cases["s2d"](*sig, bf))
    print(f"[caffe] {net} b{BATCH} bf16, each distinct call at the net's shapes vs its plain "
          f"version: sgemm {len(gemm)}, conv {len(conv)}"
          + (", and the fused forward's pools and s2d" if fused is not None else "")
          + "; worst max|err|/max|ref| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
          + f" (tol {TOL[bf]}; max pools exact)")
    return misses


def caffe_phase(card: str, out_dir, counted: dict, cases: dict) -> dict:
    """[caffe]: the Caffe frontend on the card. The testdata nets through
    run_cnet --ptt-fn (f32 every node gen vs lib and vs the port on the CPU;
    bf16 prob vs f32 and top-1); GoogLeNet b32 224x224 bf16 written by the
    port's own prototxt and caffemodel writers and read back, under gen, lib
    and fused, each captured and replayed; the other builders small in f32,
    and vgg16 at b32 bf16; every distinct K1 and K2 call of GoogLeNet's and
    VGG-16's b32 forwards (and K8 and K4 of GoogLeNet's fused one) against
    its plain version. Returns the phase's numbers."""
    import os
    import tempfile
    import time

    from boda_tpu_torch.config import make
    from boda_tpu_torch.frontend.surgery import pipe_to_prototxt, write_caffemodel
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.utils.lexp import parse_lexp
    t_phase = time.perf_counter()
    out = {"card": card}
    nets_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata", "nets")

    # -- the testdata nets, through run_cnet --ptt-fn and node by node ------------
    for name, cm in CAFFE_NETS.items():
        ptt = os.path.join(nets_dir, f"{name}.prototxt")
        cm = os.path.join(nets_dir, cm) if cm else ""
        rc, lines = run_cli(["run_cnet", f"--ptt-fn={ptt}", "--img=0", "--conv-fwd=(mode=cuda)"]
                            + ([f"--weights-fn={cm}"] if cm else []))
        top = next((ln for ln in lines if ln.startswith("out prob")), "")
        check(rc == 0 and bool(top), f"run_cnet --ptt-fn {name} on the card: rc {rc}")
        pipe, dims = load_net(ptt_fn=ptt, weights_fn=cm, img=0)
        ins, nodes = gen_data_inputs(dims), check_nodes(pipe)
        r = {}
        for tag, kw in (("gen", {}), ("lib", {"kernel_policy": "lib"}),
                        ("cpu", {"device": "cpu"}), ("bf16", {"compute_tn": "bfloat16"})):
            e = make("conv_fwd", "cuda", **kw)
            e.init(pipe)
            r[tag] = e.run_fwd(ins, ["prob"] if tag == "bf16" else nodes)
        _, (e_lib, n_lib) = node_agreement(r["lib"], r["gen"], nodes, F32_NODE_TOL)
        _, (e_cpu, n_cpu) = node_agreement(r["cpu"], r["gen"], nodes, F32_NODE_TOL)
        _, (e_bf, _) = node_agreement(r["gen"], r["bf16"], ["prob"], CAFFE_BF16_TOL)
        t32, t16 = (np.argmax(r[t]["prob"].data.reshape(len(ins["data"].data), -1), 1)
                    for t in ("gen", "bf16"))
        print(f"[caffe] {name} ({'trained ' + os.path.basename(cm) if cm else 'seeded'}), "
              f"b{len(t32)}: run_cnet --ptt-fn rc 0, {top}; f32 {len(nodes)} nodes gen vs lib "
              f"worst {e_lib:.3e} ({n_lib}), gen vs the port on the CPU {e_cpu:.3e} ({n_cpu}) "
              f"(tol {F32_NODE_TOL}); bf16 prob vs f32 {e_bf:.3e} (tol {CAFFE_BF16_TOL}), "
              f"top-1 equal {int((t32 == t16).sum())} of {len(t32)}")
        check(e_lib <= F32_NODE_TOL and e_cpu <= F32_NODE_TOL, f"{name}: f32 per node")
        check(e_bf <= CAFFE_BF16_TOL and bool((t32 == t16).all()), f"{name}: bf16 prob/top-1")
        del r

    # -- GoogLeNet b32 bf16, written by the port and read back -------------------
    zoo, _ = load_net("googlenet_conv", img=BATCH)
    with tempfile.TemporaryDirectory(dir=out_dir) as td:
        ptt, cm = os.path.join(td, "googlenet.prototxt"), os.path.join(td, "googlenet.caffemodel")
        with open(ptt, "w") as f:
            f.write(pipe_to_prototxt(zoo))
        write_caffemodel(cm, zoo)
        t0 = time.perf_counter()
        pipe, dims = load_net(ptt_fn=ptt, weights_fn=cm, img=BATCH)
        read_s = time.perf_counter() - t0
        same = sorted(pipe.weights) == sorted(zoo.weights) and all(
            np.array_equal(pipe.weights[k].data, w.data) for k, w in zoo.weights.items())
        print(f"[caffe] googlenet_conv b{BATCH} written by pipe_to_prototxt + write_caffemodel "
              f"({os.path.getsize(cm) / 2 ** 20:.1f} MiB) and read back by load_net(ptt_fn, "
              f"weights_fn) in {read_s:.2f} s: {len(pipe.ops)} ops, {len(pipe.weights)} weights "
              f"bit-equal to the zoo's: {same}")
        check(same and list(pipe.ops) == list(zoo.ops), "googlenet read back != the zoo's")
        # the user's line on the card: run_cnet on the written pair, per-layer times
        rc, lines = run_cli(["run_cnet", f"--ptt-fn={ptt}", f"--weights-fn={cm}",
                             f"--img={BATCH}", "--n-iters=20",
                             "--conv-fwd=(mode=cuda,compute_tn=bfloat16)",
                             f"--boda-output-dir={out_dir}",
                             "--per-layer-fn=googlenet_per_layer.txt"])
    pl = (out_dir / "googlenet_per_layer.txt").read_text().splitlines() if rc == 0 else []
    times = sorted(((float(ln.split("=", 1)[1]), ln.split("'")[1]) for ln in pl), reverse=True)
    print(f"[caffe] run_cnet --ptt-fn --weights-fn googlenet b{BATCH} bf16 gen rc={rc}: "
          f"{next((ln for ln in lines if ln.startswith('{')), '')}")
    print(f"[caffe] googlenet --per-layer-fn: {len(pl)} lines for {len(pipe.ops)} ops, sum "
          f"{sum(t for t, _ in times) * 1e3:.3f} ms; slowest "
          + ", ".join(f"{n} {t * 1e6:.1f} us" for t, n in times[:5]) + f" ({card})")
    check(rc == 0 and len(pl) == len(pipe.ops), "googlenet run_cnet --per-layer-fn")
    out["per_layer_top5_us"] = {n: t * 1e6 for t, n in times[:5]}
    out["per_layer_sum_ms"] = sum(t for t, _ in times) * 1e3

    # the classifier scaled so that prob is not one-hot (as scale_fc1000)
    ins = gen_data_inputs(dims)
    e = make("conv_fwd", "cuda", compute_tn="bfloat16")
    e.init(pipe)
    lmax = float(np.abs(e.run_fwd(ins, [GOOGLENET_LOGITS])[GOOGLENET_LOGITS].data).max())
    pipe.weights[f"{GOOGLENET_LOGITS}__filts"].data *= np.float32(1.0 / lmax)
    del e
    print(f"[caffe] {GOOGLENET_LOGITS} weights scaled by {1 / lmax:.4g} (max|logits| "
          f"{lmax:.4g} in the gen forward): logits in [-1, 1]")
    n_1x1 = sum(o.type == "Convolution" and o.kern_sz() == (1, 1) for o in pipe.ops.values())
    n_kxk = sum(o.type == "Convolution" and o.kern_sz() != (1, 1) for o in pipe.ops.values())
    none = dict.fromkeys(counted, 0)
    want = {"gen": {**none, "sgemm": n_1x1 + 1, "conv": n_kxk}, "lib": none,
            "fused": {**none, "sgemm": n_1x1 + 1, "conv": n_kxk, "s2d": 1,
                      "conv_nhwc": 1, "pool": GOOGLENET_POOLS}}  # K4's conv on K3's entry
    fwd_outs = [GOOGLENET_LOGITS, "prob"]
    ins2 = other_batch(ins, 17)
    engines, res, rows = {}, {}, {}
    for pol, kw in (("gen", {}), ("lib", {"kernel_policy": "lib"}),
                    ("fused", {"fuse_block": True, "tune": parse_lexp(FUSED_TUNE)})):
        e = engines[pol] = make("conv_fwd", "cuda", compute_tn="bfloat16", **kw)
        e.init(pipe)
        elog = e.get_info_log()
        e.cuda_graph = False
        eager = e.run_fwd(ins, fwd_outs)
        e.cuda_graph = True
        e.prepare(ins, fwd_outs)
        zero_counts(counted)
        replay = res[pol] = e.run_fwd(ins, fwd_outs)
        n = read_counts(counted)
        paths = {k: dict(counted[k].paths) for k in ("sgemm", "conv", "pool")}
        cap_s = e._graph.capture_secs
        print(f"[caffe] googlenet b{BATCH} bf16 {pol}: launches {n} (expected {want[pol]}); "
              f"paths sgemm {paths['sgemm']}, conv {paths['conv']}, pool {paths['pool']}")
        check(n == want[pol], f"googlenet {pol}: launches {n}, expected {want[pol]}")
        if pol != "lib":
            check_paths(f"googlenet {pol} sgemm", paths["sgemm"], n["sgemm"], 0)
            check_paths(f"googlenet {pol} conv", paths["conv"], n["conv"],
                        1 if pol == "gen" else 0)  # gen: the C = 3 stem on mma.sync
            check(pol == "gen" or "conv1/7x7_s2: nhwc-s2d_conv" in elog,
                  "googlenet fused: conv1 did not take the space-to-depth fold")
        bit = {k: np.array_equal(replay[k].data, eager[k].data) for k in fwd_outs}
        errs = {k: rel_err(torch.from_numpy(replay[k].data),
                           torch.from_numpy(eager[k].data))[1] for k in fwd_outs}
        eager2, replay2 = replay_follows(e, ins2, fwd_outs)
        bit2 = {k: np.array_equal(replay2[k].data, eager2[k].data) for k in fwd_outs}
        moved = not np.array_equal(eager2[GOOGLENET_LOGITS].data, eager[GOOGLENET_LOGITS].data)
        check(moved, f"googlenet {pol}: the second batch left the logits as they were")
        if pol == "lib":
            check(max(errs.values()) <= SLICE_TOL["prob"], f"googlenet graph lib: {errs}")
        else:
            check(all(bit.values()) and all(bit2.values()),
                  f"googlenet {pol}: replay not bit-equal to eager {errs}")
        e.cuda_graph = False
        eager_s = e.time_fwd(ins, ["prob"], n_iters=20, warmup=5)
        e.cuda_graph = True
        secs = e.time_fwd(ins, ["prob"], n_iters=20, warmup=5)
        rows[pol] = {"eager_ms": eager_s * 1e3, "graph_ms": secs * 1e3,
                     "img_per_s": BATCH / secs, "eager_img_per_s": BATCH / eager_s,
                     "capture_s": cap_s, "launches": n}
        print(f"[caffe] googlenet b{BATCH} bf16 {pol}: replay vs eager "
              + ", ".join(f"{k} {'bit-equal' if bit[k] else f'{errs[k]:.3e}'}" for k in fwd_outs)
              + ", second batch " + ("bit-equal" if all(bit2.values()) else "within the gate")
              + f"; eager {eager_s * 1e3:.3f} ms/fwd ({BATCH / eager_s:.1f} img/s), graph "
              f"{secs * 1e3:.3f} ms/fwd ({BATCH / secs:.1f} img/s), capture {cap_s:.3f} s "
              f"({card})")
        del eager, eager2, replay2
    prob = res["gen"]["prob"].data
    check(prob.shape == (BATCH, 1000) and bool(np.isfinite(prob).all()), "googlenet prob")
    print(f"[caffe] googlenet max|prob| {prob.max():.4g} (one-hot would be 1)")
    check(prob.max() < 0.5, "googlenet prob is saturated: the gates would check nothing")
    for a, b in (("gen", "lib"), ("fused", "gen"), ("fused", "lib")):
        errs = {k: rel_err(torch.from_numpy(res[a][k].data),
                           torch.from_numpy(res[b][k].data))[1] for k in fwd_outs}
        print(f"[caffe] googlenet {a} vs {b}: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {SLICE_TOL['prob']})")
        check(max(errs.values()) <= SLICE_TOL["prob"], f"googlenet {a} vs {b}: {errs}")
    top = {p: np.argmax(res[p]["prob"].data, 1) for p in res}
    print(f"[caffe] googlenet top-1 agreement gen vs lib {float(np.mean(top['gen'] == top['lib'])):.3f}, "
          f"fused vs gen {float(np.mean(top['fused'] == top['gen'])):.3f}")
    misses = kernel_shape_checks("googlenet", pipe, engines["gen"], engines["fused"], cases)
    check(not misses, f"googlenet: {len(misses)} kernel calls differ from their plain "
          f"versions: {misses}")
    out["googlenet"] = rows
    del engines, res

    # -- the other builders: f32 b2 at their smallest input, every node ------------
    for name, sz in CAFFE_SMALL.items():
        spipe, sdims = load_net(name, img=2, in_sz=sz)
        sins, nodes = gen_data_inputs(sdims), check_nodes(spipe)
        r = {}
        for pol in ("gen", "lib"):
            e = make("conv_fwd", "cuda", kernel_policy=pol)
            e.init(spipe)
            r[pol] = e.run_fwd(sins, nodes)
        _, (err, node) = node_agreement(r["lib"], r["gen"], nodes, F32_NODE_TOL)
        print(f"[caffe] {name} f32 b2 {sz}x{sz}: {len(nodes)} nodes gen vs lib worst {err:.3e} "
              f"({node}) (tol {F32_NODE_TOL})")
        check(err <= F32_NODE_TOL, f"{name}: f32 per node gen vs lib")
        del r

    # -- vgg16 b32 224 bf16: conv1_1 is K2's C = 3 route at stride 1 --------------
    vpipe, vdims = load_net("vgg16", img=BATCH)
    vins = gen_data_inputs(vdims)
    e = make("conv_fwd", "cuda", compute_tn="bfloat16")
    e.init(vpipe)
    vmax = float(np.abs(e.run_fwd(vins, ["fc8"])["fc8"].data).max())
    vpipe.weights["fc8__filts"].data *= np.float32(1.0 / vmax)
    v = {}
    for pol in ("gen", "lib"):
        e = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy=pol)
        e.init(vpipe)
        e.prepare(vins, ["fc8", "prob"])
        zero_counts(counted)
        v[pol] = e.run_fwd(vins, ["fc8", "prob"])
        n = read_counts(counted)
        cpaths = dict(counted["conv"].paths)
        secs = e.time_fwd(vins, ["prob"], n_iters=10, warmup=3)
        out[f"vgg16_{pol}"] = {"graph_ms": secs * 1e3, "img_per_s": BATCH / secs, "launches": n}
        print(f"[caffe] vgg16 b{BATCH} 224 bf16 {pol}: launches {n}, conv paths {cpaths}; graph "
              f"{secs * 1e3:.3f} ms/fwd ({BATCH / secs:.1f} img/s) ({card})")
        if pol == "gen":  # 13 3x3 convs, conv1_1 (C = 3) on mma.sync; fc6-fc8
            check(n["conv"] == 13 and n["sgemm"] == 3, f"vgg16 gen launches {n}")
            check_paths("vgg16 gen conv", cpaths, n["conv"], 1)
            vgen = e
        del e
    errs = {k: rel_err(torch.from_numpy(v["gen"][k].data), torch.from_numpy(v["lib"][k].data))[1]
            for k in ("fc8", "prob")}
    print(f"[caffe] vgg16 fc8 scaled by {1 / vmax:.4g}; gen vs lib "
          + ", ".join(f"{k} {x:.3e}" for k, x in errs.items()) + f" (tol {SLICE_TOL['prob']}); "
          f"max|prob| {v['gen']['prob'].data.max():.4g}")
    check(max(errs.values()) <= SLICE_TOL["prob"], f"vgg16 gen vs lib {errs}")
    # conv1_1 (K2's C = 3 route at stride 1) and fc6 (split-K at K = 25088)
    # among them
    misses = kernel_shape_checks("vgg16", vpipe, vgen, None, cases)
    check(not misses, f"vgg16: {len(misses)} kernel calls differ from their plain "
          f"versions: {misses}")
    del vgen
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[caffe] phase took {out['seconds']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "a CUDA card", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph.autodiff import add_bck_ops
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.bconv import (conv2d_bck_filts,
                                                  conv2d_bck_filts_plain,
                                                  conv2d_bck_in, conv2d_bck_in_plain,
                                                  matmul_atb, matmul_atb_plain)
    from boda_tpu_torch.ops.kernels.block import bottleneck, bottleneck_plain
    from boda_tpu_torch.ops.kernels.block import plan as block_plan
    from boda_tpu_torch.ops.kernels.block import route as block_route
    from boda_tpu_torch.ops.kernels.conv import (conv2d, conv2d_nhwc, conv2d_plain,
                                                 space_to_depth_conv)
    from boda_tpu_torch.ops.kernels.elementwise import eltwise, eltwise_plain
    from boda_tpu_torch.ops.kernels.pool import pool2d, pool2d_plain
    from boda_tpu_torch.ops.kernels.pool import route as pool_route
    from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain
    from boda_tpu_torch.ops.kernels.stem import stem_fused, stem_fused_plain
    from boda_tpu_torch.rtc.backends import graph_time
    from boda_tpu_torch.utils.dims import NDA, Dims
    from boda_tpu_torch.utils.lexp import parse_lexp

    # the plain versions in full f32 (cuDNN convs default to TF32). Only the
    # fp32_precision settings, as the engine uses: recent torch refuses a
    # process that mixes them with the legacy allow_tf32 flags.
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    dev = torch.device("cuda")
    counted = counted_wrappers()
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
    log = kb.log.splitlines()
    spills, name = [], "?"
    for ln in log:  # ptxas: "Function properties for <name>", then its spill line
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[-1].strip()
        elif "spill" in ln and " 0 bytes spill stores" not in ln:
            spills.append(f"{name}: {ln.strip()}")
    print(f"[build] {sum('registers' in ln for ln in log)} kernels, "
          f"{len(spills)} with spill stores")
    for ln in spills:
        print(f"[build]   {ln}")

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

    def wgrad_case(n, h, c, oc, k, p, dt):
        oh = h + 2 * p - k + 1
        x, dy = rnd((n, h, h, c), dt), rnd((n, oh, oh, oc), dt)
        pad = (p, p)
        out, ref = conv2d_bck_filts(x, dy, pad=pad), conv2d_bck_filts_plain(x, dy, pad=pad)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)  # channels_last views

        def lib():
            return torch.nn.grad.conv2d_weight(xn, (oc, c, k, k), dyn, padding=p)
        return out, ref, (lambda: conv2d_bck_filts(x, dy, pad=pad),
                          lambda: conv2d_bck_filts_plain(x, dy, pad=pad), lib)

    def atb_case(K, M, N, dt):
        a, b = rnd((K, M), dt), rnd((K, N), dt)
        return matmul_atb(a, b), matmul_atb_plain(a, b), (
            lambda: matmul_atb(a, b), lambda: matmul_atb_plain(a, b), lambda: a.t() @ b)

    def dgrad_case(n, h, c, oc, k, p, dt):
        oh = h + 2 * p - k + 1
        dy, w = rnd((n, oh, oh, oc), dt), rnd((k, k, c, oc), dt, (k * k * oc) ** -0.5)
        pad = (p, p)
        out, ref = conv2d_bck_in(dy, w, pad=pad), conv2d_bck_in_plain(dy, w, pad=pad)
        w_oihw, dyn = w.permute(3, 2, 0, 1).contiguous(), dy.permute(0, 3, 1, 2)

        def lib():
            return torch.nn.grad.conv2d_input((n, c, h, h), w_oihw, dyn, padding=p)
        return out, ref, (lambda: conv2d_bck_in(dy, w, pad=pad),
                          lambda: conv2d_bck_in_plain(dy, w, pad=pad), lib)

    def block_case(n, h, c, k, dt):
        x = rnd((n, h, h, c), dt)
        w1, b1 = rnd((c, k), dt, c ** -0.5), rnd((k,), dt, 0.1)
        w2, b2 = rnd((3, 3, k, k), dt, (9 * k) ** -0.5), rnd((k,), dt, 0.1)
        w3, b3 = rnd((k, c), dt, k ** -0.5), rnd((c,), dt, 0.1)
        ops = (x, w1, b1, w2, b2, w3, b3)
        return bottleneck(*ops), bottleneck_plain(*ops), (
            lambda: bottleneck(*ops), lambda: bottleneck_plain(*ops), block_library(*ops))

    def pool_case(n, h, c, k, s, oy, avg, dt, pads=None):
        # pads: pool_geom's (pad_y, pad_x), else the ceil-mode pad alone
        x = rnd((n, h, h, c), dt)
        pad = (0, max(0, (oy - 1) * s + k - h))
        pads = pads or (pad, pad)
        args = ((k, k), (s, s), *pads, oy, oy, avg)
        lib_pool = F.avg_pool2d if avg else F.max_pool2d
        return pool2d(x, *args), pool2d_plain(x, *args), (
            lambda: pool2d(x, *args), lambda: pool2d_plain(x, *args),
            lambda: lib_pool(x.permute(0, 3, 1, 2), k, s, pads[0][0], ceil_mode=True))

    def s2d_case(n, h, c, oc, k, s, p, dt):
        x, w = rnd((n, h, h, c), dt), rnd((k, k, c, oc), dt, (k * k * c) ** -0.5)
        bias = rnd((oc,), dt, 0.1)
        kw = dict(stride=(s, s), pad=(p, p), relu=True)
        w_lib = w.permute(3, 0, 1, 2).contiguous()

        def lib():  # cuDNN's strided conv, unfolded
            return torch.relu(F.conv2d(x.permute(0, 3, 1, 2), w_lib.permute(0, 3, 1, 2),
                                       bias, stride=s, padding=p))
        return space_to_depth_conv(x, w, bias, **kw), conv2d_plain(x, w, bias, **kw), (
            lambda: space_to_depth_conv(x, w, bias, **kw),
            lambda: conv2d_plain(x, w, bias, **kw), lib)

    pipe, in_dims = load_net("resnet50", img=BATCH)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    gemm_shapes, conv_shapes = layer_shapes(pipe, eng)
    # fc1000 scaled so that prob is not one-hot (scale_fc1000), from this
    # forward's max|fc1000|, for every ResNet-50 b32 and b8 pipe below; the
    # engines are made after it
    fc_max = float(np.abs(eng.run_fwd(gen_data_inputs(in_dims), ["fc1000"])["fc1000"]
                          .data).max())
    fc_scale = 1.0 / fc_max
    scale_fc1000([pipe], fc_scale)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    print(f"[slice] fc1000 weights scaled by {fc_scale:.4g} (max|fc1000| {fc_max:.4g} in "
          f"the b{BATCH} bf16 gen forward): logits in [-1, 1], prob not one-hot")
    fused = make("conv_fwd", "cuda", compute_tn="bfloat16", fuse_block=True,
                 tune=parse_lexp(FUSED_TUNE))
    fused.init(pipe)
    block_shapes, pool_shapes, s2d_shapes = fused_shapes(pipe, fused)
    for (n, h, c, k), cnt in block_shapes.items():
        bp = block_plan(n, h, h, c, k, torch.bfloat16)
        print(f"[block] {h}x{h} C={c} K={k} x{cnt}: {bp.path}, tile {bp.tile}x{bp.tile}, "
              f"clusters of {bp.cluster}, {bp.blocks} thread blocks")
    # the backward graph at b32 bf16: the eligible convs' wgrad/dgrad shapes
    bpipe, bdims = load_net("resnet50", img=BATCH)
    add_bck_ops(bpipe)
    bdims["label"] = bpipe.nodes["label"].dims
    beng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    beng.init(bpipe)
    wg_shapes = bck_shapes(bpipe, beng)
    del beng
    n_bck_conv = sum(wg_shapes.values())
    dense_shapes = {}  # boda_tpu's form: one (K,C)^T (K,OC) product per tap
    for (n, h, c, oc, k, p), cnt in wg_shapes.items():
        key = (n * h * h, c, oc)
        dense_shapes[key] = dense_shapes.get(key, 0) + cnt * k * k
    print(f"[bck] resnet50 b{BATCH}: {n_bck_conv} convs take bck-conv, "
          f"{len(wg_shapes)} distinct shapes")
    check(n_bck_conv == 46, f"{n_bck_conv} bck-conv ops, expected 46")
    summary = {}
    last_plan = {"sgemm": matmul, "atb": matmul_atb, "atb_dense": matmul_atb}
    for kname, case, shapes, extra in (
            ("sgemm", gemm_case, gemm_shapes,
             [((77, 147, 100, True, True), 1), ((32, 2048, 1000, False, False), 1)]),
            ("conv", conv_case, conv_shapes,
             [((2, 13, 3, 20, 7, 2, 3, False, True), 1),
              ((2, 9, 24, 40, 3, 1, 1, True, True), 1),
              ((1, 11, 16, 136, 3, 2, 1, False, False), 1)]),
            ("atb", wgrad_case, wg_shapes,
             [((2, 9, 24, 40, 3, 1), 1), ((3, 7, 19, 77, 1, 0), 1)]),
            ("atb_dense", atb_case, dense_shapes,
             [((1000, 77, 130), 1), ((4099, 33, 65), 1), ((130, 200, 9), 1),
              ((1000, 72, 136), 1)]),
            ("dgrad", dgrad_case, wg_shapes,
             [((2, 9, 24, 40, 3, 1), 1), ((3, 7, 19, 77, 1, 0), 1)]),
            ("block", block_case, block_shapes,
             [((2, 9, 24, 16), 1), ((1, 7, 256, 64), 1)]),
            ("pool", pool_case, pool_shapes,
             [((2, 13, 12, 3, 2, 6, False), 1), ((2, 7, 24, 7, 1, 1, True), 1),
              ((2, 14, 16, 3, 2, 7, False), 1), ((2, 14, 16, 3, 2, 7, True), 1)]),
            ("s2d", s2d_case, s2d_shapes, [((2, 31, 3, 16, 7, 2, 3), 1)])):
        # the GEMM core's kinds, and K5, whose wgmma path is the core's
        core = kname in ("sgemm", "conv", "dgrad", "s2d", "atb", "atb_dense")
        k5 = kname in ("atb", "atb_dense")
        # kernels timed in a CUDA graph as well (device time): the core's, K5, K6, K8
        graphed = core or kname in ("block", "pool")
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, max_abs_err=0.0, max_rel_err=0.0,
                   bound_ms=0.0, bytes_bound_ms=0.0, ops_bound_ms=0.0, device_ms=0.0,
                   library_device_ms=0.0)
        print(f"[{kname}] shape -> max|err|/max|ref|, kernel ms, plain f32 ms, "
              f"bf16 library ms, bound ms, count per pass (GEMM core: kernel and library "
              f"device ms in a CUDA graph, the plan) ({card})")
        # (dtype, signature, count per pass, timed): the ragged extras in f32
        # (and, for K5, in bf16 too: its path by shape), then the pass's own
        # shapes in bf16, timed
        cases = [(torch.float32, sig, count, False) for sig, count in extra]
        if k5 or kname in ("block", "pool"):
            cases += [(torch.bfloat16, sig, count, False) for sig, count in extra]
        cases += [(torch.bfloat16, sig, count, True) for sig, count in shapes.items()]
        for dt, sig, count, timed in cases:
            paths = dict(matmul_atb.paths)
            bpaths = dict(bottleneck.paths)
            ppaths = dict(pool2d.paths)
            out, ref, (fk, fp, fl) = case(*sig, dt)
            torch.cuda.synchronize()
            ae, re = rel_err(out, ref)
            check(bool(torch.isfinite(out.float()).all()), f"{kname} {sig} non-finite")
            check(re <= TOL[dt], f"{kname} {sig} {dt}: rel err {re:.3g} > {TOL[dt]}")
            if kname == "pool" and not sig[-1]:
                check(torch.equal(out, ref), f"max pool {sig} {dt} not exact")
            if k5:  # the path K5 took, by shape: wgmma for bf16 with 16-byte rows
                ran = [q for q in paths if matmul_atb.paths[q] == paths[q] + 1]
                m, n = (sig[2], sig[3]) if kname == "atb" else (sig[1], sig[2])
                want = ("fma" if dt == torch.float32 else
                        "wgmma" if m % 8 == 0 and n % 8 == 0 else "mma")
                check(ran == [want], f"{kname} {sig} {dt}: path {ran}, expected {want}")
                check(not timed or want == "wgmma", f"{kname} {sig}: a b{BATCH} shape "
                      "off the wgmma path")
                if matmul_atb.last_plan.split > 1:
                    check(torch.equal(out, fk()), f"{kname} {sig} {dt}: split-K not "
                          "bit-equal across two calls")
            if kname == "block":  # K6's route by shape: wgmma for bf16 with C, K % 64 == 0
                ran = [q for q in bpaths if bottleneck.paths[q] == bpaths[q] + 1]
                want = block_route(sig[2], sig[3], dt)
                check(ran == [want], f"block {sig} {dt}: path {ran}, expected {want}")
                check(not timed or want == "wgmma", f"block {sig}: a b{BATCH} shape off "
                      "the wgmma path")
                check(not timed or torch.equal(out, fk()), f"block {sig}: two calls differ")
            if kname == "pool":  # K8's route by shape: rows / window / thread
                ran = [q for q in ppaths if pool2d.paths[q] == ppaths[q] + 1]
                _, h_, c_, k_, s_, oy_, avg_ = sig
                want = pool_route(h_, c_, (k_, k_), (s_, s_), oy_, oy_, avg_, dt)
                check(ran == [want], f"pool {sig} {dt}: route {ran}, expected {want}")
                check(not timed or want == POOL_B32_ROUTES.get(sig),
                      f"pool {sig}: route {want}, expected {POOL_B32_ROUTES.get(sig)}")
            if timed:
                plan = (plan_str(last_plan.get(kname, conv2d).last_plan) if core else
                        block_plan_str(bottleneck.last_plan) if kname == "block" else
                        pool_plan_str(pool2d.last_plan))
                ms, pms, lms = cuda_ms(fk), cuda_ms(fp), cuda_ms(fl)
                dms, dlms = (graph_time(fk) * 1e3, graph_time(fl) * 1e3) if graphed else (0.0, 0.0)
                tot["device_ms"] += dms * count
                tot["library_device_ms"] += dlms * count
                b_ms, o_ms = work(kname, sig)
                tot["ms"] += ms * count
                tot["plain_ms"] += pms * count
                tot["library_ms"] += lms * count
                tot["bound_ms"] += max(b_ms, o_ms) * count
                tot["bytes_bound_ms" if b_ms >= o_ms else "ops_bound_ms"] += \
                    max(b_ms, o_ms) * count
                tot["max_abs_err"] = max(tot["max_abs_err"], ae)
                tot["max_rel_err"] = max(tot["max_rel_err"], re)
                print(f"[{kname}] bf16 {sig}: {re:.2e} {ms:.4f} {pms:.4f} {lms:.4f} "
                      f"bound {max(b_ms, o_ms):.4f} x{count}"
                      + (f" device {dms:.4f} library device {dlms:.4f} plan {plan}"
                         if graphed else ""))
                if kname == "block":  # the per-stage line: device µs in a CUDA graph
                    stage = {56: "res2", 28: "res3", 14: "res4", 7: "res5"}.get(sig[1], "?")
                    print(f"[block] stage {stage} {sig} x{count}: {dms * 1e3:.1f} us, plan "
                          f"{plan}, bound {max(b_ms, o_ms) * 1e3:.1f} us "
                          f"({'bytes' if b_ms >= o_ms else 'operations'}), library "
                          f"{dlms * 1e3:.1f} us ({card})")
                if kname == "pool":  # the per-stage line: device µs in a CUDA graph
                    stage = {112: "pool1", 7: "pool5"}.get(sig[1], "?")
                    print(f"[pool] stage {stage} {sig} x{count}: {dms * 1e3:.2f} us, plan "
                          f"{plan}, bound {max(b_ms, o_ms) * 1e3:.2f} us "
                          f"({'bytes' if b_ms >= o_ms else 'operations'}), library "
                          f"{dlms * 1e3:.2f} us ({card})")
            else:
                print(f"[{kname}] {str(dt)[6:]} {sig}: {re:.2e} (tol {TOL[dt]})"
                      + (f" plan {plan_str(matmul_atb.last_plan)}" if k5 else ""))
            del out, ref
        per = {"sgemm": "forward", "conv": "forward", "block": "fused forward",
               "pool": "fused forward", "s2d": "fused forward"}.get(kname, "backward")
        print(f"[{kname}] per {per}: kernel {tot['ms']:.3f} ms, plain f32 "
              f"{tot['plain_ms']:.3f} ms, bf16 library {tot['library_ms']:.3f} ms, "
              f"bound {tot['bound_ms']:.4f} ms"
              + (f"; device: kernel {tot['device_ms']:.3f} ms, library "
                 f"{tot['library_device_ms']:.3f} ms" if graphed else ""))
        summary[kname] = tot

    # -- phase 2b: K9, the elementwise kernel, bit for bit ----------------------------
    # at ResNet-50 b32's largest residual add (32x256x56x56), at n = 777 and at
    # a view one element off 16-byte alignment (the scalar path and tail);
    # NaN, +-0 and +-inf among the inputs
    elt_n = BATCH * 256 * 56 * 56
    special = torch.tensor([float("nan"), -0.0, 0.0, float("inf"), -float("inf"), -1.5],
                           device=dev)
    elt_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        a0 = rnd((elt_n + 1,), dt)
        b0 = rnd((elt_n + 1,), dt)
        a0[:6], b0[:6] = special.to(dt), special.flip(0).to(dt)
        # (x, y, what, the path it must take)
        for x, y, what, want in ((a0[:elt_n], b0[:elt_n], f"n={elt_n}", "ring"),
                                 (a0[:777], b0[:777], "n=777", "ring"),
                                 (a0[1:], b0[1:], f"n={elt_n} misaligned", "scalar")):
            for func in ELT_FUNCS:
                ins = (x, y) if func in ("mul", "add", "sub", "max") else (x,)
                before = dict(eltwise.paths)
                out, ref = eltwise(func, *ins), eltwise_plain(func, *ins)
                torch.cuda.synchronize()
                ran = [q for q in before if eltwise.paths[q] == before[q] + 1]
                check(ran == [want], f"eltwise {func} {dt} {what}: path {ran}, expected {want}")
                check(torch.equal(bits(out), bits(ref)),
                      f"eltwise {func} {dt} {what}: not bit-equal to its plain version")
                fin = torch.isfinite(ref.float())
                elt_err = max(elt_err, float((out.float() - ref.float())[fin].abs().max()))
        print(f"[eltwise] {dt}: 7 funcs x (n={elt_n}, n=777 on the ring; a misaligned "
              f"view of n={elt_n} on the scalar path) bit-equal to the plain version (NaN, "
              f"+-0, +-inf included)")
    x, y = a0[:elt_n], b0[:elt_n]  # bf16, the corpus's eltwise signature
    # device time in a CUDA graph; back-to-back launches (host included) beside it
    elt_t = {"ms": graph_time(lambda: eltwise("add", x, y)) * 1e3,
             "launch_ms": cuda_ms(lambda: eltwise("add", x, y)),
             "plain_ms": cuda_ms(lambda: eltwise_plain("add", x, y)),
             "library_ms": graph_time(lambda: torch.add(x, y)) * 1e3,
             "library_launch_ms": cuda_ms(lambda: torch.add(x, y)),
             "bound_ms": 3 * elt_n * 2 / HBM_BPS * 1e3, "max_abs_err": elt_err}
    elt_plan = eltwise.last_plan
    check(elt_plan.path == "ring", f"eltwise b{BATCH} add: plan {elt_plan}")
    for func, lib_fn in (("mul", torch.mul), ("relu", torch.relu)):
        ins = (x, y) if func == "mul" else (x,)
        print(f"[eltwise] bf16 {func} n={elt_n}: kernel device "
              f"{graph_time(lambda: eltwise(func, *ins)) * 1e6:.2f} us, torch.{lib_fn.__name__} "
              f"device {graph_time(lambda: lib_fn(*ins)) * 1e6:.2f} us, bound "
              f"{(len(ins) + 1) * elt_n * 2 / HBM_BPS * 1e6:.2f} us")
    print(f"[eltwise] bf16 add n={elt_n}: kernel device {elt_t['ms'] * 1e3:.2f} us "
          f"(launched {elt_t['launch_ms'] * 1e3:.2f}), plain {elt_t['plain_ms'] * 1e3:.1f} us, "
          f"torch.add device {elt_t['library_ms'] * 1e3:.2f} us (launched "
          f"{elt_t['library_launch_ms'] * 1e3:.2f}), bound {elt_t['bound_ms'] * 1e3:.2f} us, "
          f"plan {elt_plan} ({card})")
    del a0, b0, x, y

    # -- phase 2c: K7, the fused stem, at the b32 stem --------------------------------
    srng = np.random.default_rng(7)
    for dt in (torch.float32, torch.bfloat16):
        (x6, w2, sb), xsd, wf, kh, pooled = stem_inputs(BATCH, 224, 64, dt, srng)
        kw = dict(kh=kh, poh=pooled, pow_=pooled, relu=True)
        out, ref = stem_fused(x6, w2, sb, **kw), stem_fused_plain(x6, w2, sb, **kw)
        torch.cuda.synchronize()
        ae, re = rel_err(out, ref)
        check(out.shape == (BATCH, 56, 56, 64) and bool(torch.isfinite(out.float()).all()),
              f"stem {dt}: shape {tuple(out.shape)} / non-finite")
        check(re <= TOL[dt], f"stem {dt}: rel err {re:.3g} > {TOL[dt]}")
        want = "mma" if dt == torch.bfloat16 else "fma"
        check(stem_fused.last_plan.route == want,
              f"stem {dt}: plan {stem_fused.last_plan}, expected route {want}")
        print(f"[stem] {dt} x6 {tuple(x6.shape)} w2 {tuple(w2.shape)} -> {tuple(out.shape)}: "
              f"max|err|/max|ref| {re:.2e} (tol {TOL[dt]}), plan {stem_fused.last_plan}")
    w_lib = wf.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)  # OIHW, channels_last
    xs_lib = xsd.permute(0, 3, 1, 2)

    def stem_lib():  # cuDNN's conv on the same s2d fold, bias/ReLU, the library pool
        return F.max_pool2d(torch.relu(F.conv2d(xs_lib, w_lib, sb)), 3, 2, ceil_mode=True)
    stem_bytes = 2 * (x6.numel() + w2.numel() + BATCH * pooled * pooled * 64) + 4 * 64
    stem_ops = 2 * BATCH * (x6.shape[1] - kh + 1) * x6.shape[2] * 64 * w2.shape[0]
    stem_t = {"ms": graph_time(lambda: stem_fused(x6, w2, sb, **kw)) * 1e3,
              "launch_ms": cuda_ms(lambda: stem_fused(x6, w2, sb, **kw)),
              "plain_ms": cuda_ms(lambda: stem_fused_plain(x6, w2, sb, **kw)),
              "library_ms": graph_time(stem_lib) * 1e3, "library_launch_ms": cuda_ms(stem_lib),
              "max_abs_err": ae,
              "bytes_ms": stem_bytes / HBM_BPS * 1e3, "ops_ms": stem_ops / BF16_OPS * 1e3}
    stem_t["bound_ms"] = max(stem_t["bytes_ms"], stem_t["ops_ms"])
    stem_plan = stem_fused.last_plan
    print(f"[stem] bf16 b{BATCH}: kernel device {stem_t['ms'] * 1e3:.1f} us (launched "
          f"{stem_t['launch_ms'] * 1e3:.1f}), plain {stem_t['plain_ms'] * 1e3:.1f} us, cuDNN "
          f"conv+bias/ReLU+max_pool2d device {stem_t['library_ms'] * 1e3:.1f} us (launched "
          f"{stem_t['library_launch_ms'] * 1e3:.1f}), bound {stem_t['bound_ms'] * 1e3:.1f} us "
          f"({'bytes' if stem_t['bytes_ms'] >= stem_t['ops_ms'] else 'operations'}; plan "
          f"{stem_plan}; {card})")
    del x6, w2, sb, xsd, wf, out, ref, xs_lib, w_lib

    # -- phase 2d: NaN at ReLU and max, as jnp.maximum gives it --------------------
    misses = []
    for name in NAN_CASES:
        ok, line = nan_check(name, dev)
        print(line)
        if not ok:
            misses.append(name)
    check(not misses, f"nan phase: {misses} differ from their plain versions")

    # -- phase 3: the slice: ResNet-50 b32 bf16 through the kernels -----------------
    ins = gen_data_inputs(in_dims)
    log = eng.get_info_log().splitlines()
    n_gemm = len({ln.split(":")[0] for ln in log
                  if "nhwc-k1conv" in ln or "nhwc-ip gemm" in ln})
    n_conv = len({ln.split(":")[0] for ln in log if "nhwc-direct_conv" in ln})
    check(not any("nhwc-lib_conv" in ln for ln in log), "a conv went to the library")
    eng.prepare(ins, ["prob", "fc1000"])  # the warm-up: the counts below are the capture's
    matmul.launches = conv2d.launches = 0
    matmul.paths, conv2d.paths = dict.fromkeys(matmul.paths, 0), dict.fromkeys(conv2d.paths, 0)
    outs = eng.run_fwd(ins, ["prob", "fc1000"])
    launches = {"sgemm": matmul.launches, "conv": conv2d.launches}
    check_paths("gen forward sgemm", matmul.paths, launches["sgemm"], 0)
    check_paths("gen forward conv", conv2d.paths, launches["conv"], 1)  # the C = 3 stem
    print(f"[slice] resnet50 b{BATCH} bf16 gen: launches sgemm {launches['sgemm']} "
          f"(layers {n_gemm}), conv {launches['conv']} (layers {n_conv})")
    check(launches["sgemm"] >= n_gemm > 0, "sgemm launch count below its layers")
    check(launches["conv"] >= n_conv > 0, "conv launch count below its layers")
    prob = outs["prob"].data
    check(prob.shape == (BATCH, 1000) and bool(np.isfinite(prob).all()), "prob shape/finite")
    sums = prob.sum(axis=1)
    check(bool(((sums > 0.99) & (sums < 1.01)).all()), f"prob row sums {sums.min()}..{sums.max()}")
    print(f"[slice] max|prob| {prob.max():.4g}, min {prob.min():.4g} (one-hot would be 1)")
    check(prob.max() < 0.5, "prob is saturated: the prob gates would check nothing")

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

    # -- phase 3b: the fused configuration of the same forward -----------------------
    flog = fused.get_info_log()
    check("conv1: nhwc-s2d_conv" in flog, "conv1 did not take the space-to-depth fold")
    counters = {"block": bottleneck, "pool": pool2d, "conv": conv2d, "sgemm": matmul,
                "s2d": space_to_depth_conv}
    fused.prepare(ins, ["prob", "fc1000"])
    for fn in counters.values():
        fn.launches = 0
    matmul.paths, conv2d.paths = dict.fromkeys(matmul.paths, 0), dict.fromkeys(conv2d.paths, 0)
    bottleneck.paths = dict.fromkeys(bottleneck.paths, 0)
    pool2d.paths = dict.fromkeys(pool2d.paths, 0)
    fused_outs = fused.run_fwd(ins, ["prob", "fc1000"])
    launches_fused = {k: fn.launches for k, fn in counters.items()}
    check_paths("fused forward sgemm", matmul.paths, launches_fused["sgemm"], 0)
    check_paths("fused forward conv", conv2d.paths, launches_fused["conv"], 0)
    # every bf16 b32 bottleneck on K6's wgmma route
    print(f"[fused] block paths {bottleneck.paths}")
    check(bottleneck.paths["wgmma"] == launches_fused["block"] == FUSED_LAUNCHES["block"],
          f"fused forward block paths {bottleneck.paths}")
    # pool1 on K8's rows route, pool5 on its window route
    print(f"[fused] pool paths {pool2d.paths}")
    check(pool2d.paths == FUSED_POOL_PATHS, f"fused forward pool paths {pool2d.paths}, "
          f"expected {FUSED_POOL_PATHS}")
    print(f"[fused] resnet50 b{BATCH} bf16 fuse_block=1 tune={FUSED_TUNE}: launches "
          f"{launches_fused} (expected {FUSED_LAUNCHES}); "
          f"{flog.count('block-fused bottleneck')} blocks fused")
    check(launches_fused == FUSED_LAUNCHES, "fused forward launch counts")
    fprob = fused_outs["prob"].data
    check(fprob.shape == (BATCH, 1000) and bool(np.isfinite(fprob).all()),
          "fused prob shape/finite")
    print(f"[fused] max|prob| {fprob.max():.4g}")
    for n in ("fc1000", "prob"):
        a = torch.from_numpy(fused_outs[n].data)
        for ref_name, ref in (("lib", louts), ("gen", outs)):
            _, e_ = rel_err(a, torch.from_numpy(ref[n].data))
            print(f"[fused] {n} fused vs {ref_name}: {e_:.3e} (tol {SLICE_TOL[n]})")
            check(e_ <= SLICE_TOL[n], f"fused {n} vs {ref_name} {e_:.3g}")

    # f32 at a small input, every conv node: gen kernels vs cuDNN (TF32 off);
    # and the fused configuration's block outputs, pools and stem vs cuDNN
    spipe, sdims = load_net("resnet50", img=2, in_sz=64)
    sins = gen_data_inputs(sdims)
    nodes = ["prob"] + [o.tops[0] for o in spipe.ops.values() if o.type == "Convolution"]
    sfused = make("conv_fwd", "cuda", fuse_block=True, tune=parse_lexp(FUSED_TUNE))
    sfused.init(spipe)
    fnodes = ["conv1_relu", "pool1", "pool5"] + [
        spipe.ops[sfused._chains[a][-1]].tops[0] for a in sfused._blocks]
    res = {}
    for pol in ("gen", "lib"):
        e = make("conv_fwd", "cuda", kernel_policy=pol)
        e.init(spipe)
        res[pol] = e.run_fwd(sins, nodes + (fnodes if pol == "lib" else []))
    worst = max(rel_err(torch.from_numpy(res["gen"][n].data),
                        torch.from_numpy(res["lib"][n].data))[1] for n in nodes)
    print(f"[slice] f32 resnet50 b2 64x64, {len(nodes)} nodes gen vs lib: "
          f"worst {worst:.3e} (tol {F32_NODE_TOL})")
    check(worst <= F32_NODE_TOL, "f32 per-node gen vs lib")
    sfused.prepare(sins, fnodes)
    bottleneck.launches = pool2d.launches = 0
    res["fused"] = sfused.run_fwd(sins, fnodes)
    check((bottleneck.launches, pool2d.launches) == (12, 2),
          f"f32 fused: launches block {bottleneck.launches}, pool {pool2d.launches}")
    errs = sorted((rel_err(torch.from_numpy(res["fused"][n].data),
                           torch.from_numpy(res["lib"][n].data))[1], n) for n in fnodes)
    print(f"[fused] f32 resnet50 b2 64x64, {len(fnodes)} nodes (12 blocks, pool1, pool5, "
          f"conv1_relu) fused vs lib: worst {errs[-1][0]:.3e} at {errs[-1][1]} "
          f"(tol {F32_NODE_TOL})")
    check(errs[-1][0] <= F32_NODE_TOL, "f32 fused per-node vs lib")
    del sfused, res

    # -- phase 4: the gradient graph, f32, b8: every node gen vs lib --------------
    # The random-weight net's softmax is saturated (prob one-hot), and a
    # saturated SoftmaxWithLoss passes no gradient at all (its p is under
    # the 1e-38 floor), so every gradient would be exactly 0 in both
    # engines. fc1000's weights are scaled as in the forward phases
    # (scale_fc1000); the gradient then reaches every layer, and relative
    # errors are as at any scale.
    print(f"[grad] fc1000 weights scaled by {fc_scale:.4g}, as in the forward phases")
    gpipe, gdims = load_net("resnet50", img=GRAD_F32_BATCH)
    scale_fc1000([gpipe, bpipe], fc_scale)
    add_bck_ops(gpipe)
    gdims["label"] = gpipe.nodes["label"].dims
    gins = gen_data_inputs(gdims)
    gnodes = check_nodes(gpipe)
    fwd_nodes = [n for n in gnodes if "__grad" not in n]
    grad_nodes = [n for n in gnodes if "__grad" in n]
    gengs, gres = {}, {}
    for pol in ("gen", "lib"):
        e = gengs[pol] = make("conv_fwd", "cuda", kernel_policy=pol)
        e.init(gpipe)
        glog = e.get_info_log()
        e.prepare(gins, gnodes)
        matmul.launches = conv2d.launches = matmul_atb.launches = 0
        gres[pol] = e.run_fwd(gins, gnodes)
        counts = (matmul.launches, conv2d.launches, matmul_atb.launches)
        n_bck = sum(1 for ln in glog.splitlines() if ": bck-conv" in ln)
        print(f"[grad-f32] resnet50 b{GRAD_F32_BATCH} {pol}: {len(gnodes)} nodes, "
              f"bck-conv ops {n_bck}, launches sgemm/conv/atb {counts}")
        if pol == "gen":
            n_direct = sum(1 for ln in glog.splitlines() if "nhwc-direct_conv" in ln)
            check(n_bck == 46, f"grad-f32: {n_bck} bck-conv ops, expected 46")
            check(counts[2] >= n_bck, "grad-f32: atb launches below the bck-conv ops")
            check(counts[1] >= n_direct + n_bck,
                  "grad-f32: conv launches below the forward convs + dgrads")
        else:
            check(n_bck == 0 and counts == (0, 0, 0), "grad-f32: lib launched a kernel")
    zero = [n for n in grad_nodes if not np.abs(gres["lib"][n].data).max() > 0]
    print(f"[grad-f32] {len(grad_nodes)} gradient nodes, {len(zero)} all zero; "
          f"max|data grad| {np.abs(gres['lib']['data__grad__p0'].data).max():.3e}")
    check(not zero, f"grad-f32: gradient nodes that are all zero (a dead loss): {zero[:4]}")
    rule = f"comp_vars(mrd_toler={GRAD_F32_TOL}, atol={GRAD_F32_TOL}*max|lib|)"
    # (a) each engine its own forward and backward: the forward nodes must
    # agree. The gradient nodes are reported, not gated: where the two
    # forwards put a ReLU input on opposite sides of 0 (they differ by
    # ~1e-6 relative), the ReLU's gradient there differs by a whole
    # cotangent, and that difference flows on into every earlier layer.
    fails, worst = node_agreement(gres["lib"], gres["gen"], fwd_nodes, GRAD_F32_TOL)
    print(f"[grad-f32] free run, forward nodes gen vs lib, {rule}: "
          f"{len(fwd_nodes) - len(fails)}/{len(fwd_nodes)} agree; worst "
          f"max|err|/max|lib| {worst[0]:.3e} at {worst[1]}")
    check(not fails, f"grad-f32: {len(fails)} forward nodes disagree: {fails[:3]}")
    gfails, gworst = node_agreement(gres["lib"], gres["gen"], grad_nodes, GRAD_F32_TOL)
    relu_in = [o.bots[0] for o in gpipe.ops.values() if o.type == "ReLU"]
    flips = sum(int(((gres["lib"][n].data > 0) != (gres["gen"][n].data > 0)).sum())
                for n in relu_in)
    n_relu = sum(gres["lib"][n].data.size for n in relu_in)
    print(f"[grad-f32] free run, gradient nodes: {len(grad_nodes) - len(gfails)}/"
          f"{len(grad_nodes)} agree, worst max|err|/max|lib| {gworst[0]:.3e} at "
          f"{gworst[1]}; ReLU inputs on opposite sides of 0 in gen and lib: "
          f"{flips} of {n_relu}")
    # (b) the backward alone: both engines run every Bck op from the same
    # forward values (lib's, fed in as inputs), so a ReLU mask is the same in
    # both and what differs is the backward kernels. Every gradient node must
    # agree.
    forced = dict(gins)
    forced.update({n: gres["lib"][n] for n in fwd_nodes})
    fres = {pol: gengs[pol].run_fwd(forced, grad_nodes) for pol in ("gen", "lib")}
    del gres, gengs
    fails, worst = node_agreement(fres["lib"], fres["gen"], grad_nodes, GRAD_F32_TOL)
    print(f"[grad-f32] backward from lib's forward values, gradient nodes gen vs "
          f"lib, {rule}: {len(grad_nodes) - len(fails)}/{len(grad_nodes)} agree; "
          f"worst max|err|/max|lib| {worst[0]:.3e} at {worst[1]}")
    for ln in fails[:20]:
        print(f"[grad-f32] FAIL {ln}")
    check(not fails, f"grad-f32: {len(fails)} gradient nodes disagree")
    del fres

    # -- phase 5: the gradient graph, bf16, b32: loss, input and weight grads -------
    bins = gen_data_inputs(bdims)
    bwant = ["prob_loss", "data__grad__p0"] + weight_grads(bpipe)
    bfwd = [n for n in check_nodes(bpipe) if "__grad" not in n]
    beng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    beng.init(bpipe)
    blib = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib")
    blib.init(bpipe)
    beng.prepare(bins, bwant)
    matmul.launches = conv2d.launches = matmul_atb.launches = conv2d_nhwc.launches = 0
    matmul.paths, conv2d.paths = dict.fromkeys(matmul.paths, 0), dict.fromkeys(conv2d.paths, 0)
    matmul_atb.paths = dict.fromkeys(matmul_atb.paths, 0)
    bres = {"gen": beng.run_fwd(bins, bwant)}
    launches_bck = {"sgemm": matmul.launches, "conv": conv2d.launches,
                    "atb": matmul_atb.launches, "conv_nhwc": conv2d_nhwc.launches}
    # the forward's convs and the 46 dgrads: all wgmma but the C = 3 stem
    check_paths("grad-bf16 sgemm", matmul.paths, launches_bck["sgemm"], 0)
    check_paths("grad-bf16 conv (forward + 46 dgrads)", conv2d.paths, launches_bck["conv"], 1)
    check_paths("grad-bf16 atb (46 wgrads)", matmul_atb.paths, launches_bck["atb"], 0)
    print(f"[grad-bf16] resnet50 b{BATCH} gen: launches {launches_bck} "
          f"(bck-conv ops {n_bck_conv})")
    check(launches_bck["atb"] >= n_bck_conv, "grad-bf16: atb launches below the bck-conv ops")
    check(launches_bck["conv"] >= n_bck_conv, "grad-bf16: conv launches below the dgrads")
    check(launches_bck["conv_nhwc"] == n_bck_conv, "grad-bf16: a dgrad per bck-conv op "
          "through K3's entry")
    check(launches_bck["sgemm"] > 0, "grad-bf16: no sgemm launch")
    lres = blib.run_fwd(bins, bwant + bfwd)
    bres["lib"] = {n: lres[n] for n in bwant}
    # the gate: gen's backward from lib's forward values (as in phase 4 (b))
    forced = dict(bins)
    forced.update({n: lres[n] for n in bfwd})
    del lres
    bres["gen_forced"] = beng.run_fwd(forced, bwant)
    del forced
    errs = {}
    for which in ("gen", "gen_forced"):
        errs[which] = []
        for n in bwant:
            a, b = bres["lib"][n].data, bres[which][n].data
            check(bool(np.isfinite(b).all()), f"grad-bf16 {which} {n} non-finite")
            check(np.abs(a).max() > 0, f"grad-bf16 {n} all zero")
            errs[which].append((rel_err(torch.from_numpy(b), torch.from_numpy(a))[1], n))
        errs[which].sort(reverse=True)
        e = errs[which]
        byname = {n: v for v, n in e}
        print(f"[grad-bf16] {which} vs lib, {len(bwant)} outputs, max|err|/max|lib|: "
              f"worst " + ", ".join(f"{n} {v:.3e}" for v, n in e[:4])
              + f"; median {e[len(e) // 2][0]:.3e}; loss {byname['prob_loss']:.3e}, "
              f"data grad {byname['data__grad__p0']:.3e}")
    worst = errs["gen_forced"][0]
    print(f"[grad-bf16] gate: backward from lib's forward values, worst "
          f"{worst[0]:.3e} (tol {GRAD_BF16_TOL})")
    check(worst[0] <= GRAD_BF16_TOL, f"grad-bf16: {worst[1]} {worst[0]:.3g}")
    del bres
    # [graph-grad]: the replay of each gradient graph against an eager pass of
    # the same engine, on two batches: every output bit-equal. cuDNN is held to
    # its deterministic algorithms for the comparison (its default backward
    # ones may differ between two eager passes: scripts/torch_graph_determinism.py);
    # then eager and graph ms per pass, recaptured with the default ones
    grad_rates, grad_eager_rates = {}, {}
    bins2 = other_batch(bins, 17)
    deterministic = torch.backends.cudnn.deterministic
    for pol, e in (("gen", beng), ("lib", blib)):
        torch.backends.cudnn.deterministic = True
        try:
            e.drop_graph()
            e.cuda_graph = False
            eager = e.run_fwd(bins, bwant)
            e.cuda_graph = True
            replay = e.run_fwd(bins, bwant)
            eager2, replay2 = replay_follows(e, bins2, bwant)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        e.drop_graph()
        check(not np.array_equal(eager2["data__grad__p0"].data, eager["data__grad__p0"].data),
              f"graph-grad {pol}: the second batch left the input gradient as it was")
        for batch, (ea, re_) in (("", (eager, replay)), (", a second batch", (eager2, replay2))):
            gerrs = sorted((rel_err(torch.from_numpy(re_[n].data),
                                    torch.from_numpy(ea[n].data))[1], n) for n in bwant)
            n_bit = sum(np.array_equal(re_[n].data, ea[n].data) for n in bwant)
            print(f"[graph-grad] resnet50 b{BATCH} bf16 {pol}{batch}: replay vs eager, {n_bit} "
                  f"of {len(bwant)} outputs bit-equal (all must be), worst max|err|/max|eager| "
                  f"{gerrs[-1][0]:.3e} at {gerrs[-1][1]}")
            check(n_bit == len(bwant), f"graph-grad {pol}{batch}: {len(bwant) - n_bit} outputs "
                                       f"not bit-equal, worst {gerrs[-1]}")
        del eager, replay, eager2, replay2
        e.cuda_graph = False
        eager_s = e.time_fwd(bins, bwant, n_iters=10, warmup=3)
        e.cuda_graph = True
        secs = e.time_fwd(bins, bwant, n_iters=10, warmup=5)
        grad_rates[pol], grad_eager_rates[pol] = BATCH / secs, BATCH / eager_s
        print(f"[graph-grad] resnet50 b{BATCH} forward+backward {pol}: eager "
              f"{eager_s * 1e3:.3f} ms, graph {secs * 1e3:.3f} ms per pass; "
              f"{grad_eager_rates[pol]:.1f} -> {grad_rates[pol]:.1f} img/s ({card})")
    del beng, blib

    # the user's command line, in-process
    rc, lines = run_cli(["run_cnet", "--model=resnet50", f"--img={BATCH}",
                         "--conv-fwd=(mode=cuda,compute_tn=bfloat16)", "--n-iters=10"])
    print(f"[run_cnet] rc={rc}: {lines[0] if lines else ''}")
    print(f"[run_cnet] {next((ln for ln in lines if ln.startswith('{')), '')}")
    check(rc == 0, "run_cnet failed")
    rc, lines = run_cli(["test_compute", "--model=resnet50", "--img=2", "--n-wins=1",
                         "--add-bck-ops=1", "--mrd-toler=1e-3",
                         "--engines=(lib=(mode=cuda,kernel_policy=lib),"
                         "gen=(mode=cuda,kernel_policy=gen))"])
    for ln in [ln for ln in lines if ln.startswith("FAIL")][:10] + lines[-1:]:
        print(f"[test_compute] rc={rc}: {ln}")
    check(rc == 0, "test_compute --add-bck-ops=1 failed")

    host_us = host_us_per_launch(eng, ins)
    print(f"[slice] host us per launch over the gen forward: sgemm {host_us['sgemm']:.1f}, "
          f"conv {host_us['conv']:.1f} (wrapper checks, plan, allocations, ctypes launch)")

    # -- phase 5b: [graph] each b32 forward captured once and replayed ----------------
    fwd_outs = ["prob", "fc1000"]
    ins2 = other_batch(ins, 13)
    rates, eager_rates, graph_rows = {}, {}, {}
    for pol, e in (("gen", eng), ("lib", lib), ("fused", fused)):
        e.cuda_graph = False
        zero_counts(counted)
        eager = e.run_fwd(ins, fwd_outs)
        n_eager = read_counts(counted)
        e.cuda_graph = True
        e.drop_graph()  # a fresh capture, to time it and read its memory
        e.prepare(ins, fwd_outs)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counted)
        replay = e.run_fwd(ins, fwd_outs)
        n_graph = read_counts(counted)
        cap_s, peak = e._graph.capture_secs, torch.cuda.max_memory_allocated()
        check(n_graph == n_eager, f"graph {pol}: launches {n_graph}, eager {n_eager}")
        errs_ = {n: rel_err(torch.from_numpy(replay[n].data),
                            torch.from_numpy(eager[n].data))[1] for n in fwd_outs}
        bit = {n: np.array_equal(replay[n].data, eager[n].data) for n in fwd_outs}
        if pol == "lib":
            check(all(errs_[n] <= SLICE_TOL[n] for n in fwd_outs), f"graph lib: {errs_}")
        else:
            check(all(bit.values()), f"graph {pol}: replay not bit-equal to eager {errs_}")
        # a second batch through the same graph: the replay follows its input
        eager2, replay2 = replay_follows(e, ins2, fwd_outs)
        moved = not np.array_equal(eager2["fc1000"].data, eager["fc1000"].data)
        errs2 = {n: rel_err(torch.from_numpy(replay2[n].data),
                            torch.from_numpy(eager2[n].data))[1] for n in fwd_outs}
        bit2 = {n: np.array_equal(replay2[n].data, eager2[n].data) for n in fwd_outs}
        check(moved, f"graph {pol}: the second batch left fc1000 as it was")
        if pol == "lib":
            check(all(errs2[n] <= SLICE_TOL[n] for n in fwd_outs),
                  f"graph lib, second batch: {errs2}")
        else:
            check(all(bit2.values()), f"graph {pol}, second batch: replay not bit-equal to "
                                      f"eager {errs2}")
        print(f"[graph] resnet50 b{BATCH} bf16 {pol}: a second batch through the same "
              "graph, replay vs eager "
              + ", ".join(f"{n} {'bit-equal' if bit2[n] else f'{errs2[n]:.3e}'}"
                          for n in fwd_outs))
        del eager2, replay2
        e.cuda_graph = False
        eager_s = e.time_fwd(ins, ["prob"], n_iters=20, warmup=5)
        e.cuda_graph = True
        secs = e.time_fwd(ins, ["prob"], n_iters=20, warmup=5)
        rates[pol], eager_rates[pol] = BATCH / secs, BATCH / eager_s
        graph_rows[pol] = {"eager_ms": eager_s * 1e3, "graph_ms": secs * 1e3,
                           "capture_s": cap_s, "max_memory_allocated": peak}
        print(f"[graph] resnet50 b{BATCH} bf16 {pol}: replay vs eager "
              + ", ".join(f"{n} {'bit-equal' if bit[n] else f'{errs_[n]:.3e}'}"
                          for n in fwd_outs)
              + f"; launches {n_graph} (eager the same); capture {cap_s:.3f} s, "
              f"max_memory_allocated {peak / 2 ** 30:.2f} GiB")
        print(f"[graph] resnet50 b{BATCH} bf16 {pol}: eager {eager_s * 1e3:.3f} ms/fwd "
              f"({eager_rates[pol]:.1f} img/s), graph {secs * 1e3:.3f} ms/fwd "
              f"({rates[pol]:.1f} img/s) ({card})")
        del eager, replay

    # -- phase 5c: [input_s2d] bench.py's host-folded stem ---------------------------
    xh = np.ascontiguousarray(ins["data"].data.transpose(0, 2, 3, 1))
    unfolded = {"gen": outs, "lib": louts}
    fc = outs["fc1000"].data
    print(f"[input_s2d] fc1000 across the batch's {BATCH} images (gen): max|row - row 0| / "
          f"max|fc1000| {float(np.abs(fc - fc[:1]).max() / np.abs(fc).max()):.3e}, how far "
          f"the random-weight net's output moves with its input")
    # conv1 of the unfolded forwards: the stem itself, which fc1000 cannot see
    c1_ref = {pol: E.run_fwd(ins, ["conv1"])["conv1"].data
              for pol, E in (("gen", eng), ("lib", lib))}
    s2d_rates = {}
    for pol in ("gen", "lib"):
        for pad in (0, 16):
            e = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy=pol,
                     input_s2d=True, input_pad_c=pad)
            e.init(pipe)
            elog = e.get_info_log()
            check("conv1: input_s2d on 'data'" in elog and "conv1: nhwc-stem_s2d" in elog,
                  f"input_s2d {pol} pad_c={pad}: the stem took no fold")
            xf = e.host_input_s2d("data", xh)
            fin = {"data": NDA(Dims.of(img=xf.shape[0], y=xf.shape[1], x=xf.shape[2],
                                       chan=xf.shape[3]), xf)}
            e.prepare(fin, fwd_outs)
            zero_counts(counted)
            o = e.run_fwd(fin, fwd_outs)
            stem_paths = dict(conv2d.paths)
            if pol == "gen":  # the stem through K3's entry, on wgmma like every conv
                check(conv2d_nhwc.launches == 1 and stem_paths["mma"] == 0
                      and stem_paths["wgmma"] == conv2d.launches,
                      f"input_s2d gen pad_c={pad}: conv paths {stem_paths}, "
                      f"conv2d_nhwc {conv2d_nhwc.launches}")
            if pol == "gen":
                # K3 at the fold's shape against its plain version, on the engine's
                # operands: the folded batch padded as the lowering pads it, the
                # stem's weights as folded at upload (BN prefolded), ReLU fused
                xd = e._ingest("data", torch.from_numpy(xf).to(dev))
                w, b = (e._weights_dev.get(f"{n}__folded", e._weights_dev[n])
                        for n in pipe.ops["conv1"].bots[1:])
                xs = F.pad(xd, (0, w.shape[2] - xd.shape[-1])).contiguous()
                conv2d.paths = dict.fromkeys(conv2d.paths, 0)
                got = conv2d_nhwc(xs, w, b, relu=True)
                kpaths = dict(conv2d.paths)
                _, kerr = rel_err(got, conv2d_plain(xs, w, b, relu=True))
                k_us = graph_time(lambda: conv2d_nhwc(xs, w, b, relu=True)) * 1e6
                x_nchw, w_oihw = xs.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
                l_us = graph_time(lambda: F.conv2d(x_nchw, w_oihw, b)) * 1e6
                s_bytes = sum(t.numel() * t.element_size() for t in (xs, w, b, got))
                s_ops = 2 * got.numel() * w.shape[0] * w.shape[1] * w.shape[2]
                print(f"[input_s2d] the stem on its fold, K3 {tuple(xs.shape)} * "
                      f"{tuple(w.shape)} bf16: vs conv2d_plain {kerr:.3e} (tol "
                      f"{STEM_FOLD_TOL}), paths {kpaths}; device {k_us:.1f} us, cuDNN on "
                      f"the same fold {l_us:.1f} us, bound {s_bytes / HBM_BPS * 1e6:.1f} us "
                      f"(bytes) / {s_ops / BF16_OPS * 1e6:.1f} us (operations) ({card})")
                check(kpaths["wgmma"] == 1 and kerr <= STEM_FOLD_TOL,
                      f"input_s2d gen pad_c={pad}: the stem kernel {kerr:.3g}, {kpaths}")
                del xd, w, b, xs, got, x_nchw, w_oihw
            errs_ = {n: rel_err(torch.from_numpy(o[n].data),
                                torch.from_numpy(unfolded[pol][n].data))[1] for n in fwd_outs}
            check(all(errs_[n] <= SLICE_TOL[n] for n in fwd_outs),
                  f"input_s2d {pol} pad_c={pad} vs unfolded: {errs_}")
            secs = e.time_fwd(fin, ["prob"], n_iters=20, warmup=5)
            s2d_rates[f"{pol}_pad{pad}"] = BATCH / secs
            _, c1err = rel_err(torch.from_numpy(e.run_fwd(fin, ["conv1"])["conv1"].data),
                               torch.from_numpy(c1_ref[pol]))
            print(f"[input_s2d] resnet50 b{BATCH} bf16 {pol} input_pad_c={pad}: input "
                  f"{tuple(xf.shape)}; vs the unfolded forward "
                  + ", ".join(f"{n} {errs_[n]:.3e}" for n in fwd_outs)
                  + f" (tol 5e-2), conv1 {c1err:.3e} (tol {STEM_FOLD_TOL}); conv paths "
                  f"{stem_paths}; graph {secs * 1e3:.3f} ms/fwd, {BATCH / secs:.1f} img/s "
                  f"({card})")
            check(c1err <= STEM_FOLD_TOL, f"input_s2d {pol} pad_c={pad}: conv1 {c1err:.3g}")
            del e, o
    # f32 b2 64x64: conv1 on the fold against the unfolded engine's
    xh2 = np.ascontiguousarray(sins["data"].data.transpose(0, 2, 3, 1))
    for pol in ("gen", "lib"):
        e0 = make("conv_fwd", "cuda", kernel_policy=pol)
        e0.init(spipe)
        ref = torch.from_numpy(e0.run_fwd(sins, ["conv1"])["conv1"].data)
        for pad in (0, 16):
            e = make("conv_fwd", "cuda", kernel_policy=pol, input_s2d=True, input_pad_c=pad)
            e.init(spipe)
            xf = e.host_input_s2d("data", xh2)
            fin = {"data": NDA(Dims.of(img=2, y=xf.shape[1], x=xf.shape[2],
                                       chan=xf.shape[3]), xf)}
            _, err = rel_err(torch.from_numpy(e.run_fwd(fin, ["conv1"])["conv1"].data), ref)
            print(f"[input_s2d] f32 resnet50 b2 64x64 {pol} input_pad_c={pad}: conv1 vs the "
                  f"unfolded engine {err:.3e} (tol {F32_NODE_TOL})")
            check(err <= F32_NODE_TOL, f"input_s2d f32 {pol} pad_c={pad}: conv1 {err:.3g}")
        del e0, e

    # -- phase 5d: [stats] per_layer_stats and quantize, card against CPU -------------
    q = parse_lexp(STATS_QUANT)
    st = {}
    for d in ("cuda", "cpu"):
        e = make("conv_fwd", "cuda", device=d, per_layer_stats=True, quantize=dict(q.kids))
        e.init(spipe)
        o = e.run_fwd(sins, ["conv1", "prob"])
        st[d] = (o, e._last_stats, e.get_info_log().count("var_stats "))
    (co, cs, cl), (po, ps, pl) = st["cuda"], st["cpu"]
    check(cl == pl > 0 and sorted(cs) == sorted(ps), f"stats: nodes {sorted(cs)[:3]}..")
    worst = 0.0
    for n, (mn, mx, sm, sq) in ps.items():
        g_ = cs[n]
        scale = max(abs(mn), abs(mx), 1e-30)
        cnt = spipe.must_dims(n).num_elems()
        worst = max(worst, abs(g_[0] - mn) / scale, abs(g_[1] - mx) / scale,
                    abs(g_[2] - sm) / max(np.sqrt(cnt * sq), 1e-30),
                    abs(g_[3] - sq) / max(sq, 1e-30))
    quantum = STATS_QUANT_STEP
    dq = np.abs(co["conv1"].data - po["conv1"].data)
    off = int((dq > 0).sum())
    print(f"[stats] f32 resnet50 b2 64x64 gen: {len(cs)} nodes' var_stats on the card vs the "
          f"CPU, worst relative {worst:.3e} (tol {STATS_TOL}); quantized conv1: {off} of "
          f"{dq.size} elements one quantum ({quantum}) apart, max diff {dq.max():.3g}")
    check(worst <= STATS_TOL, f"stats: worst {worst:.3g}")
    check(bool(np.all(dq <= quantum * (1 + 1e-6))), "quantize: more than one quantum apart")
    del st, co, po

    # -- phase 5e: [run_cnet] per-layer times ----------------------------------------
    out_dir = build.BUILD_DIR.parent / "chip_smoke"
    out_dir.mkdir(parents=True, exist_ok=True)
    rc, lines = run_cli(["run_cnet", "--model=resnet50", f"--img={BATCH}", "--n-iters=20",
                         "--conv-fwd=(mode=cuda,compute_tn=bfloat16)",
                         f"--boda-output-dir={out_dir}", "--per-layer-fn=per_layer.txt"])
    pl_lines = (out_dir / "per_layer.txt").read_text().splitlines() if rc == 0 else []
    times = sorted(((float(ln.split("=", 1)[1]), ln.split("'")[1]) for ln in pl_lines),
                   reverse=True)
    print(f"[run_cnet] --per-layer-fn rc={rc}: {len(pl_lines)} lines for {len(pipe.ops)} ops, "
          f"sum {sum(t for t, _ in times) * 1e3:.3f} ms; slowest "
          + ", ".join(f"{n} {t * 1e6:.1f} us" for t, n in times[:4]) + f" ({card})")
    print(f"[run_cnet] {next((ln for ln in lines if ln.startswith('{')), '')}")
    check(rc == 0 and len(pl_lines) == len(pipe.ops), "run_cnet --per-layer-fn")

    # -- phase 6: the rtc layer and per-op autotuning, through the CLI ---------------
    for fn in (eltwise, matmul, conv2d, space_to_depth_conv, stem_fused):
        fn.launches = 0
    eltwise.paths = dict.fromkeys(eltwise.paths, 0)
    rc, lines = run_cli(["rtc_test", "--be=(be=cuda)", "--n=1000000"])
    print(f"[rtc] rtc_test rc={rc}: {lines[-1] if lines else ''}")
    check(rc == 0 and "PASS" in lines[-1], "rtc_test on be=cuda")
    sg = {}
    for tn, extra in (("float32", []), ("bfloat16", ["--check=0"])):
        rc, lines = run_cli(["sgemm_run", "--be=(be=cuda)", "--M=4096", "--K=4096",
                             "--N=4096", f"--tn={tn}", *extra])
        for ln in lines:
            print(f"[rtc] sgemm_run {tn} rc={rc}: {ln}")
        check(rc == 0, f"sgemm_run {tn} 4096^3")
        if tn == "float32":
            check(any(ln.startswith("check: PASS") for ln in lines), "sgemm_run f32 check")
        sg[tn] = json.loads(lines[-1])
    corpus, wis_fn = out_dir / "prof-ops.txt", out_dir / "resnet50-bf16.wis"
    rc, lines = run_cli(["gen_prof_ops", "--model=resnet50", f"--img={BATCH}",
                         "--tn=bfloat16", f"--boda-output-dir={out_dir}",
                         f"--out-fn={corpus.name}"])
    print(f"[rtc] gen_prof_ops rc={rc}: {lines[-1] if lines else ''}")
    check(rc == 0, "gen_prof_ops")
    ed = f"(img={BATCH},chan=256,y=56,x=56,__tn__=bfloat16)"
    with open(corpus, "a") as f:  # the largest residual add, so K9 is profiled too
        f.write(f"(type=eltwise,func=add,a={ed},b={ed},out={ed})\n")
    n_sigs = len(corpus.read_text().splitlines())
    rc, lines = run_cli(["ops_prof", "--be=(be=cuda)", f"--ops-fn={corpus}",
                         f"--op-tunes={RTC_TUNES}", f"--mrd-toler={RTC_MRD_TOLER}",
                         f"--wisdom-out-fn={wis_fn}"])
    fails = [ln for ln in lines if ln.startswith("FAIL")]
    for ln in fails[:10] + lines[-1:]:
        print(f"[rtc] ops_prof rc={rc}: {ln}")
    from boda_tpu_torch.prof.wisdom import read_wisdom
    wis = read_wisdom(str(wis_fn))
    runs = sum(len(w.runs) for w in wis)
    print(f"[rtc] ops_prof {RTC_TUNES} --mrd-toler={RTC_MRD_TOLER}: {len(wis)} ops of "
          f"{n_sigs}, {runs} runs recorded, {len(fails)} FAIL lines")
    check(rc == 0 and not fails and len(wis) == n_sigs and runs == 3 * n_sigs,
          "ops_prof: every tune of every signature must pass the cross-tune check")
    for w in wis:  # us per tune (paired A/B), per signature
        d = w.op.dims("out" if w.op.type != "sgemm" else "c")
        what = (f"{w.op.type} s{w.op.sval('stride', '1')} k{w.op.dims('filts')['y']} "
                f"{w.op.dims('in')['chan']}->{d['chan']} @{d['y']}" if w.op.type == "conv"
                else f"{w.op.type} {'x'.join(map(str, d.shape))}")
        print(f"[rtc] ops_prof {what}: " + ", ".join(
            f"{r.tune} {r.secs * 1e6:.1f}" for r in w.runs) + " us")
    rc, lines = run_cli(["wis_ana", f"--wisdom-fn={wis_fn}"])
    print(f"[rtc] wis_ana rc={rc}: {lines[-1] if lines else ''}")
    check(rc == 0, "wis_ana")
    wins = {}
    for ln in lines:
        if "best" in ln and "tune=" in ln:
            t = ln.split("tune=")[1]
            wins[t] = wins.get(t, 0) + 1
    print(f"[rtc] wis_ana best tunes: {wins}")
    wcfg = f"(mode=cuda,compute_tn=bfloat16,wisdom_fn={wis_fn})"
    rc, lines = run_cli(["run_cnet", "--model=resnet50", f"--img={BATCH}",
                         f"--conv-fwd={wcfg}", "--n-iters=10"])
    print(f"[rtc] run_cnet --conv-fwd={wcfg} rc={rc}: "
          f"{next((ln for ln in lines if ln.startswith('{')), '')}")
    check(rc == 0, "run_cnet with wisdom_fn")
    tuned = {ln.split(":")[0] for ln in lines if ": wisdom tune " in ln}
    want = {n for n, o in pipe.ops.items() if o.type in ("Convolution", "InnerProduct")}
    print(f"[rtc] run_cnet: a wisdom tune for {len(tuned & want)} of {len(want)} convs+fc")
    check(want <= tuned, f"no wisdom tune for {sorted(want - tuned)[:5]}")
    launches_rtc = {"eltwise": eltwise.launches, "sgemm": matmul.launches,
                    "conv": conv2d.launches, "s2d": space_to_depth_conv.launches}
    print(f"[rtc] launches on the rtc path: {launches_rtc}; eltwise paths {eltwise.paths}")
    check(min(launches_rtc.values()) > 0 and stem_fused.launches == 0,
          "the rtc path must launch eltwise, sgemm, conv and s2d (and no stem)")
    weng = make("conv_fwd", "cuda", compute_tn="bfloat16", wisdom_fn=str(wis_fn))
    weng.init(pipe)
    wouts = weng.run_fwd(ins, ["fc1000"])
    _, e_w = rel_err(torch.from_numpy(wouts["fc1000"].data),
                     torch.from_numpy(louts["fc1000"].data))
    print(f"[rtc] fc1000 wisdom-tuned vs lib: {e_w:.3e} (tol {SLICE_TOL['fc1000']})")
    check(e_w <= SLICE_TOL["fc1000"], f"wisdom-tuned fc1000 vs lib {e_w:.3g}")
    del weng

    # -- phase 7: [caffe] the Caffe frontend; GoogLeNet b32 bf16 read back ------------
    caffe = caffe_phase(card, out_dir, counted, {"gemm": gemm_case, "conv": conv_case,
                                                 "pool": pool_case, "s2d": s2d_case})
    g_gen, g_fused = caffe["googlenet"]["gen"]["launches"], caffe["googlenet"]["fused"]["launches"]

    # per kernel: launches on its main path (the forward for sgemm and conv,
    # the b32 bf16 gradient graph for atb and for K3's entry, the dgrads,
    # the fused forward for block, pool and s2d), and that path's per-pass
    # times and bound
    launches["atb"] = launches_bck["atb"]
    launches["dgrad"] = launches_bck["conv_nhwc"]
    for k in ("block", "pool", "s2d"):
        launches[k] = launches_fused[k]
    kernels = []
    for kname, src, rep in (("sgemm", "boda_tpu_torch/csrc/sgemm.cu",
                             "boda_tpu/ops/kernels/sgemm.py:80"),
                            ("conv", "boda_tpu_torch/csrc/conv.cu",
                             "boda_tpu/ops/kernels/conv.py:575"),
                            ("dgrad", "boda_tpu_torch/csrc/conv.cu",
                             "boda_tpu/ops/kernels/conv.py:103"),
                            ("atb", "boda_tpu_torch/csrc/atb.cu",
                             "boda_tpu/ops/kernels/bconv.py:53"),
                            ("block", "boda_tpu_torch/csrc/block.cu",
                             "boda_tpu/ops/kernels/block.py:111"),
                            ("pool", "boda_tpu_torch/csrc/pool.cu",
                             "boda_tpu/ops/kernels/pool.py:253"),
                            ("s2d", "boda_tpu_torch/csrc/conv.cu",
                             "boda_tpu/ops/kernels/conv.py:664")):
        t = summary[kname]
        entry = {"name": kname, "route": "cuda", "source": src, "replaces": rep,
                 "launches": launches[kname], "max_abs_err": t["max_abs_err"],
                 "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                 "bound_by": ("bytes" if t["bytes_bound_ms"] >= t["ops_bound_ms"]
                              else "operations"),
                 "library_ms": t["library_ms"], "max_rel_err": t["max_rel_err"]}
        if kname in ("sgemm", "conv", "dgrad", "s2d", "atb", "block", "pool"):
            # the GEMM core's kernels, K5, K6 and K8 take about as long as
            # the host's ~40 us per launch or less: their times, and the
            # library's, are the CUDA-graph device times; back-to-back
            # launches (host included) beside them
            entry.update(ms=t["device_ms"], library_ms=t["library_device_ms"],
                         launch_ms=t["ms"], library_launch_ms=t["library_ms"])
        if kname in ("sgemm", "conv", "atb"):
            entry["launches_bck"] = launches_bck[kname]
        if kname in ("sgemm", "conv"):
            entry["launches_fused"] = launches_fused[kname]
        if kname == "dgrad":  # K3's entry, conv2d_nhwc, on the conv kernel
            entry["entry"] = "boda_tpu_torch/ops/kernels/conv.py:conv2d_nhwc"
        if kname == "atb":
            d = summary["atb_dense"]
            entry.update({"dense_ms": d["device_ms"], "dense_plain_ms": d["plain_ms"],
                          "dense_library_ms": d["library_device_ms"],
                          "dense_launch_ms": d["ms"],
                          "dense_bound_ms": d["bound_ms"],
                          "dense_max_abs_err": d["max_abs_err"]})
        if kname == "s2d":  # the fold runs in PyTorch, the conv on conv.cu
            entry["fold"] = "boda_tpu_torch/ops/kernels/conv.py:space_to_depth_conv"
        if kname in launches_rtc:
            entry["launches_rtc"] = launches_rtc[kname]
        if kname in ("sgemm", "conv", "pool", "s2d"):  # the [caffe] phase's GoogLeNet,
            # from the run whose path the kernel is on
            entry["launches_googlenet"] = (g_gen if kname in ("sgemm", "conv")
                                           else g_fused)[kname]
        kernels.append(entry)
    # K9 on the rtc path (rtc_test, ops_prof); K7 on no path (as in boda_tpu:
    # tests only); times of one call at the b32 shapes
    kernels.append({"name": "eltwise", "route": "cuda", "source": "boda_tpu_torch/csrc/eltwise.cu",
                    "replaces": "boda_tpu/ops/kernels/elementwise.py:47",
                    "launches": launches_rtc["eltwise"], "max_abs_err": elt_t["max_abs_err"],
                    "ms": elt_t["ms"], "plain_ms": elt_t["plain_ms"],
                    "bound_ms": elt_t["bound_ms"], "bound_by": "bytes",
                    "library_ms": elt_t["library_ms"], "launch_ms": elt_t["launch_ms"],
                    "library_launch_ms": elt_t["library_launch_ms"], "path": "rtc"})
    kernels.append({"name": "stem", "route": "cuda", "source": "boda_tpu_torch/csrc/stem.cu",
                    "replaces": "boda_tpu/ops/kernels/stem.py:121",
                    "launches": 0, "max_abs_err": stem_t["max_abs_err"],
                    "ms": stem_t["ms"], "plain_ms": stem_t["plain_ms"],
                    "bound_ms": stem_t["bound_ms"],
                    "bound_by": "bytes" if stem_t["bytes_ms"] >= stem_t["ops_ms"] else "operations",
                    "library_ms": stem_t["library_ms"], "launch_ms": stem_t["launch_ms"],
                    "library_launch_ms": stem_t["library_launch_ms"],
                    "plan": stem_plan._asdict(),
                    "path": "none: no engine routes to it, as in boda_tpu"})
    print(json.dumps({"kernels": kernels, "img_per_s": rates, "img_per_s_eager": eager_rates,
                      "graph": graph_rows, "input_s2d_img_per_s": s2d_rates,
                      "host_us_per_launch": host_us, "grad_img_per_s": grad_rates,
                      "grad_img_per_s_eager": grad_eager_rates,
                      "sgemm_run_4096": {tn: {k: r[k] for k in ("secs", "GF/s", "pct_peak")}
                                         for tn, r in sg.items()},
                      "caffe": caffe, "card": card}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
