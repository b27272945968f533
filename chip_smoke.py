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
* the graph-level backward (add_bck_ops): f32 at b4, every node gen vs lib
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

Then [int8]: ResNet-50 b32 int8-static in bench.py's configuration
(``input_s2d=1`` with the host fold, ``calib_fn`` the committed
testdata/calib/resnet50-bf16.calib.json, bf16), captured and replayed:
every conv but the stem and fc1000 on cuBLASLt's int8 GEMM
(``torch._int_mm``, ops/int8.py; no hand kernel) with a static scale, the
stem on K3's entry; top-1 agreement with the bf16 forward >= 0.97 on the
gen-data batch and >= 0.95 on testdata/images tiled to the batch
(bench.py's gates; skipped, with a line saying why, without PIL); replay
bit-equal to eager on two batches; every int8 GEMM call of the forward
bit-equal to the exact product of its operands; int8-static, int8-dynamic,
act_int8 (the ReLU outputs stored as int8) and bf16 ms per replay, and per
op int8 against bf16. [lmdb]: net_calib on each trained shapesnet's train
records, test_lmdb on its test records in f32, bf16 and int8 (the goldens
in f32, int8's line equal to f32's), and Deconvolution, Sigmoid, TanH and
Reduce each in a small net, f32 on the card against the CPU.

Before them, [caffe-grad]: GoogLeNet's gradient graph (googlenet_conv b32
224x224 bf16, add_bck_ops) captured and replayed under gen and lib: gen's
launches per kernel exact as the pipe gives them (K1 the 1x1s and the
classifier, K2 the k x k forwards, K3's entry and K5 every stride-1 conv's
dgrad and wgrad; the strided stem's backward the library's), on wgmma but
the C = 3 stem, which takes the narrow fill; every distinct K1, K2, K3 and K5 call of gen's pass (the
1x1, 3x3 and 5x5 dgrads, the 1-, 9- and 25-tap wgrads) against its plain
version on the engine's own operands; gen's backward from lib's forward
values against lib on every output; each replay bit-equal to eager on two
batches under cuDNN's deterministic algorithms; eager and graph ms per pass.

Then [train]: the training step (parallel/train.py) at ResNet-50 b32 bf16
and b8 f32, gen against lib (the loss and the running stats of free runs;
the gradients of gen's step forced to lib's conv and fc outputs), the gen
step's launches per wrapper exact with the library's conv backward only at
the strided k > 1 stem, each distinct K1, K2, K3 and K5 call of that step
against its plain version, the compiled step (the step captured once per
key as one CUDA graph and replayed, train_bench's and train_lmdb's default
on the card) against the eager step from the same weights on two batches, gen and
lib, BN frozen and in train mode, bit for bit under cuDNN's deterministic
algorithms, a cosine schedule replayed with one capture, the kernels of a
replay equal to an eager step's, a planted capture failure raising, then
train_bench with ``--cuda-graph=1`` and ``=0`` under gen and lib with BN
frozen and in train mode, tests/test_learning.py's deep gate through
train_lmdb and test_lmdb --ckpt-fn, bn_freeze_at, and kill-and-resume.

Then [tools]: rtc's tooling through the CLI at ResNet-50 b32 bf16 gen
(``tools_phase``): net_trace --per-op (the share of kernel time on graph
ops, the conv and fc rows on the hand kernels, the total per forward
against an eager forward's device-busy time, the replay beside it),
train_trace with BN frozen and in train mode (the rollup against the
trace's kernel total, every conv's forward and backward rows, K3's and
K5's kernels in backward rows only), net_ab gen against lib, net_tune with
its wisdom read back by run_cnet, cnn_prof and cnn_op_info timed,
net_decomp, and the ipc backend: cs_test_master and sgemm through a worker
on the card over fds: and tcp:, bit-equal to the call in process.

Then [serve]: the serving path (modes/serve_bench.py): what the machine
has (the native library, pyzmq, PIL); the preprocess on the card bit-equal
to the host's; the served ResNet-50 b32 bf16 gen forward (preprocess+net
captured as one CUDA graph from a uint8 RGBA batch) bit-equal to the
engine's replay of the host-preprocessed batch, launching K1 37 and K2 17
times; pinned host buffers, uploads on a stream of their own, and the last
batch of a pipelined run bit-equal to a serial run; every batch that a
stand-in loader writes into the pinned buffers (more batches than buffers)
served bit-equal to the engine's replay of it; serve_bench and
serve_stages at full width through the CLI, or, where the native library
does not build (no libjpeg headers), their error and the same served
function on PIL-decoded batches, the decode stage not measured; their
goldens; zmq_det_server's b1 f32 logits (fc1000, all 1000) equal to
cnet_predict's on the card and held to the CPU's; cnet_predict f32 on the
card against the CPU: its logits, and its p over all classes with fc1000
scaled so that the top p is 0.3, off one-hot. And [corpus]: the port's
test_all with its slow suites (test_cmds on the repo corpus, the streams,
display and proc_pipe entries among them, then every test_compute suite of
testdata/test_all.xml, the gradient matrix's included), every entry
outside its skip tables passing.

Then [mesh]: the engine's ``mesh`` (parallel/mesh.py) on a 2-device mesh
(the first two cards, or cuda:0 twice on a one-card machine) at ResNet-50
b32 bf16: gen and fused (dp=2) replayed, each half bit-equal to the no-mesh
replay at b16 with twice its launches; lib (dp=2,tp=2) against the no-mesh
lib forward; gen (tp=2) refused; ms per forward beside the no-mesh b32; and
``gen_src_dir``'s plan, captured graph and PTX. And [dist]: the data-parallel
training step across ranks (modes/dist_modes.py): dist_test_master's golden
2x2 case through the CLI on the card against the CPU, the flagship case
(resnet50 224x224, remat=seg) against one process's step on the global
batch (over gloo, the ranks sharing a card: the step eager, its line
printed), and a one-rank NCCL group's step, eager and captured, bit-equal
to the step with no group; then that group's step captured at ResNet-50 b32
bf16 gen, train-mode BN: replays bit-equal to the eager step on two batches,
the hand kernels of each replay per wrapper exact, ms per step replayed and
eager beside the no-group replay.
Last, [tp-train]: the training step on a (tp=2) mesh of the same 2 devices
(parallel/train.py with ``mesh``; each conv and fc per out_chan slice on the
hand kernels), ResNet-50 b32 bf16 gen with momentum and train-mode BN
against the no-mesh step (losses, launches and paths per step, each
distinct call against its plain version, ms per step); the same step
captured on its one-card row the same way as [dist]'s, its replays'
hand kernels per wrapper equal to ``train_calls(pipe, 2)``'s, ms per step
replayed and eager beside the no-mesh replay; b4 f32 at 1e-4, and a (tp=1)
step bit-equal to no mesh.

Then [xla]: boda_tpu's own engines (``xla_phase``): ResNet-50 b32 bf16
under ``(mode=xla)``, the logical-layout rules on the library's ops, and
``(mode=pallas,layout=nchw,kernel_policy=gen)``, the NCHW route on K1 (37
launches) and K3 (16), beside the cuda engine's lib: fc1000 within 5e-2 of
lib's, replays bit-equal to eager on two batches, each distinct K1/K3 call
of the route against its plain version, ms per replay and eager forward;
f32 b2 every node of xla against lib within 1e-4, and f32 b4's gradient
graph under test_compute's 1e-3; googlenet_conv b32 and ssd300 b4 bf16
under xla against lib, and ssd300's head against the CPU's.

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
stem alone wgmma_narrow (the ring with A built element by element),
ssd300's six mbox_conf heads (N = 84 and 126) wgmma_edge (the ring with
B's rows padded to 16 bytes and the output stored from the accumulators),
and no main-path forward the mma.sync loop; nor any hand-kernel call of a
training step: the (tp=2) step's fc1000 dgrads read dY's padded rows on
wgmma and its wgrads on K5's wgmma_edge. [narrow]
holds K2's narrow route at every conv with C % 8 != 0 and N % 8 == 0 that
a path launches (NARROW_SHAPES) against its plain version, its device
time beside the mma.sync loop's, cuDNN's and the bound; [edge] holds the
edge route at each product with an even N % 8 != 0 that a path launches
(EDGE_SHAPES: the six heads on K2; EDGE_GEMMS: fc1000's (tp=2) slice on
K1, and its dgrad on K1's wgmma and wgrad on K5's wgmma_edge, both on dY's
padded rows) the same way, the loop forced by an explicit plan; K6 counts its
routes (bottleneck.paths), and all 12 bottlenecks of the fused b32 forward
must take its wgmma route; K8 counts its routes (pool2d.paths): the fused
b32 forward's pool1 must take rows, its pool5 window. fc1000's weights are scaled in every ResNet-50
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
import time

import numpy as np
import torch

BATCH = 32
# [grad-f32]'s batch: every node of ResNet-50's f32 gradient graph is held on
# the host, so the phase's time grows with it (b8 took 131 s of a 466 s
# run; b4 makes room for [caffe-grad] and the slow corpus suites)
GRAD_F32_BATCH = 4
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
# [graph]: the early nodes of the replayed b32 bf16 gen forward against lib's,
# conv1 through res2a, at the chain tops the forward computes anyway (asking
# for a chain's inner node would unfuse it). Two gates per node:
# * max|err|/max|ref| <= 2e-2: the two differ by a few bf16 roundings per
#   layer over at most four layers (lib rounds cuDNN's sum before its bias,
#   and again at a residual add: ROADMAP §3), up to ~3 ulps at the largest
#   value (an ulp is 2^-8 to 2^-7 of it); PR 16 run 2 read 1.190e-02 at
#   res2a_relu, over the 1e-2 first stated;
# * |mean err| / mean|ref| <= 1e-3: the one that sees a kernel's one-ulp
#   change. The roundings of the two paths scatter both ways (read: <= 5.6e-4),
#   while a systematic change of half an ulp moves the mean by 2e-3 to 3.9e-3
#   of it.
EARLY_NODES = ("conv1_relu", "pool1", "bn2a_branch1_scale", "res2a_branch2a_relu",
               "res2a_branch2b_relu", "res2a_relu")
EARLY_NODE_TOL, EARLY_BIAS_TOL = 2e-2, 1e-3
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
# K2's narrow route (wgmma_narrow): every conv with C % 8 != 0 and N % 8 == 0
# that a path launches, (n, h, c, oc, k, s, p) -> where (ssd300 at SSD_BATCH)
NARROW_SHAPES = {(BATCH, 224, 3, 64, 7, 2, 3): "resnet50 and googlenet conv1, the 7x7 s2 stem, b32",
                 (BATCH, 224, 3, 64, 3, 1, 1): "vgg16 conv1_1 b32",
                 (4, 300, 3, 64, 3, 1, 1): "ssd300 conv1_1 b4",
                 (BATCH, 224, 3, 32, 7, 2, 3): "resnet50 conv1's (tp=2) slice b32"}
NARROW_MAIN = (BATCH, 224, 3, 64, 7, 2, 3)  # the main path's (the gen forward's stem)
# the GEMM core's edge route (wgmma_edge): every product with an even N % 8
# != 0 that a path launches; K2's, (n, h, c, oc, k, s, p) -> where (ssd300's
# mbox_conf heads at SSD_BATCH, the main path [ssd] drives), and the (tp=2)
# step's fc1000 products on 16-byte rows, (kernel, sig) -> where: K1's
# forward (sgemm, (M, K, N), B's rows padded) and dgrad (A = dY's rows
# padded: K = 500 at lda 504, the wgmma route), K5's wgrad (atb, (K, M, N)
# as train_calls writes it: B = dY's rows padded, wgmma_edge)
EDGE_SHAPES = {(4, 38, 512, 84, 3, 1, 1): "ssd300 conv4_3_norm_mbox_conf b4",
               (4, 19, 1024, 126, 3, 1, 1): "ssd300 fc7_mbox_conf b4",
               (4, 10, 512, 126, 3, 1, 1): "ssd300 conv6_2_mbox_conf b4",
               (4, 5, 256, 126, 3, 1, 1): "ssd300 conv7_2_mbox_conf b4",
               (4, 3, 256, 84, 3, 1, 1): "ssd300 conv8_2_mbox_conf b4",
               (4, 1, 256, 84, 3, 1, 1): "ssd300 conv9_2_mbox_conf b4"}
EDGE_GEMMS = {("sgemm", (BATCH, 2048, 500)): "resnet50 fc1000's (tp=2) slice b32, forward",
              ("sgemm", (BATCH, 500, 2048)): "resnet50 fc1000's (tp=2) slice b32, dgrad",
              ("atb", (BATCH, 2048, 500)): "resnet50 fc1000's (tp=2) slice b32, wgrad"}
NAN_CASES = ("sgemm wgmma", "sgemm wgmma split-K", "sgemm wgmma_edge", "sgemm mma",
             "sgemm fma", "conv wgmma", "conv_nhwc wgmma split-K", "conv wgmma_narrow",
             "conv wgmma_edge", "conv mma", "conv fma",
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


def grad_gate_vs_lib(tag: str, pipe, gen, lib, ins: dict, outs: list, gen_res: dict) -> tuple:
    """A bf16 gradient graph's outputs ``outs`` (the loss, the input and
    weight gradients), gen against lib: gen's free run ``gen_res``, reported
    (two independent forwards put some ReLU inputs on opposite sides of 0),
    and gen's backward from lib's forward values, fed in as inputs so that
    both take the same masks, gated within GRAD_BF16_TOL of max|lib| on
    every output. lib must launch no hand kernel. Returns the gate's
    (worst, output)."""
    fwd = [n for n in check_nodes(pipe) if "__grad" not in n]
    counted = counted_wrappers()
    lib.prepare(ins, outs + fwd)
    zero_counts(counted)
    lres = lib.run_fwd(ins, outs + fwd)
    got = read_counts(counted)
    check(not any(got.values()), f"{tag}: lib launched hand kernels {got}")
    res = {"gen": gen_res, "lib": {n: lres[n] for n in outs}}
    forced = dict(ins)
    forced.update({n: lres[n] for n in fwd})
    del lres
    res["gen_forced"] = gen.run_fwd(forced, outs)
    del forced
    errs = {}
    for which in ("gen", "gen_forced"):
        e = []
        for n in outs:
            a, b = res["lib"][n].data, res[which][n].data
            check(bool(np.isfinite(b).all()), f"{tag} {which} {n} non-finite")
            check(np.abs(a).max() > 0, f"{tag} {n} all zero")
            e.append((rel_err(torch.from_numpy(b), torch.from_numpy(a))[1], n))
        e.sort(reverse=True)
        errs[which] = e
        byname = {n: v for v, n in e}
        print(f"[{tag}] {which} vs lib, {len(outs)} outputs, max|err|/max|lib|: worst "
              + ", ".join(f"{n} {v:.3e}" for v, n in e[:4])
              + f"; median {e[len(e) // 2][0]:.3e}; loss {byname['prob_loss']:.3e}, "
              f"data grad {byname['data__grad__p0']:.3e}"
              + ("" if which == "gen_forced" else " (free run, not gated)"))
    worst = errs["gen_forced"][0]
    print(f"[{tag}] gate: gen's backward from lib's forward values, worst {worst[0]:.3e} "
          f"at {worst[1]} (tol {GRAD_BF16_TOL})")
    check(worst[0] <= GRAD_BF16_TOL, f"{tag}: {worst[1]} {worst[0]:.3g}")
    return worst


def grad_replays(tag: str, net: str, engines: dict, ins: dict, outs: list, card: str) -> dict:
    """Each engine's captured gradient graph against an eager pass of the
    same engine, on two batches (``other_batch``): every output bit-equal.
    cuDNN is held to its deterministic algorithms for the comparison (its
    default backward ones may differ between two eager passes:
    scripts/torch_graph_determinism.py); then eager and graph ms per pass,
    recaptured with the default ones. Returns {policy: times}."""
    ins2 = other_batch(ins, 17)
    deterministic = torch.backends.cudnn.deterministic
    rows = {}
    for pol, e in engines.items():
        torch.backends.cudnn.deterministic = True
        try:
            e.drop_graph()
            e.cuda_graph = False
            eager = e.run_fwd(ins, outs)
            e.cuda_graph = True
            replay = e.run_fwd(ins, outs)
            eager2, replay2 = replay_follows(e, ins2, outs)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        e.drop_graph()
        check(not np.array_equal(eager2["data__grad__p0"].data, eager["data__grad__p0"].data),
              f"{tag} {pol}: the second batch left the input gradient as it was")
        for batch, (ea, re_) in (("", (eager, replay)), (", a second batch", (eager2, replay2))):
            gerrs = sorted((rel_err(torch.from_numpy(re_[n].data),
                                    torch.from_numpy(ea[n].data))[1], n) for n in outs)
            n_bit = sum(np.array_equal(re_[n].data, ea[n].data) for n in outs)
            print(f"[{tag}] {net} bf16 {pol}{batch}: replay vs eager, {n_bit} of {len(outs)} "
                  f"outputs bit-equal (all must be), worst max|err|/max|eager| "
                  f"{gerrs[-1][0]:.3e} at {gerrs[-1][1]}")
            check(n_bit == len(outs), f"{tag} {pol}{batch}: {len(outs) - n_bit} outputs "
                                      f"not bit-equal, worst {gerrs[-1]}")
        del eager, replay, eager2, replay2
        e.cuda_graph = False
        eager_s = e.time_fwd(ins, outs, n_iters=10, warmup=3)
        e.cuda_graph = True
        torch.cuda.reset_peak_memory_stats()
        secs = e.time_fwd(ins, outs, n_iters=10, warmup=5)
        n_img = ins["data"].data.shape[0]
        rows[pol] = {"eager_ms": eager_s * 1e3, "graph_ms": secs * 1e3,
                     "img_per_s": n_img / secs, "eager_img_per_s": n_img / eager_s,
                     "capture_s": e._graph.capture_secs,
                     "max_memory_allocated": torch.cuda.max_memory_allocated()}
        r = rows[pol]
        print(f"[{tag}] {net} forward+backward {pol}: eager {r['eager_ms']:.3f} ms, graph "
              f"{r['graph_ms']:.3f} ms per pass; {r['eager_img_per_s']:.1f} -> "
              f"{r['img_per_s']:.1f} img/s; capture {r['capture_s']:.3f} s, "
              f"max_memory_allocated {r['max_memory_allocated'] / 2 ** 30:.2f} GiB ({card})")
    return rows


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


def core_path(c: int, n: int, conv: bool = True, lda: int | None = None) -> str:
    """The GEMM core's bf16 path by shape on aligned operands (the rule of
    ops/kernels/common.py:plan_gemm, stated here on its own): the mma.sync
    loop where N is odd, the GEMM's A rows are off 16 bytes (lda % 8 != 0:
    a dense A with K % 8 != 0; a K % 8 != 0 on rows padded to a multiple of
    8 elements reads by TMA), or a conv has both C % 8 != 0 and N % 8 != 0;
    the narrow fill where a conv's input channels C % 8 != 0; the edge store
    where N % 8 != 0; else wgmma. ``c``: the conv's C, or the GEMM's K;
    ``lda``: the GEMM's A row stride (None: K)."""
    narrow, edge = conv and c % 8 != 0, n % 8 != 0
    if n % 2 or (not conv and (c if lda is None else lda) % 8) or (narrow and edge):
        return "mma"
    return "wgmma_narrow" if narrow else "wgmma_edge" if edge else "wgmma"


def check_paths(what: str, paths: dict, launches: int, mma: int, narrow: int = 0,
                edge: int = 0) -> None:
    """The launches per path of the GEMM core (K1, K2/K3/K4) or of K5: ``mma``
    on the mma.sync loop, ``narrow`` on wgmma_narrow (the C = 3 stems),
    ``edge`` on wgmma_edge (N % 8 != 0), every other one on wgmma, none on
    the f32 path."""
    want = {"wgmma": launches - mma - narrow - edge, "mma": mma, "wgmma_narrow": narrow,
            "wgmma_edge": edge, "fma": 0}
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
        M, K, N = {"wgmma": (4096, 128, 128), "split-K": (32, 2048, 1000),
                   "wgmma_edge": (4096, 128, 84)}.get(name.split()[-1], (77, 147, 100))
        ops = (t((M, K), nan=[(1, 3), (M - 1, K - 1)]), t((K, N), K ** -0.5), t((N,), 0.1))
        kw = dict(relu=True, residual=t((M, N), nan=[(5, 2), (M - 2, N - 1)]))
        return sgemm.matmul, sgemm.matmul_plain, ops, kw, False, sgemm.matmul.paths, path
    if kind in ("conv", "conv_nhwc"):
        n, h, c, oc, k, s, p = {"wgmma": (8, 28, 64, 64, 3, 1, 1),
                                "split-K": (2, 14, 64, 64, 3, 1, 1),
                                "wgmma_narrow": (2, 13, 3, 24, 7, 2, 3),
                                "wgmma_edge": (8, 28, 64, 84, 3, 1, 1)}.get(
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
        if hasattr(f, "padded_a"):
            f.padded_a = 0


def read_counts(counted: dict) -> dict:
    torch.cuda.synchronize()
    return {k: f.launches for k, f in counted.items()}


def kernel_shape_checks(net, pipe, gen, fused, cases, tag="caffe", rows=None) -> list[str]:
    """Each distinct K1 and K2 call of the gen forward, and, given the fused
    engine, each K8 and K4 call of the fused forward, at the net's own
    shapes on random bf16 operands (main's case builders ``cases``), against
    its plain version: max pools exact, the rest within TOL of max|ref|; each
    call on the path ``plan_gemm`` gives its shape (``core_path``: wgmma;
    wgmma_narrow for K2 at C % 8 != 0; wgmma_edge at an even N % 8 != 0;
    mma.sync at odd N, at both, or, for K1, K % 8 != 0). Prints one
    ``[tag]`` line per call, with the kernel's and the library's device
    time and the bound (and appends them to ``rows``, when given); returns
    the miss lines."""
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
        k_us, l_us, b_us = graph_time(kernel) * 1e6, graph_time(lib) * 1e6, \
            max(work(kname, sig)) * 1e3
        print(f"[{tag}] {net} {line}: {'ok' if ok else 'MISS'}; kernel {k_us:.2f} us, "
              f"library {l_us:.2f} us, bound {b_us:.2f} us")
        if rows is not None:
            rows.append({"kernel": kname, "call": what, "path": path, "err": err,
                         "kernel_us": k_us, "library_us": l_us, "bound_us": b_us})
        if not ok:
            misses.append(line)

    def ran(f, before):
        return [p for p in f.paths if f.paths[p] != before[p]]
    for sig, cnt in gemm.items():
        M, K, N, _, relu = sig
        before = dict(matmul.paths)
        case = cases["gemm"](*sig, bf)
        held("sgemm", sig, f"M={M} K={K} N={N} relu={int(relu)} x{cnt}", case,
             ran(matmul, before), [core_path(K, N, conv=False)])
    for sig, cnt in conv.items():
        n, h, c, oc, k, s, p = sig[:7]
        before = dict(conv2d.paths)
        case = cases["conv"](*sig, bf)
        held("conv", sig, f"{h}x{h} C={c} OC={oc} k{k} s{s} p{p} x{cnt}", case,
             ran(conv2d, before), [core_path(c, oc)])
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
    print(f"[{tag}] {net} b{pipe.must_dims('data')['img']} bf16, each distinct call at the "
          f"net's shapes vs its plain "
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
            check_paths(f"googlenet {pol} conv", paths["conv"], n["conv"], 0,
                        1 if pol == "gen" else 0)  # gen: the C = 3 stem, narrow
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
        if pol == "gen":  # 13 3x3 convs, conv1_1 (C = 3) narrow; fc6-fc8
            check(n["conv"] == 13 and n["sgemm"] == 3, f"vgg16 gen launches {n}")
            check_paths("vgg16 gen conv", cpaths, n["conv"], 0, 1)
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


# -- the [caffe-grad] phase: GoogLeNet's gradient graph on the card --------------------

def grad_graph_calls(pipe) -> dict:
    """The K1, K2, K3 and K5 calls of one gen pass of a gradient graph
    (``add_bck_ops``), from the pipe: {(kernel, what, sig): count}. The
    forward as the engine routes it (a 1x1 conv and an fc on K1, a k x k
    conv on K2); each Bck op of a stride-1, groups-1, undilated conv takes
    the hand backward (``executor._lower_bck_conv``): its dgrad on K3's
    entry and its wgrad on K5 (the input gradient is wanted everywhere,
    the data's included); every other Bck op, the strided convs' too, is
    the autograd of the library lowering. Kernel names as in
    ``counted_wrappers``; ``conv_nhwc`` calls also count as ``conv``."""
    calls = {}

    def add(*key):
        calls[key] = calls.get(key, 0) + 1

    def conv_geom(op):
        ind, fd = pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1])
        return (ind["img"], ind["y"], fd["in_chan"], fd["out_chan"], op.kern_sz(),
                op.stride(), op.pad())
    for op in pipe.ops.values():
        if op.type == "InnerProduct":
            fd = pipe.must_dims(op.bots[1])
            add("sgemm", "fc fwd", (pipe.must_dims(op.bots[0])["img"], fd["in_feats"],
                                    fd["out_chan"]))
        elif op.type == "Convolution":
            n, h, c, oc, k, s, p = conv_geom(op)
            if k == (1, 1) and p == (0, 0):
                oh = (h - 1) // s[0] + 1
                add("sgemm", "1x1 fwd", (n * oh * oh, c, oc))
            else:
                add("conv", "fwd", (n, h, c, oc, k[0], s[0], p[0]))
        elif op.type == "Bck":
            fwd = pipe.ops[op.p("fwd_op")]
            if fwd.type != "Convolution" or fwd.p("fused_relu", False) or \
                    fwd.stride() != (1, 1) or fwd.dilation() != (1, 1) or \
                    int(fwd.p("groups", 1)) != 1:
                continue
            n, h, c, oc, k, _, p = conv_geom(fwd)
            add("conv_nhwc", "dgrad", (n, h, c, oc, k[0], p[0]))
            add("atb", "wgrad", (n, h, c, oc, k[0], p[0]))
    return calls


def grad_graph_launches(pipe) -> dict:
    """The launches per counted wrapper of one gen pass of a gradient graph,
    as ``grad_graph_calls`` gives its calls (K3's entry runs the conv
    kernel, so its calls count as ``conv`` launches too)."""
    want = dict.fromkeys(counted_wrappers(), 0)
    for (kname, _, _), cnt in grad_graph_calls(pipe).items():
        want[kname] += cnt
    want["conv"] += want["conv_nhwc"]
    return want


@contextlib.contextmanager
def kernel_calls(record: dict):
    """Engine passes made inside this context keep, per kernel and distinct
    call, the first call's operands (cloned) and the number of calls in
    ``record``: {(kernel, sig): [args, kwargs, count]}. The calls are taken
    where the engine makes them: the forward's K1 and K2 in
    graph/lowering_nhwc.py, a Bck conv's K3 dgrad and K5 wgrad in
    graph/executor.py. Run the engine eagerly (``cuda_graph=0``) inside."""
    from boda_tpu_torch.graph import executor, lowering_nhwc
    spots = ((lowering_nhwc, "matmul", "sgemm"), (lowering_nhwc, "conv2d_halo", "conv"),
             (executor, "conv2d_bck_in", "conv_nhwc"), (executor, "conv2d_bck_filts", "atb"))
    orig = {(m, name): getattr(m, name) for m, name, _ in spots}

    def spy(fn, kname):
        def call(*args, **kw):
            sig = tuple(tuple(a.shape) if isinstance(a, torch.Tensor) else a for a in args) \
                + tuple(sorted((k, v is not None if isinstance(v, torch.Tensor) or v is None
                                else v) for k, v in kw.items()))
            r = record.get((kname, sig))
            if r is None:
                clone = (lambda v: v.detach().clone() if isinstance(v, torch.Tensor) else v)
                record[(kname, sig)] = [[clone(a) for a in args],
                                        {k: clone(v) for k, v in kw.items()}, 1]
            else:
                r[2] += 1
            return fn(*args, **kw)
        return call
    for m, name, kname in spots:
        setattr(m, name, spy(orig[(m, name)], kname))
    try:
        yield
    finally:
        for (m, name), fn in orig.items():
            setattr(m, name, fn)


def grad_call_case(kname: str, args: list, kw: dict):
    """One recorded K1, K2, K3 (dgrad) or K5 (wgrad) call of a gradient
    graph (``kernel_calls``): (its shape as text, the path its shape takes,
    its bound in ms, one library call computing the same function)."""
    import torch.nn.functional as F
    if kname == "sgemm":
        a, b = args[0], args[1]
        shape = f"M={a.shape[0]} K={a.shape[1]} N={b.shape[1]}"
        path = core_path(a.shape[1], b.shape[1], conv=False, lda=a.stride(0))
        bound = max(work("sgemm", (a.shape[0], a.shape[1], b.shape[1],
                                   kw.get("residual") is not None, False)))
        lib_fn = (lambda a=a, b=b: a @ b)
    elif kname == "conv":
        x, w = args[0], args[1]
        s, p = kw.get("stride", (1, 1)), kw.get("pad", (0, 0))
        shape = f"{x.shape[1]}x{x.shape[2]} C={x.shape[3]} OC={w.shape[3]} k{w.shape[0]} " \
                f"s{s[0]} p{p[0]}"
        path = core_path(x.shape[3], w.shape[3])
        bound = max(work("conv", (x.shape[0], x.shape[1], x.shape[3], w.shape[3],
                                  w.shape[0], s[0], p[0], False)))
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
        lib_fn = (lambda xn=xn, wn=wn, s=s, p=p: F.conv2d(xn, wn, stride=tuple(s),
                                                          padding=tuple(p)))
    else:
        if kname == "conv_nhwc":
            dy, w = args[0], args[1]
            x_shape = (dy.shape[0], dy.shape[1] + w.shape[0] - 1 - 2 * kw["pad"][0],
                       dy.shape[2] + w.shape[1] - 1 - 2 * kw["pad"][1], w.shape[2])
            n, h, c, oc, k = x_shape[0], x_shape[1], w.shape[2], w.shape[3], w.shape[0]
            wn, dyn = w.permute(3, 2, 0, 1), dy.permute(0, 3, 1, 2)
            xs = (n, c, x_shape[1], x_shape[2])
            lib_fn = (lambda xs=xs, wn=wn, dyn=dyn, p=kw["pad"]:
                      torch.nn.grad.conv2d_input(xs, wn, dyn, padding=tuple(p)))
        else:
            x, dy = args[0], args[1]
            n, h, c, oc = x.shape[0], x.shape[1], x.shape[3], dy.shape[3]
            k = x.shape[1] + 2 * kw["pad"][0] - dy.shape[1] + 1
            xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
            ws = (oc, c, k, k)
            lib_fn = (lambda xn=xn, dyn=dyn, ws=ws, p=kw["pad"]:
                      torch.nn.grad.conv2d_weight(xn, ws, dyn, padding=tuple(p)))
        sig = (n, h, c, oc, k, kw["pad"][0])
        shape = f"{h}x{h} C={c} OC={oc} k{k} p{kw['pad'][0]}" + \
            (f" ({k * k} taps)" if kname == "atb" else "")
        # the dgrad convolves dy (oc channels) into c; K5 has no narrow route
        path = (core_path(oc, c) if kname == "conv_nhwc" else
                "mma" if c % 8 or oc % 8 else "wgmma")
        bound = max(work("dgrad" if kname == "conv_nhwc" else "atb", sig))
    return shape, path, bound, lib_fn


def caffe_grad_phase(card: str, counted: dict) -> dict:
    """[caffe-grad]: GoogLeNet's gradient graph (googlenet_conv b32 224x224
    bf16, ``add_bck_ops``) on the card under gen and lib, in the manner of
    ResNet-50's [grad-bf16] and [graph-grad]. Gates: gen's launches per
    kernel exact, as ``grad_graph_calls`` works them out from the pipe, on
    wgmma but the C = 3 stem; every distinct K1, K2, K3 and K5 call of the
    gen pass against its plain version on the engine's own operands
    (``kernel_calls``); gen's backward from lib's forward values (fed in as
    inputs, so both take the same ReLU masks) against lib within
    GRAD_BF16_TOL of max|lib| on every output; each graph's replay
    bit-equal to an eager pass on two batches under cuDNN's deterministic
    algorithms. Then eager and graph ms per pass. Returns the phase's
    numbers."""
    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph.autodiff import add_bck_ops
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.ops.kernels.bconv import (conv2d_bck_filts, conv2d_bck_filts_plain,
                                                  conv2d_bck_in, conv2d_bck_in_plain)
    from boda_tpu_torch.ops.kernels.conv import conv2d_halo, conv2d_plain
    from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain
    from boda_tpu_torch.rtc.backends import graph_time
    t_phase = time.perf_counter()
    out = {"card": card}
    pipe, dims = load_net("googlenet_conv", img=BATCH)
    # the classifier scaled so that the loss passes a gradient (a saturated
    # softmax passes none), as [caffe] scales it
    e = make("conv_fwd", "cuda", compute_tn="bfloat16")
    e.init(pipe)
    lmax = float(np.abs(e.run_fwd(gen_data_inputs(dims),
                                  [GOOGLENET_LOGITS])[GOOGLENET_LOGITS].data).max())
    pipe.weights[f"{GOOGLENET_LOGITS}__filts"].data *= np.float32(1.0 / lmax)
    del e
    add_bck_ops(pipe)
    dims["label"] = pipe.nodes["label"].dims
    ins = gen_data_inputs(dims)
    want_outs = ["prob_loss", "data__grad__p0"] + weight_grads(pipe)
    want = grad_graph_launches(pipe)
    engines = {pol: make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy=pol)
               for pol in ("gen", "lib")}
    for e in engines.values():
        e.init(pipe)
    gen, lib = engines["gen"], engines["lib"]
    n_bck = sum(": bck-conv" in ln for ln in gen.get_info_log().splitlines())
    print(f"[caffe-grad] googlenet_conv b{BATCH} bf16 with add_bck_ops: {len(pipe.ops)} ops, "
          f"{len(want_outs)} outputs (loss, data and weight gradients), classifier scaled by "
          f"{1 / lmax:.4g}; gen: {n_bck} Bck convs on the hand backward")
    check(n_bck == want["conv_nhwc"], f"caffe-grad: {n_bck} bck-conv ops, the pipe gives "
                                      f"{want['conv_nhwc']}")

    # -- gen's launches per kernel, exact; on wgmma but the C = 3 stem -----------
    gen.prepare(ins, want_outs)
    zero_counts(counted)
    gen_res = gen.run_fwd(ins, want_outs)
    got = read_counts(counted)
    paths = {k: dict(counted[k].paths) for k in ("sgemm", "conv", "atb")}
    print(f"[caffe-grad] googlenet b{BATCH} bf16 gen: launches {got} (expected from the "
          f"pipe {want}); paths sgemm {paths['sgemm']}, conv {paths['conv']}, atb "
          f"{paths['atb']} ({card})")
    check(got == want, f"caffe-grad gen launches {got}, expected {want}")
    check_paths("caffe-grad sgemm", paths["sgemm"], got["sgemm"], 0)
    check_paths("caffe-grad conv (forward + dgrads)", paths["conv"], got["conv"], 0, 1)
    check_paths("caffe-grad atb (wgrads)", paths["atb"], got["atb"], 0)
    out["launches_gen"] = got

    # -- the gate: gen's backward from lib's forward values ------------------------
    worst = grad_gate_vs_lib("caffe-grad", pipe, gen, lib, ins, want_outs, gen_res)
    del gen_res
    out["gen_vs_lib_worst"] = worst[0]

    # -- each distinct K1, K2, K3 and K5 call of gen's pass vs its plain version -------
    record = {}
    gen.cuda_graph = False
    with kernel_calls(record):
        gen.run_fwd(ins, want_outs)
    gen.cuda_graph = True
    plain = {"sgemm": (matmul, matmul_plain), "conv": (conv2d_halo, conv2d_plain),
             "conv_nhwc": (conv2d_bck_in, conv2d_bck_in_plain),
             "atb": (conv2d_bck_filts, conv2d_bck_filts_plain)}
    wrap = {"sgemm": "sgemm", "conv": "conv", "conv_nhwc": "conv", "atb": "atb"}
    seen = dict.fromkeys(plain, 0)
    rows, misses, worst_k = [], [], {}
    for (kname, _), (args, kw, cnt) in sorted(record.items(), key=lambda r: str(r[0])):
        seen[kname] += cnt
        kern, ref_fn = plain[kname]
        f = counted[wrap[kname]]
        before = dict(f.paths)
        got_o = kern(*args, **kw)
        path = [q for q in f.paths if f.paths[q] != before[q]]
        ref = ref_fn(*args, **kw)
        err = rel_err(got_o, ref)[1]
        shape, want_p, bound, lib_fn = grad_call_case(kname, args, kw)
        want_path = [want_p]
        ok = err <= TOL[torch.bfloat16] and path == want_path
        worst_k[kname] = max(worst_k.get(kname, 0.0), err)
        k_us = graph_time(lambda kern=kern, args=args, kw=kw: kern(*args, **kw)) * 1e6
        l_us = graph_time(lib_fn) * 1e6
        print(f"[caffe-grad] {kname} {shape} x{cnt}: {err:.3e} on {path}: "
              f"{'ok' if ok else 'MISS'}; kernel {k_us:.2f} us, library {l_us:.2f} us, "
              f"bound {bound * 1e3:.2f} us")
        rows.append({"kernel": kname, "call": shape, "count": cnt, "err": err, "path": path,
                     "kernel_us": k_us, "library_us": l_us, "bound_us": bound * 1e3})
        if not ok:
            misses.append(f"{kname} {shape}")
    del record
    want_calls = {k: want[k] for k in plain}
    want_calls["conv"] -= want["conv_nhwc"]
    per_pass = {k: sum(r["kernel_us"] * r["count"] for r in rows if r["kernel"] == k)
                for k in plain}
    print(f"[caffe-grad] {len(rows)} distinct calls of gen's pass vs plain on the engine's "
          f"operands (tol {TOL[torch.bfloat16]}): worst "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst_k.items())
          + f"; calls seen {seen} (from the pipe {want_calls}); kernel us per pass by the "
          f"counts: " + ", ".join(f"{k} {v:.1f}" for k, v in per_pass.items()) + f" ({card})")
    check(seen == want_calls, f"caffe-grad: calls seen {seen}, expected {want_calls}")
    check(not misses, f"caffe-grad: calls off their plain version or path: {misses[:5]}")
    out["calls"], out["kernel_us_per_pass"] = rows, per_pass

    # -- [graph-grad]'s gates: replay vs eager, two batches, deterministic cuDNN ----
    out.update(grad_replays("caffe-grad", f"googlenet b{BATCH}", engines, ins, want_outs, card))
    del engines, gen, lib
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[caffe-grad] phase took {out['seconds']:.1f} s")
    return out


# -- the [int8] and [lmdb] phases: static int8 and real data in ------------------------

# bench.py's int8-static row: the committed sidecar, its two top-1 gates
# against the bf16 forward (bench.py:299-360, the gate at :347)
INT8_CALIB = "testdata/calib/resnet50-bf16.calib.json"
INT8_AGREE, INT8_AGREE_IMAGES = 0.97, 0.95
INT8_IMAGES = ("test1.png", "test2.jpg")
# act_int8 over the ReLU outputs: stored as int8, fed straight to the int8 convs
INT8_ACT = "res*_relu"
# the trained testdata nets, their record files (net -> records' prefix), and
# test_lmdb's goldens (testdata/test_cmds.xml:88-89)
LMDB_NETS = {"shapesnet": "shapes", "shapesnet2": "shapes10", "shapesnet3": "shapes16"}
LMDB_GOLDEN = {"shapesnet": "test_lmdb: n=64 top1=0.9844 top5=1.0000 net=shapesnet",
               "shapesnet2": "test_lmdb: n=200 top1=1.0000 top5=1.0000 net=shapesnet2"}
# the last four Caffe rules, each in a small net, f32 card vs CPU per node
RULE_TOL = 1e-5
_RULE_HEAD = 'name: "{name}"\ninput: "data"\ninput_shape {{ dim: 2 dim: 4 dim: 15 dim: 15 }}\n'
_RULE_CONV = ('layer {{ name: "{n}" type: "{t}" bottom: "{b}" top: "{n}" convolution_param '
              '{{ num_output: {o} kernel_size: {k} stride: {s} pad: {p} group: {g} }} }}\n')
RULE_NETS = {
    "deconv": _RULE_CONV.format(n="up", t="Deconvolution", b="data", o=6, k=4, s=2, p=1, g=1)
    + _RULE_CONV.format(n="up2", t="Deconvolution", b="up", o=4, k=3, s=1, p=1, g=2),
    "sigmoid_tanh": _RULE_CONV.format(n="c1", t="Convolution", b="data", o=8, k=3, s=1, p=1, g=1)
    + 'layer { name: "sig" type: "Sigmoid" bottom: "c1" top: "sig" }\n'
    + 'layer { name: "th" type: "TanH" bottom: "sig" top: "th" }\n',
}


def int8_phase(card: str, pipe, ins: dict, counted: dict) -> dict:
    """[int8]: ResNet-50 b32 int8-static in bench.py's configuration
    (input_s2d with the host fold, the committed calibration sidecar, bf16),
    captured and replayed: every conv but the stem and fc1000 on the int8
    GEMM with a static scale, the stem on K3's entry; top-1 agreement with
    the bf16 forward on the gen-data batch and on the real-image fixtures;
    replay bit-equal to eager on two batches; every int8 GEMM call of the
    forward bit-equal to the exact product of its own operands; int8-static,
    int8-dynamic, act_int8 and bf16 ms per replay; per op, int8 against
    bf16. ``pipe`` is main's ResNet-50 b32 pipe (fc1000 scaled), ``ins``
    its gen-data batch. Returns the phase's numbers."""
    import os

    from boda_tpu_torch.apps.preproc import img_to_batch_np
    from boda_tpu_torch.config import make
    from boda_tpu_torch.ops import int8 as q8
    from boda_tpu_torch.rtc.backends import graph_time
    from boda_tpu_torch.utils.dims import NDA, Dims
    from boda_tpu_torch.utils.img_io import Img, ImgError
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    calib = os.path.join(root, INT8_CALIB)
    out = {"card": card, "calib": INT8_CALIB}
    cfg = {"bf16": {}, "int8_static": {"int8": True, "calib_fn": calib},
           "int8_dynamic": {"int8": True},
           "act_int8": {"int8": True, "calib_fn": calib, "act_int8": [INT8_ACT]}}
    engines = {}
    for tag, kw in cfg.items():
        e = engines[tag] = make("conv_fwd", "cuda", compute_tn="bfloat16", input_s2d=True, **kw)
        e.init(pipe)

    def fold(x_nchw):
        xf = engines["bf16"].host_input_s2d("data", np.ascontiguousarray(x_nchw.transpose(0, 2, 3, 1)))
        return {"data": NDA(Dims.of(img=xf.shape[0], y=xf.shape[1], x=xf.shape[2],
                                    chan=xf.shape[3]), xf)}
    fin = fold(ins["data"].data)
    st = engines["int8_static"]
    log = st.get_info_log().splitlines()
    convs = [o.name for o in pipe.ops.values() if o.type == "Convolution"]
    int8_ops = {ln.split(":")[0] for ln in log if "nhwc-int8_conv" in ln and "static_amax" in ln}
    fc_ok = any(ln.startswith("fc1000: nhwc-ip int8") and "static_amax" in ln for ln in log)
    stem_ok = any(ln.startswith("conv1: nhwc-stem_s2d") for ln in log)
    print(f"[int8] resnet50 b{BATCH} int8-static ({INT8_CALIB}, input_s2d, bf16): "
          f"{len(int8_ops)} of {len(convs)} convs on nhwc-int8_conv with a static_amax, "
          f"fc1000 on nhwc-ip int8: {fc_ok}, conv1 on its stem_s2d rule: {stem_ok}")
    check(int8_ops == set(convs) - {"conv1"} and fc_ok and stem_ok,
          f"int8: the lowering's routes {sorted(set(convs) - int8_ops)}")

    # every int8 GEMM call of an eager forward against the exact product of its
    # operands (f64 is exact here: |sum| <= K * 127^2 < 2^53)
    calls, worst = {}, 0
    orig = q8.int8_mm

    def checked(a, b, n=None):
        got = orig(a, b, n)
        k, nn = a.shape[1], got.shape[1]
        want = (a.double() @ b[:k, :nn].double()).to(torch.int32)
        sig = (a.shape[0], k, nn)
        calls[sig] = calls.get(sig, 0) + 1
        nonlocal worst
        worst = max(worst, int((got - want).abs().max()))
        return got
    q8.int8_mm = checked
    st.cuda_graph = False
    try:
        st.run_fwd(fin, ["prob"])
    finally:
        q8.int8_mm = orig
        st.cuda_graph = True
    n_calls = sum(calls.values())
    print(f"[int8] each int8 GEMM call of the eager forward vs the exact product of its int8 "
          f"operands: {n_calls} calls in {len(calls)} signatures, max |diff| {worst}")
    check(n_calls == len(convs) and worst == 0, f"int8 GEMM calls: {n_calls}, max diff {worst}")
    out["gemm_calls"], out["gemm_signatures"] = n_calls, len(calls)

    # the captured forward: launches of the hand kernels (the stem alone)
    res = {}
    for tag, e in engines.items():
        e.prepare(fin, ["prob"])
        zero_counts(counted)
        res[tag] = e.run_fwd(fin, ["prob"])["prob"].data
        n = read_counts(counted)
        if tag != "bf16":
            want = {**dict.fromkeys(counted, 0), "conv": 1, "conv_nhwc": 1}
            check(n == want, f"int8 {tag}: launches {n}, expected the stem's {want}")
            out.setdefault("launches", n)
    top = {t: np.argmax(p, 1) for t, p in res.items()}
    distinct = len(set(top["bf16"].tolist()))
    agree = {t: float(np.mean(top[t] == top["bf16"])) for t in res if t != "bf16"}
    print(f"[int8] top-1 agreement with the bf16 forward on the gen-data batch: "
          + ", ".join(f"{t} {a:.4f}" for t, a in agree.items())
          + f" (gate {INT8_AGREE} for static and act_int8; the batch has {distinct} distinct "
          f"bf16 top-1 classes)")
    check(agree["int8_static"] >= INT8_AGREE and agree["act_int8"] >= INT8_AGREE,
          f"int8 top-1 agreement {agree}")
    out["top1_agree"], out["distinct_top1"] = agree, distinct

    # the real-image fixtures, tiled to the batch as bench.py:112-134 does
    try:
        imgs = [Img.load(os.path.join(root, "testdata", "images", f)).resize(224, 224).rgb()
                for f in INT8_IMAGES]
    except ImgError as e:
        imgs = None
        print(f"[int8] the real-image gate did not run: {e}")
        out["top1_agree_images"] = f"not run: {e}"
    if imgs is not None:
        xb = img_to_batch_np(np.stack([imgs[i % len(imgs)] for i in range(BATCH)]))
        fim = fold(xb.astype(np.float32))
        pim = {t: np.argmax(engines[t].run_fwd(fim, ["prob"])["prob"].data, 1)
               for t in ("bf16", "int8_static", "act_int8")}
        agree_im = {t: float(np.mean(pim[t] == pim["bf16"])) for t in ("int8_static", "act_int8")}
        print(f"[int8] top-1 agreement with bf16 on {', '.join(INT8_IMAGES)} tiled to "
              f"b{BATCH}: " + ", ".join(f"{t} {a:.4f}" for t, a in agree_im.items())
              + f" (gate {INT8_AGREE_IMAGES})")
        check(min(agree_im.values()) >= INT8_AGREE_IMAGES, f"int8 real images {agree_im}")
        out["top1_agree_images"] = agree_im

    # act_int8: the ReLU outputs stored as signed int8 and fed to the convs as they are
    aq = engines["act_int8"]
    signed = sum(not u for u, _ in aq._act_q.values())
    print(f"[int8] act_int8 {INT8_ACT}: {len(aq._act_q)} nodes stored, {signed} as int8; "
          f"{len(aq._q8_direct)} convs took the stored int8 as their operand")
    check(signed == len(aq._act_q) > 0 and len(aq._q8_direct) > 0, "act_int8 storage")

    # replay against eager, bit for bit, on this batch and a second one
    fouts = ["prob", "fc1000"]
    st.cuda_graph = False
    eager = st.run_fwd(fin, fouts)
    st.cuda_graph = True
    replay = st.run_fwd(fin, fouts)
    eager2, replay2 = replay_follows(st, other_batch(fin, 19), fouts)
    bit = all(np.array_equal(replay[k].data, eager[k].data) and
              np.array_equal(replay2[k].data, eager2[k].data) for k in fouts)
    moved = not np.array_equal(eager2["fc1000"].data, eager["fc1000"].data)
    print(f"[int8] int8-static replay vs eager on two batches: bit-equal {bit}; the second "
          f"batch moved fc1000: {moved}")
    check(bit and moved, "int8-static replay vs eager")
    fc = replay["fc1000"].data
    check(bool(np.isfinite(fc).all()) and fc.shape == (BATCH, 1000), "int8 fc1000 finite")

    # ms per replay
    rows = {}
    for tag, e in engines.items():
        secs = e.time_fwd(fin, ["prob"], n_iters=20, warmup=5)
        rows[tag] = {"graph_ms": secs * 1e3, "img_per_s": BATCH / secs}
    print(f"[int8] resnet50 b{BATCH} input_s2d graph ms/fwd: "
          + ", ".join(f"{t} {r['graph_ms']:.3f} ({r['img_per_s']:.1f} img/s)"
                      for t, r in rows.items()) + f" ({card})")
    out["graph"] = rows

    # per op: each conv/fc's own lowering, int8-static against bf16 (gen)
    t_q, t_b = st.per_layer_times(fin), engines["bf16"].per_layer_times(fin)
    ratio = sorted(((t_q[o] / t_b[o], o) for o in t_q
                    if o in t_b and pipe.ops[o].type in ("Convolution", "InnerProduct")),
                   reverse=True)

    def shape(o):
        op = pipe.ops[o]
        ind, fd = pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1])
        if op.type == "InnerProduct":
            return f"fc {ind['img']}x{fd['in_feats']}->{fd['out_chan']}"
        return (f"{ind['y']}x{ind['x']} C={ind['chan']} OC={fd['out_chan']} "
                f"k{op.kern_sz()[0]} s{op.stride()[0]}")
    sum_q = sum(t_q[o] for _, o in ratio)
    sum_b = sum(t_b[o] for _, o in ratio)
    print(f"[int8] per op, each conv/fc lowering alone (device time in a CUDA graph), "
          f"int8-static vs bf16 gen: sum {sum_q * 1e3:.3f} vs {sum_b * 1e3:.3f} ms; most "
          "behind: " + "; ".join(f"{o} ({shape(o)}) {t_q[o] * 1e6:.1f} vs {t_b[o] * 1e6:.1f} us"
                                 for _, o in ratio[:5]) + f" ({card})")
    out["per_op_sum_ms"] = {"int8_static": sum_q * 1e3, "bf16": sum_b * 1e3}
    out["per_op_most_behind"] = {o: {"shape": shape(o), "int8_us": t_q[o] * 1e6,
                                     "bf16_us": t_b[o] * 1e6} for _, o in ratio[:5]}
    # the GEMMs alone: cuBLASLt's int8 at each call's (M, K, N) on random int8
    # operands, against cuBLAS's bf16 at the same shape, summed over the calls
    g = torch.Generator(device="cuda").manual_seed(3)
    gemm_ms = {"int8": 0.0, "bf16": 0.0}
    for (m, k, n), cnt in calls.items():
        a8 = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        b8 = torch.randint(-127, 128, (k, n), generator=g, device="cuda", dtype=torch.int8)
        a16, b16 = a8.to(torch.bfloat16), b8.to(torch.bfloat16)
        gemm_ms["int8"] += graph_time(lambda: q8.int8_mm(a8, b8)) * 1e3 * cnt
        gemm_ms["bf16"] += graph_time(lambda: torch.mm(a16, b16)) * 1e3 * cnt
        del a8, b8, a16, b16
    print(f"[int8] the forward's {n_calls} GEMMs alone (device time in a CUDA graph): int8 "
          f"_int_mm {gemm_ms['int8']:.3f} ms, bf16 torch.mm at the same shapes "
          f"{gemm_ms['bf16']:.3f} ms; the rest of the int8 lowerings' {sum_q * 1e3:.3f} ms is "
          f"the quantize, the patch gather and the epilogue in PyTorch ({card})")
    out["gemm_alone_ms"] = gemm_ms
    del engines, st, aq
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[int8] phase took {out['seconds']:.1f} s")
    return out


def lmdb_phase(card: str, out_dir) -> dict:
    """[lmdb]: real data in on the card. net_calib on each trained shapesnet's
    train records, then test_lmdb on its test records in f32, bf16 and int8
    with that sidecar, through the CLI (the goldens in f32; int8's top-1 and
    top-5 equal to f32's); the Deconvolution, Sigmoid, TanH and Reduce rules,
    each in a small net, f32 every node on the card against the CPU."""
    import os

    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph.pipe import ConvOp
    from boda_tpu_torch.models.zoo import NetBuilder
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.utils.dims import Dims
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    nets, recs = os.path.join(root, "testdata", "nets"), os.path.join(root, "testdata", "lmdb")
    out = {"card": card}
    for net, rec in LMDB_NETS.items():
        base = [f"--ptt-fn={nets}/{net}.prototxt", f"--weights-fn={nets}/{net}.caffemodel"]
        calib = os.path.join(str(out_dir), f"{net}.calib.json")
        rc, lines = run_cli(["net_calib"] + base + [f"--lmdb-fn={recs}/{rec}_train.rec",
                                                    "--img=8", f"--out-fn={calib}"])
        check(rc == 0 and os.path.exists(calib), f"net_calib {net}: rc {rc}")
        got = {}
        for tag, eng in (("f32", "(mode=cuda)"), ("bf16", "(mode=cuda,compute_tn=bfloat16)"),
                         ("int8", f"(mode=cuda,int8=1,calib_fn={calib})")):
            rc, lines = run_cli(["test_lmdb"] + base + [f"--rec-fn={recs}/{rec}_test.rec",
                                                        "--img=8", f"--conv-fwd={eng}"])
            got[tag] = next((ln for ln in reversed(lines) if ln.startswith("test_lmdb:")), "")
            check(rc == 0 and bool(got[tag]), f"test_lmdb {net} {tag}: rc {rc}")
        print(f"[lmdb] {net}: net_calib on {rec}_train.rec -> {os.path.basename(calib)}; "
              f"test_lmdb on {rec}_test.rec: "
              + "; ".join(f"{t} '{ln}'" for t, ln in got.items()))
        if net in LMDB_GOLDEN:
            check(got["f32"] == LMDB_GOLDEN[net], f"{net} f32 vs the golden: {got['f32']}")
        check(got["int8"] == got["f32"], f"{net}: int8 {got['int8']} != f32 {got['f32']}")
        out[net] = got

    # the last four rules, each in a small net: f32 on the card vs the CPU
    for name, layers in RULE_NETS.items():
        ptt = os.path.join(str(out_dir), f"{name}.prototxt")
        with open(ptt, "w") as f:
            f.write(_RULE_HEAD.format(name=name) + layers)
        out[name] = _rule_case(name, *load_net(ptt_fn=ptt, img=0), make, gen_data_inputs)
    b = NetBuilder("reduce3")
    t = b.input("data")
    parts = [b.conv(n, t, 6, k, pad=k // 2, in_chans=4) for n, k in (("a", 3), ("c", 1), ("d", 3))]
    b.pipe.add_op(ConvOp("red", "Reduce", {}, bots=parts, tops=["red"]))
    b.relu("red_relu", "red")
    rdims = {"data": Dims.of(img=2, chan=4, y=15, x=15)}
    out["reduce"] = _rule_case("reduce", b.done(rdims), rdims, make, gen_data_inputs)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[lmdb] phase took {out['seconds']:.1f} s")
    return out


def _rule_case(name, pipe, dims, make, gen_data_inputs) -> float:
    ins, nodes = gen_data_inputs(dims), check_nodes(pipe)
    r = {}
    for d in ("cuda", "cpu"):
        e = make("conv_fwd", "cuda", device=d)
        e.init(pipe)
        r[d] = e.run_fwd(ins, nodes)
    _, (err, node) = node_agreement(r["cpu"], r["cuda"], nodes, RULE_TOL)
    types = sorted({o.type for o in pipe.ops.values()})
    print(f"[lmdb] rules {name} ({', '.join(types)}) f32 b2: {len(nodes)} nodes, card vs CPU "
          f"worst {err:.3e} ({node}) (tol {RULE_TOL})")
    check(err <= RULE_TOL, f"rule net {name}: card vs CPU {err:.3g}")
    return err


# -- the [ssd] phase: ssd300 b4, the detection head inside the captured forward --------

SSD_BATCH = 4  # the latency batch of docs/model_census.md:86
# the head's three inputs, and the nodes the bf16 forwards are held on
SSD_HEAD_INS = ["mbox_loc", "mbox_conf_flatten", "mbox_priorbox"]
SSD_BF16_NODES = ["mbox_loc", "mbox_conf_softmax"]
# ssd300 b4's kernel launches per forward: gen takes its five 1x1s on K1 and
# its 29 kxk convs (13 trunk, 4 extra layers, 12 mbox heads) on K2, fc6 (dilated)
# on the library conv; the fused tune moves conv6_2 and conv7_2 (3x3 s2) to
# K4's fold (its conv counted under conv and conv_nhwc too) and the five
# pools to K8
SSD_LAUNCHES = {"gen": {"sgemm": 5, "conv": 29},
                "fused": {"sgemm": 5, "conv": 29, "s2d": 2, "conv_nhwc": 2, "pool": 5}}
# the six mbox_conf heads (N = 84 or 126) on the edge store, on filters the
# HWIO prep padded to 16-byte rows (no copy per call), conv1_1 (C = 3) on the
# narrow fill, none on mma.sync
SSD_MMA = 0
SSD_NARROW = 1
SSD_EDGE = 6
# the head on the card against the CPU on the same f32 inputs: labels, keep
# masks and row order equal; scores and boxes max|err|/max|ref| (an exp ulp
# apart in a decoded box is ~6e-8 of it)
SSD_HEAD_TOL = 1e-6
# bf16 mbox_loc and mbox_conf_softmax against bf16 lib and f32 gen, max|err| /
# max|ref|: as SLICE_TOL; each of the <= 17 convs on a path to a head rounds
# its output to bf16 once (2^-9 of a value), lib up to three times (ROADMAP
# §3, "the library conv rounds more often"); PR 14 read <= 2.444e-02 on
# GoogLeNet's probabilities
SSD_BF16_TOL = 5e-2
# the golden of testdata/test_cmds.xml:107, and boda_tpu's cross-engine bounds
# on its rows (tests/test_detect.py:52-55)
SSD_GOLDEN = "testdata/good_tr/detect_ssd300_scored"
SSD_SCORE_TOL, SSD_BOX_TOL = 1e-3, 0.15
SSD_REPS = 5  # timed repeats of 20 replays each; their median


def det_rows(text: str) -> list:
    return [(p[0], p[1], float(p[2]), [float(v) for v in p[3:]])
            for p in (ln.split() for ln in text.splitlines() if not ln.startswith("#"))]


def head_agree(a: np.ndarray, b: np.ndarray) -> tuple[bool, float]:
    """Two (rows, 7) detection tables: (image and label columns equal, i.e.
    the same keep masks and row order; max|err|/max|b| over scores and
    boxes)."""
    same = np.array_equal(a[:, :2], b[:, :2])
    return same, float(np.abs(a[:, 2:] - b[:, 2:]).max() / max(np.abs(b[:, 2:]).max(), 1e-30))


def device_kernels(fn) -> tuple[dict, float]:
    """{kernel name: launches} of one call of fn on the card and their summed
    device ms, from torch.profiler's device events (copies and fills not
    counted); empty when the profiler sees no device activity. A lead-in
    kernel (``torch.cuda._sleep``, not counted) runs first: the profiler can
    drop the first device records of its window (a CUDA graph's first two
    kernels went missing when its replay opened the window)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    names, busy = {}, 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and "Memcpy" not in e.name \
                and "Memset" not in e.name and "spin_kernel" not in e.name:
            names[e.name] = names.get(e.name, 0) + 1
            busy += e.time_range.elapsed_us() / 1e3
    return names, busy


def kernel_counts(fn, n: int) -> tuple[dict, float, list]:
    """``device_kernels`` over ``n`` (odd) calls of fn: each name's median
    launches per call (one call whose profile drops or adds a record moves
    no median), the median device ms, and each call's {name: launches}."""
    reads = [device_kernels(fn) for _ in range(n)]
    names = {k for r in reads for k in r[0]}
    return ({k: sorted(r[0].get(k, 0) for r in reads)[n // 2] for k in names},
            sorted(r[1] for r in reads)[n // 2], [r[0] for r in reads])


def device_launches(fn) -> int:
    """Kernels one call of fn runs on the card (``device_kernels``)."""
    return sum(device_kernels(fn)[0].values())


def ssd_phase(card: str, out_dir, counted: dict, cases: dict) -> dict:
    """[ssd]: ssd300 at b4 (300x300, 21 classes, 8,732 priors, top_k 400,
    keep_top_k 200), the detection head inside the one CUDA graph of the
    forward. bf16 gen and fused (tune=(use_s2d=1,pool_pallas=1)) captured and
    replayed with their launches and each conv's route; each distinct K1, K2,
    K4 and K8 call against its plain version; the head alone on the card
    against the CPU; cnet_detect's golden in f32 on the card; bf16 against
    bf16 lib and f32; det_top_k; ms per replay and the head's share and
    launches. Returns the phase's numbers."""
    import os

    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph import ssd_ops
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.ops.kernels.conv import conv2d
    from boda_tpu_torch.utils.lexp import parse_lexp
    t_phase = time.perf_counter()
    out = {"card": card}
    root = os.path.dirname(os.path.abspath(__file__))
    pipe, dims = load_net("ssd300", img=SSD_BATCH)
    ins = gen_data_inputs(dims)
    det = ["detection_out"]
    none = dict.fromkeys(counted, 0)

    # -- gen and fused bf16, captured and replayed: launches, routes, replay ----------
    engines = {}
    for pol, kw in (("gen", {}), ("fused", {"tune": parse_lexp(FUSED_TUNE)})):
        e = engines[pol] = make("conv_fwd", "cuda", compute_tn="bfloat16", **kw)
        e.init(pipe)
        routed = {}
        for ln in e.get_info_log().splitlines():
            name, _, rest = ln.partition(": ")
            if name in pipe.ops and pipe.ops[name].type == "Convolution":
                routed[name] = rest.split(" ")[0]
        routes = {}
        for name, r in routed.items():
            fd = pipe.must_dims(pipe.ops[name].bots[1])
            label = {"nhwc-k1conv": "K1", "nhwc-s2d_conv": "K4", "nhwc-lib_conv": "lib"}.get(r)
            if r == "nhwc-direct_conv":
                label = {"mma": "K2-mma.sync", "wgmma_narrow": "K2-wgmma_narrow",
                         "wgmma_edge": "K2-wgmma_edge",
                         "wgmma": "K2-wgmma"}[core_path(fd["in_chan"], fd["out_chan"])]
            routes.setdefault(label or r, []).append(name)
        for label, names in sorted(routes.items()):
            print(f"[ssd] ssd300 b{SSD_BATCH} bf16 {pol} routes {label} ({len(names)}): "
                  + ", ".join(names))
        check(routes.get("lib") == ["fc6"], f"ssd300 {pol}: library convs {routes.get('lib')}")
        e.cuda_graph = False
        copies = conv2d.pad_copies
        eager = e.run_fwd(ins, det)
        e.cuda_graph = True
        e.prepare(ins, det)
        copies = conv2d.pad_copies - copies
        zero_counts(counted)
        replay = e.run_fwd(ins, det)
        n = read_counts(counted)
        cpaths = dict(counted["conv"].paths)
        want = {**none, **SSD_LAUNCHES[pol]}
        bit = np.array_equal(replay["detection_out"].data, eager["detection_out"].data)
        print(f"[ssd] ssd300 b{SSD_BATCH} bf16 {pol}: one CUDA graph for the whole forward, "
              f"detection_out included; launches {n} (expected {want}); conv paths {cpaths}; "
              f"padded weight copies in the eager forward and the capture {copies}; "
              f"replay vs eager detection_out bit-equal {bit}")
        check(n == want, f"ssd300 {pol}: launches {n}, expected {want}")
        check(cpaths["mma"] == SSD_MMA and cpaths["wgmma_narrow"] == SSD_NARROW
              and cpaths["wgmma_edge"] == SSD_EDGE
              and cpaths["wgmma"] == n["conv"] - SSD_MMA - SSD_NARROW - SSD_EDGE,
              f"ssd300 {pol}: conv paths {cpaths}")
        check(copies == 0, f"ssd300 {pol}: {copies} launches copied their weights")
        check(bit, f"ssd300 {pol}: the replayed detection_out differs from the eager one")
        rows = replay["detection_out"].data.reshape(-1, 7)
        check(rows.shape == (SSD_BATCH * 200, 7) and bool(np.isfinite(rows).all())
              and set(rows[:, 0].tolist()) == set(range(SSD_BATCH))
              and int((rows[:, 1] >= 0).sum()) > 0, f"ssd300 {pol}: detection_out rows")
        if pol == "gen":
            ins2 = other_batch(ins, 23)
            eager2, replay2 = replay_follows(e, ins2, det)
            moved = not np.array_equal(eager2["detection_out"].data, eager["detection_out"].data)
            bit2 = np.array_equal(replay2["detection_out"].data, eager2["detection_out"].data)
            print(f"[ssd] ssd300 gen: a second batch through the same graph: detection_out "
                  f"moved {moved}, replay vs eager bit-equal {bit2}")
            check(moved and bit2, "ssd300 gen: the second batch")
        out[f"launches_{pol}"] = n
        out[f"conv_paths_{pol}"] = cpaths
        del eager, replay

    # -- each distinct kernel call at ssd300's shapes against its plain version -------
    rows = []
    misses = kernel_shape_checks("ssd300", pipe, engines["gen"], engines["fused"], cases,
                                 tag="ssd", rows=rows)
    check(not misses, f"ssd300: {len(misses)} kernel calls differ from their plain "
          f"versions: {misses}")
    out["mbox_conf_calls"] = [r for r in rows if r["kernel"] == "conv"
                              and (" OC=84 " in r["call"] or " OC=126 " in r["call"])]
    for r in out["mbox_conf_calls"]:
        print(f"[ssd] mbox_conf head {r['call']} on {r['path']}: kernel {r['kernel_us']:.2f} us, "
              f"cuDNN {r['library_us']:.2f} us, bound {r['bound_us']:.2f} us ({card})")

    # -- the head alone: card against CPU on the same f32 inputs ------------------------
    e32 = make("conv_fwd", "cuda")
    e32.init(pipe)
    r32 = e32.run_fwd(ins, SSD_HEAD_INS + det + SSD_BF16_NODES)
    op = pipe.ops["detection_out"]
    head = {d: ssd_ops._detection_output_fn(op, int(op.p("num_classes")), SSD_BATCH, d)
            for d in ("cuda", "cpu")}
    hin = [torch.from_numpy(r32[k].data) for k in SSD_HEAD_INS]
    with torch.inference_mode():
        on_card = head["cuda"](*(t.cuda() for t in hin))[0].cpu().numpy().reshape(-1, 7)
        on_cpu = head["cpu"](*hin)[0].numpy().reshape(-1, 7)
    same, herr = head_agree(on_card, on_cpu)
    same_g, gerr = head_agree(r32["detection_out"].data.reshape(-1, 7), on_cpu)
    valid = int((on_cpu[:, 1] >= 0).sum())
    print(f"[ssd] the head alone, f32 b{SSD_BATCH} inputs of the card's forward: card vs CPU "
          f"image/label/order equal {same}, scores and boxes {herr:.3e}; the replayed "
          f"forward's detection_out vs CPU equal {same_g}, {gerr:.3e} (tol {SSD_HEAD_TOL}); "
          f"{valid} valid rows of {len(on_cpu)}")
    check(same and same_g and herr <= SSD_HEAD_TOL and gerr <= SSD_HEAD_TOL and valid > 0,
          f"ssd300 head card vs CPU: {same} {herr:.3g}, forward {same_g} {gerr:.3g}")
    with torch.inference_mode():
        card_ins = [t.cuda() for t in hin]
        out["head_launches_alone"] = device_launches(lambda: head["cuda"](*card_ins))
    out["head_card_vs_cpu"] = herr

    # -- cnet_detect's golden in f32 on the card, through the CLI -----------------------
    rc, lines = run_cli(["cnet_detect", "--model=ssd300", "--conf-thresh=0.05",
                         f"--gt-fn={os.path.join(root, 'testdata', 'score', 'ssd300_gt.txt')}",
                         f"--boda-output-dir={out_dir}"])
    golden = open(os.path.join(root, SSD_GOLDEN, "test_out.txt")).read().splitlines()
    got = det_rows((out_dir / "dets.txt").read_text()) if rc == 0 else []
    want_rows = det_rows(open(os.path.join(root, SSD_GOLDEN, "dets.txt")).read())
    row_ok = len(got) == len(want_rows) and all(
        (a[0], a[1]) == (b[0], b[1]) and abs(a[2] - b[2]) <= SSD_SCORE_TOL
        and max(abs(u - v) for u, v in zip(a[3], b[3])) <= SSD_BOX_TOL
        for a, b in zip(got, want_rows))
    worst = (max(abs(a[2] - b[2]) for a, b in zip(got, want_rows)),
             max(abs(u - v) for a, b in zip(got, want_rows) for u, v in zip(a[3], b[3]))) \
        if got and len(got) == len(want_rows) else (float("nan"), float("nan"))
    for ln in lines:
        print(f"[ssd] cnet_detect f32 on the card: {ln}")
    print(f"[ssd] cnet_detect --model=ssd300 f32 gen rc={rc}: stdout equal to the golden "
          f"{lines == golden}; dets.txt {len(got)} rows vs the golden's {len(want_rows)}, worst "
          f"score {worst[0]:.2e} (tol {SSD_SCORE_TOL}), box {worst[1]:.2f} px (tol {SSD_BOX_TOL})")
    check(rc == 0 and lines == golden and row_ok, "ssd300 cnet_detect golden on the card")
    out["golden"] = {"mAP_line": lines[-1] if lines else "", "worst_score": worst[0],
                     "worst_box_px": worst[1]}

    # -- bf16 gen against bf16 lib and f32 gen ------------------------------------------
    lib = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib")
    lib.init(pipe)
    r_lib = lib.run_fwd(ins, SSD_BF16_NODES)
    r_gen = engines["gen"].run_fwd(ins, SSD_BF16_NODES)
    errs = {}
    for ref_tag, ref in (("bf16 lib", r_lib), ("f32 gen", r32)):
        for nd in SSD_BF16_NODES:
            errs[f"{nd} vs {ref_tag}"] = rel_err(torch.from_numpy(r_gen[nd].data),
                                                 torch.from_numpy(ref[nd].data))[1]
    print("[ssd] bf16 gen: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {SSD_BF16_TOL}); max mbox_conf_softmax {r_gen['mbox_conf_softmax'].data.max():.4g}")
    check(max(errs.values()) <= SSD_BF16_TOL, f"ssd300 bf16: {errs}")
    out["bf16_errs"] = errs
    del e32, r32, r_lib, r_gen

    # -- det_top_k ---------------------------------------------------------------------
    base = engines["gen"].run_fwd(ins, det)["detection_out"].data.reshape(-1, 7)
    topk = {}
    for k in (400, 64):
        e = topk[k] = make("conv_fwd", "cuda", compute_tn="bfloat16",
                           per_op_tune={"detection_out": parse_lexp(f"(det_top_k={k})")})
        e.init(pipe)
    r400 = topk[400].run_fwd(ins, det)["detection_out"].data.reshape(-1, 7)
    r64 = topk[64].run_fwd(ins, det)["detection_out"].data.reshape(-1, 7)
    v_base, v64 = int((base[:, 1] >= 0).sum()), int((r64[:, 1] >= 0).sum())
    print(f"[ssd] det_top_k=400 bit-equal to the default: {np.array_equal(r400, base)}; "
          f"det_top_k=64: {v64} valid rows against the default's {v_base}")
    check(np.array_equal(r400, base) and 0 < v64 <= v_base, "ssd300 det_top_k")
    del topk[400]

    # -- ms per b4 replay, the head's share and its launches -----------------------------
    def ms(e, outs):
        return float(np.median([e.time_fwd(ins, outs, n_iters=20, warmup=3)
                                for _ in range(SSD_REPS)])) * 1e3
    t = {"gen": ms(engines["gen"], det), "lib": ms(lib, det), "det_top_k=64": ms(topk[64], det),
         "fused": ms(engines["fused"], det), "gen_head_inputs": ms(engines["gen"], SSD_HEAD_INS)}
    share = (t["gen"] - t["gen_head_inputs"]) / t["gen"]
    e = engines["gen"]
    e.cuda_graph = False
    launches_all = device_launches(lambda: e.run_fwd(ins, det))
    launches_in = device_launches(lambda: e.run_fwd(ins, SSD_HEAD_INS))
    e.cuda_graph = True
    out["head_launches"] = launches_all - launches_in if launches_all else None
    print(f"[ssd] ssd300 b{SSD_BATCH} bf16 ms per replay (median of {SSD_REPS} x 20): "
          + ", ".join(f"{k} {v:.3f}" for k, v in t.items())
          + f"; the head's share of gen {share:.3f}; device launches per forward "
          + (f"{launches_all}, of them the head's {out['head_launches']} (the head alone "
             f"{out['head_launches_alone']})" if launches_all else "not measured (the "
                                                                   "profiler saw no device events)")
          + f" ({card})")
    out.update(ms=t, head_share=share, launches_per_forward=launches_all or None)
    del engines, lib, topk
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[ssd] phase took {out['seconds']:.1f} s")
    return out


# -- the [train] phase: the training step on the card ---------------------------------

TRAIN_TOL = 5e-2         # bf16 b32 gen vs lib: loss, gradients, running stats
TRAIN_F32_BATCH = 8
TRAIN_F32_TOL = 1e-3     # f32 b8 gen vs lib, comp_vars on every gradient
TRAIN_CALL_TOL = 1e-2    # each K1/K2/K3/K5 call of the gen step vs its plain version
TRAIN_RESUME_TOL = 1e-5  # kill-and-resume losses against the straight run
TRAIN_GRAPH_REPS = 10    # calls per ms reading of the eager step and of a replay
TRAIN_GRAPH_PROFILES = 5  # profiled calls per kernel count (odd: a median)
# tests/test_learning.py's deep gate (:130-165): shapesnet2 fresh-trained on
# shapes10, milestone losses within its bounds and strictly decreasing, then
# held-out top-1 through test_lmdb --ckpt-fn
LEARN_ARGS = ["--ptt-fn=testdata/nets/shapesnet2.prototxt",
              "--rec-fn=testdata/lmdb/shapes10_train.rec", "--img=16", "--n-steps=150",
              "--lr=0.02", "--lr-schedule=cosine", "--warmup-steps=20", "--log-every=25"]
LEARN_BOUNDS = {25: 2.5, 50: 1.2, 100: 0.5, 125: 0.4}
LEARN_INIT_MIN, LEARN_TOP1 = 2.0, 0.92


# the hand kernels' names (boda_tpu_torch/csrc), for sorting a profile's
# device time into the port's kernels, the library's convs and GEMMs (cuDNN,
# cuBLAS) and PyTorch's own (elementwise, reductions, copies)
HAND_KERNELS = ("gemm_wgmma", "gemm_bf16", "gemm_f32", "gemm_splitk_reduce", "atb_bf16",
                "atb_f32", "splitk_reduce_f32", "bottleneck_", "eltwise_ring",
                "eltwise_scalar", "pool_rows", "pool_window", "pool_kernel", "stem_fma",
                "stem_mma")


def kernel_class(name: str) -> str:
    """hand, library or pytorch, by a device kernel's name. The library's
    names go first: cuDNN's (``sm90_xmma_gemm_bf16bf16_...``) hold a hand
    kernel's name."""
    low = name.lower()
    if any(t in low for t in ("cudnn", "xmma", "cutlass", "nvjet", "cublas", "sm90_", "sm80_")):
        return "library"
    if any(h in name for h in HAND_KERNELS):
        return "hand"
    if "gemm" in low:
        return "library"
    return "pytorch"


def hand_launches(names: dict) -> dict:
    """The hand kernels of a profile's {kernel name: launches}, by the counted
    wrapper that launches them: the GEMM core's gemm_wgmma by its MODE
    (csrc/gemm.cuh: 0 sgemm, 1 conv, 2 and 3 atb), its gemm_bf16/gemm_f32 by
    CONV, atb_bf16/atb_f32 as atb; the split-K reduces that follow a split
    call (gemm_splitk_reduce, splitk_reduce_f32) as ``reduce``, any other
    hand kernel as ``other``. K3's dgrads run the conv kernel: ``conv``
    holds them, as the conv wrapper's count does."""
    import re
    out = dict.fromkeys(("sgemm", "conv", "atb", "reduce", "other"), 0)
    for name, n in names.items():
        if kernel_class(name) != "hand":
            continue
        if "splitk_reduce" in name:
            key = "reduce"
        elif "atb_" in name:
            key = "atb"
        elif (m := re.search(r"gemm_wgmma<(\d+),", name)):
            key = ("sgemm", "conv", "atb", "atb")[int(m.group(1))]
        elif (m := re.search(r"gemm_(?:bf16|f32)<(true|false)", name)):
            key = "conv" if m.group(1) == "true" else "sgemm"
        else:
            key = "other"
        out[key] += n
    return out


def lr_rename_only(only: dict) -> bool:
    """Whether an eager step's kernels and a replay's ({name: eager minus
    replay launches}, the equal names left out) differ only as the learning
    rate's form makes them: eagerly the update's scalar products with lr
    (and the decay's lr * weight_decay) take a number
    (BinaryOpScalarFunctor), in the graph a 0-dim device tensor
    (BinaryOpScalarTensorFunctor), launch for launch."""
    num = sum(v for k, v in only.items() if "BinaryOpScalarFunctor" in k and "multiplies" in k)
    ten = sum(v for k, v in only.items()
              if "BinaryOpScalarTensorFunctor" in k and "multiplies" in k)
    named = sum(1 for k in only if "multiplies" in k and "BinaryOpScalar" in k)
    return named == len(only) and num == -ten


def train_calls(pipe, tp: int = 1) -> dict:
    """The K1, K2/K3 and K5 calls of one gen training step of ``pipe``, from
    each conv's and fc's route (ops/kernels/train_conv.py:conv_route):
    {(kernel, what, sig): count}. A conv whose input needs no gradient (fed
    by the data) takes no dgrad; a strided k > 1 conv's backward is the
    library's. Kernel names as in ``counted_wrappers``; ``conv_nhwc`` calls
    also count as ``conv`` launches. ``tp``: the step on a (tp) mesh, where
    each conv and fc whose out_chan tp divides makes its calls once per
    slice, at out_chan / tp."""
    from boda_tpu_torch.ops.kernels.train_conv import conv_route
    from boda_tpu_torch.parallel.train import _needed_ops, find_logits_node, is_trainable
    need = _needed_ops(pipe, [find_logits_node(pipe)])
    req = {k for k in pipe.weights if is_trainable(k)}
    calls = {}
    reps = [1]

    def add(*key):
        calls[key] = calls.get(key, 0) + reps[0]
    for name in pipe.topo_op_order():
        op = pipe.ops[name]
        if name not in need:
            continue
        need_dx = op.bots[0] in req
        if any(b in req for b in op.bots):
            req.update(op.tops)
        if op.type not in ("InnerProduct", "Convolution"):
            continue
        oc_all = pipe.must_dims(op.bots[1])["out_chan"]
        reps[0] = tp if oc_all % tp == 0 else 1
        if op.type == "InnerProduct":
            fd = pipe.must_dims(op.bots[1])
            m, k, n = pipe.must_dims(op.bots[0])["img"], fd["in_feats"], oc_all // reps[0]
            add("sgemm", "fc fwd", (m, k, n))
            if need_dx:
                add("sgemm", "fc dgrad W^T", (m, n, k))
            add("atb", "fc wgrad", (m, k, n))
        else:
            ind, fd = pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1])
            n, h, c, oc = ind["img"], ind["y"], fd["in_chan"], oc_all // reps[0]
            k, s, p = op.kern_sz(), op.stride(), op.pad()
            route = conv_route(k, s, p)
            if route == "k1":
                oh = (h - 1) // s[0] + 1
                m = n * oh * oh
                add("sgemm", "1x1 fwd" + (f" s{s[0]}" if s[0] > 1 else ""), (m, c, oc))
                if need_dx:
                    add("sgemm", "1x1 dgrad W^T" + (f" s{s[0]} zero-stuffed" if s[0] > 1
                                                     else ""), (m, oc, c))
                add("atb", "1x1 wgrad", (m, c, oc))
            else:
                add("conv", "fwd", (n, h, c, oc, k[0], s[0], p[0]))
                if route == "direct":
                    if need_dx:
                        add("conv_nhwc", "dgrad", (n, h, c, oc, k[0], p[0]))
                    add("atb", "wgrad", (n, h, c, oc, k[0], p[0]))
    return calls


def train_launches(calls: dict) -> dict:
    """The launches per counted wrapper that ``train_calls`` implies."""
    out = dict.fromkeys(("sgemm", "conv", "conv_nhwc", "atb"), 0)
    for (kname, _, _), cnt in calls.items():
        out[kname] += cnt
    out["conv"] += out["conv_nhwc"]  # K3's entry runs the conv kernel
    return out


class _Forced(torch.autograd.Function):
    """The value of ``forced`` with the gradient flowing on to ``out``."""

    @staticmethod
    def forward(ctx, out, forced):
        return forced.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def conv_taps(record: dict | None = None, force: dict | None = None):
    """Steps made inside this context keep each conv's and fc's output in
    ``record`` (op name -> tensor), or take the value from ``force`` in
    place of their own while their backward stays theirs: a gen step forced
    to lib's forward values differs from lib's step only in the backward
    kernels, as [grad-bf16]'s gate runs gen's backward from lib's forward."""
    from boda_tpu_torch.parallel import train as ptrain
    orig = ptrain._lower_train

    def lower(pipe, op, ctx, gen, info_log):
        fn, preps = orig(pipe, op, ctx, gen, info_log)
        if op.type not in ("Convolution", "InnerProduct"):
            return fn, preps

        def tapped(*args):
            (o,) = fn(*args)
            if record is not None:
                record[op.name] = o.detach()
            if force is not None:
                o = _Forced.apply(o, force[op.name])
            return (o,)
        return tapped, preps
    ptrain._lower_train = lower
    try:
        yield
    finally:
        ptrain._lower_train = orig


def call_path(kname: str, sig, what: str = "") -> str:
    """The GEMM core's path for a call ``what`` of ``train_calls`` on aligned
    bf16 operands (``core_path``); K5 (``atb``): mma.sync where M is off 8
    elements, N is odd or off 8 on dense rows, else wgmma, or wgmma_edge for
    an even N % 8 != 0 on padded rows. An fc writes dY into rows padded to a
    multiple of 8 elements (ops/kernels/train_conv.py:GenFc), which its
    dgrad reads as A (K = the fc's width) and its wgrad as B (N = it)."""
    padded = what.startswith("fc ")
    if kname == "sgemm":
        k = sig[1]
        return core_path(k, sig[2], conv=False, lda=-(-k // 8) * 8 if padded else None)
    if kname == "atb":
        k, n = sig[1:3] if len(sig) == 3 else sig[2:4]
        if k % 8 or n % 2 or (n % 8 and not padded):
            return "mma"
        return "wgmma_edge" if n % 8 else "wgmma"
    c, oc = sig[2:4]  # conv (n, h, c, oc, ...); conv_nhwc, the dgrad: dy's oc into c
    return core_path(c, oc) if kname == "conv" else core_path(oc, c)


def train_call_checks(tag: str, what_step: str, calls: dict, counted: dict,
                      cases: dict, card: str) -> tuple[list, dict]:
    """Each distinct K1, K2, K3 and K5 call of ``calls`` (``train_calls``) on
    seeded bf16 operands at its shapes against its plain version within
    TRAIN_CALL_TOL, its path asserted by the GEMM core's rule (``call_path``),
    its device time in a CUDA graph beside the library's and its bound; one
    ``[tag]`` line per call. Returns the rows and the kernel us per step by the counts."""
    from boda_tpu_torch.ops.kernels.bconv import matmul_atb
    from boda_tpu_torch.ops.kernels.common import copy_rows
    from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain
    from boda_tpu_torch.rtc.backends import graph_time
    dev = torch.device("cuda")
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(17)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)

    def dgrad_gemm(m, k, n, padded):  # dy (m, oc) @ W^T (oc, c), no bias; an fc's dy
        # in its padded rows (GenFc)
        a, b = rnd((m, k)), rnd((n, k), k ** -0.5).t().contiguous()
        a = copy_rows(a, bf) if padded else a
        return matmul(a, b), matmul_plain(a, b), (
            lambda: matmul(a, b), lambda: matmul_plain(a, b), lambda: a @ b)
    rows, misses, worst = [], [], {}
    for (kname, what, sig), cnt in sorted(calls.items()):
        f = {"sgemm": matmul, "atb": matmul_atb}.get(kname, counted.get(kname))
        fwrap = counted["conv"] if kname in ("conv", "conv_nhwc") else f
        before = dict(fwrap.paths)
        want_path = call_path(kname, sig, what)
        if kname == "sgemm":
            m, k, n = sig
            case = dgrad_gemm(m, k, n, what.startswith("fc ")) if "dgrad" in what else \
                cases["gemm"](m, k, n, False, False, bf)
            bound = max(work("sgemm", (m, k, n, False, False)))
        elif kname == "atb":
            if len(sig) == 3:  # dense: (rows, C, OC); an fc's dy in its padded rows
                case = cases["atb"](*sig, bf, padded=what.startswith("fc "))
                bound = max(work("atb_dense", sig))
            else:
                case = cases["wgrad"](*sig, bf)
                bound = max(work("atb", sig))
        elif kname == "conv":
            n, h, c, oc, k, s, p = sig
            case = cases["conv"](n, h, c, oc, k, s, p, False, False, bf)
            bound = max(work("conv", sig + (False,)))
        else:  # conv_nhwc: K3's entry, the stride-1 dgrad
            n, h, c, oc, k, p = sig
            case = cases["dgrad"](n, h, c, oc, k, p, bf)
            bound = max(work("dgrad", sig))
        path = [q for q in fwrap.paths if fwrap.paths[q] != before[q]]
        got_o, ref, (kern, _, lib) = case
        err = rel_err(got_o, ref)[1]
        ok = err <= TRAIN_CALL_TOL and path == [want_path]
        worst[kname] = max(worst.get(kname, 0.0), err)
        k_us, l_us = graph_time(kern) * 1e6, graph_time(lib) * 1e6
        print(f"[{tag}] {kname} {what} {sig} x{cnt}: {err:.3e} on {path}: "
              f"{'ok' if ok else 'MISS'}; kernel {k_us:.2f} us, library {l_us:.2f} us, "
              f"bound {bound * 1e3:.2f} us")
        rows.append({"kernel": kname, "call": what, "sig": list(sig), "count": cnt,
                     "err": err, "path": path, "kernel_us": k_us, "library_us": l_us,
                     "bound_us": bound * 1e3})
        if not ok:
            misses.append(f"{kname} {what} {sig}")
        del case, got_o, ref
    per_step = {k: sum(r["kernel_us"] * r["count"] for r in rows if r["kernel"] == k)
                for k in ("sgemm", "conv", "conv_nhwc", "atb")}
    print(f"[{tag}] {len(rows)} distinct calls of {what_step} vs plain "
          f"(tol {TRAIN_CALL_TOL}); worst " + ", ".join(f"{k} {v:.3e}" for k, v in
                                                        worst.items())
          + "; kernel us per step by the counts: "
          + ", ".join(f"{k} {v:.1f}" for k, v in per_step.items()) + f" ({card})")
    check(not misses, f"{tag}: calls off their plain version or path: {misses[:5]}")
    return rows, per_step


def train_step_states(step, w0: dict, feeds: list) -> list:
    """The steps of ``step`` from the weights ``w0`` and zero momentum over
    ``feeds`` [(x, labels, step index)]: per step, the loss and a copy of
    every weight and momentum, a tp-split one gathered (the captured step's
    returns are its static tensors, which its next call overwrites)."""
    from boda_tpu_torch.parallel.mesh import Shards

    def copy(v):
        return v.gather() if isinstance(v, Shards) else v.clone()
    w, m, res = w0, None, []
    for x, y, i in feeds:
        loss, w, m = step(w, {"data": x}, y, m, step=i)
        res.append({"loss": loss, **{k: copy(v) for k, v in w.items()},
                    **{f"{k} (momentum)": copy(v) for k, v in m.items()}})
    torch.cuda.synchronize()
    return res


def max_diffs(a: dict, b: dict) -> dict:
    """Per tensor max|a - b| in f32; 0.0 where the two are bit-equal."""
    return {k: 0.0 if torch.equal(a[k], b[k]) else
            float((a[k].float() - b[k].float()).abs().max()) for k in a}


def second_batch(x: torch.Tensor, labels: torch.Tensor, seed: int) -> list:
    """Two feeds [(x, labels, step index)] for a step's replays: the batch,
    then a seeded one of its mean and spread with the labels rolled by one."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    xf = x.float()
    x2 = (torch.randn(x.shape, generator=g, device=x.device) * xf.std() + xf.mean()).to(x.dtype)
    return [(x, labels, 0), (x2, labels.roll(1), 1)]


def zero_state(m: dict) -> dict:
    """f32 zeros shaped as a momentum state (a Shards' parts each on its
    device)."""
    from boda_tpu_torch.parallel.mesh import Shards

    def z(t):
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    return {k: v.map(z, v.axis) if isinstance(v, Shards) else z(v) for k, v in m.items()}


def graph_vs_eager(phase: str, tag: str, make, w0: dict, feeds: list, counted: dict,
                   card: str):
    """``make(cuda_graph)``'s step (parallel/train.py:CapturedStep where
    cuda_graph is set) from the weights ``w0`` over ``feeds``: two eager runs
    and one captured run (``train_step_states``). The loss, every weight
    (the running statistics among them) and every momentum of the captured
    run bit-equal to the first eager run's, or, where the two eager runs
    already differ, no further from it than the second eager run (those
    tensors named); one capture; the wrappers' counts over the captured run
    (two warm-up steps and the capture: a replay calls no wrapper). Returns
    (the eager step, the captured step, the readings)."""
    eager = make(False)
    e1, e2 = (train_step_states(eager, w0, feeds) for _ in range(2))
    graphed = make(True)
    zero_counts(counted)
    t1 = time.perf_counter()
    c = train_step_states(graphed, w0, feeds)
    first_s = time.perf_counter() - t1
    capture_counts = read_counts(counted)  # the replays call no wrapper
    differs, misses, bit = set(), [], True
    for i, (a, b, r) in enumerate(zip(e1, e2, c)):
        de, dc = max_diffs(a, b), max_diffs(a, r)
        differs |= {k for k, v in de.items() if v}
        bit = bit and not any(dc.values())
        misses += [f"step {i} {k}: {dc[k]:.3e} > eager {de[k]:.3e}" for k in dc
                   if dc[k] > de[k]]
    cap = graphed.captured
    print(f"[{phase}] {tag}: {len(feeds)} replays on {cap.captures} capture vs eager, "
          f"{len(e1[0])} tensors per step (loss, weights and running stats, momenta): "
          f"bit-equal {bit}; eager vs eager differs at {sorted(differs)[:6] or 'none'}"
          f"{' ...' if len(differs) > 6 else ''}; first call (2 warm-up steps, the "
          f"capture, a replay) {first_s:.2f} s ({card})")
    for ln in misses[:10]:
        print(f"[{phase}] FAIL {ln}")
    check(not misses, f"{phase} {tag}: captured vs eager")
    check(cap.captures == 1, f"{phase} {tag}: {cap.captures} captures")
    del e1, e2, c
    return eager, graphed, {"bit_equal": bit, "eager_differs": sorted(differs),
                            "first_call_s": first_s, "capture_counts": capture_counts}


def replay_profile(phase: str, tag: str, eager_call, replay, graphed, want: dict,
                   capture_counts: dict, card: str) -> dict:
    """One eager step (``eager_call``) against one replay of ``graphed``'s
    graph: their kernels (torch.profiler, each name's median over
    TRAIN_GRAPH_PROFILES calls) the same total, differing by name only in
    the lr's form (``lr_rename_only``); the hand kernels per wrapper
    (``hand_launches``) equal in the eager step and in every profiled replay,
    and equal to ``want`` (train_launches; {} where no hand kernel runs);
    the wrappers' counts over the first graphed call (``capture_counts``) 3
    x ``want``. Their device busy ms and the ms per step of both (CUDA
    events over TRAIN_GRAPH_REPS calls; ``replay`` a call of the step with
    its own static tensors)."""
    en, ebusy, ereads = kernel_counts(eager_call, TRAIN_GRAPH_PROFILES)
    cn, cbusy, creads = kernel_counts(graphed.captured.graph.replay, TRAIN_GRAPH_PROFILES)
    ems = cuda_ms(eager_call, TRAIN_GRAPH_REPS, 1)
    cms = cuda_ms(replay, TRAIN_GRAPH_REPS, 1)
    # a graph runs its copy and fill nodes as kernels named memcpy*/memset*:
    # the copies into the static tensors, the eager step's Memcpy/Memset
    nodes = {k: v for k, v in cn.items() if k.startswith(("memcpy", "memset"))}
    ne, nc = sum(en.values()), sum(cn.values()) - sum(nodes.values())
    only = {k: en.get(k, 0) - cn.get(k, 0) for k in set(en) | set(cn)
            if en.get(k, 0) != cn.get(k, 0) and k not in nodes}
    # the hand kernels per wrapper: in each profiled replay, in the eager step,
    # and the wrappers' own counts over the first graphed call
    he, hc = hand_launches(en), hand_launches(cn)
    hreads = [hand_launches(r) for r in creads]
    want_hand = {k: want.get(k, 0) for k in ("sgemm", "conv", "atb")}
    print(f"[{phase}] {tag}: kernels per step eager {ne}, replay {nc} (and "
          f"{sum(nodes.values())} copy and fill nodes {nodes}; per profiled call "
          f"eager {[sum(r.values()) for r in ereads]}, replay "
          f"{[sum(r.values()) for r in creads]}); hand kernels per wrapper eager "
          f"{he}, replay {hc} (each replay's {[hr == hreads[0] for hr in hreads]} "
          f"equal), expected {want_hand} and a reduce per split call; wrapper "
          f"counts over the first graphed call (2 warm-up steps and the capture) "
          f"{capture_counts}"
          + (f"; by name, eager minus replay: {only}" if only else "")
          + f"; device busy eager {ebusy:.3f} ms, replay {cbusy:.3f} ms; ms per step "
          f"eager {ems:.3f}, replay {cms:.3f} (busy share {ebusy / ems:.3f} / "
          f"{cbusy / cms:.3f}); copies in {graphed.captured.copies} ({card})")
    check(ne == nc and ne > 0 and lr_rename_only(only),
          f"{phase} {tag}: kernels eager {ne}, replay {nc}, by name {only}")
    check(he == hc and all(hr == hc for hr in hreads) and
          all(hc[k] == v for k, v in want_hand.items()) and hc["other"] == 0,
          f"{phase} {tag}: hand kernels eager {he}, replays {hreads}, expected {want_hand}")
    check(all(v == 3 * want.get(k, 0) for k, v in capture_counts.items()),
          f"{phase} {tag}: wrapper counts {capture_counts}, expected 3 x {want}")
    return {"kernels": ne, "copy_nodes": sum(nodes.values()), "hand_eager": he,
            "hand_replay": hc, "eager_busy_ms": ebusy, "replay_busy_ms": cbusy,
            "eager_ms": ems, "replay_ms": cms}


def train_graph_checks(card: str, pipe, w0: dict, x: torch.Tensor, labels: torch.Tensor,
                       want: dict, counted: dict) -> dict:
    """[train]'s compiled step (parallel/train.py:CapturedStep), ResNet-50
    b32 bf16, momentum 0.9, clip 1.0, cuDNN's deterministic algorithms: for
    gen and lib, BN frozen and in train mode, ``graph_vs_eager`` over two
    steps from the same weights on two different batches, then
    ``replay_profile``: the kernels of one replay against one eager step's,
    the hand kernels per wrapper equal to ``want`` (train_launches) under
    gen, 0 under lib, both ms per step; and what the body's copies into the
    static tensors cost alone in a graph. A cosine schedule with decoupled
    decay over three replays on one capture, held the same way; a capture
    failure planted in mini_resnet's first conv raises, naming the op, and
    leaves no graph."""
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.parallel import train as ptrain
    from boda_tpu_torch.parallel.schedules import make_lr_schedule
    from boda_tpu_torch.parallel.train import find_logits_node, make_train_step
    t0 = time.perf_counter()
    dev = x.device
    two = second_batch(x, labels, 26)
    out: dict = {}

    def hold(tag: str, kw: dict, feeds: list):
        return graph_vs_eager("train-graph", tag, lambda cg: make_train_step(
            pipe, "fc1000", cuda_graph=cg, **kw), w0, feeds, counted, card)

    for pol in ("gen", "lib"):
        for bn in (0.0, 0.1):
            mode = "train-mode BN" if bn else "BN frozen"
            tag = f"resnet50 b{x.shape[0]} bf16 {pol}, {mode}"
            kw = dict(lr=0.01, clip_norm=1.0, momentum=0.9, bn_momentum=bn,
                      kernel_policy=pol)
            eager, graphed, res = hold(tag, kw, two)
            # one eager step and one replay: kernels, device ms, ms per step
            m0 = zero_state(graphed.captured.m)
            cw, cm = dict(graphed.captured.w), dict(graphed.captured.m)
            prof = replay_profile(
                "train-graph", tag, lambda: eager(w0, {"data": x}, labels, m0),
                lambda: graphed(cw, {"data": x}, labels, cm), graphed,
                want if pol == "gen" else {}, res["capture_counts"], card)
            # what the copies into the static tensors cost a replay: the same
            # memcpy nodes (each momentum, and the loss) alone in a graph
            srcs = [t.clone() for t in cm.values()] + [graphed.captured.loss.clone()]
            dsts = list(cm.values()) + [graphed.captured.loss]
            cg = torch.cuda.CUDAGraph()
            with torch.cuda.graph(cg):
                for d_, s_ in zip(dsts, srcs):
                    d_.copy_(s_)
            copy_ms = cuda_ms(cg.replay, TRAIN_GRAPH_REPS, 1)
            copy_mb = sum(t.numel() * t.element_size() for t in srcs) / 1e6
            print(f"[train-graph] {tag}: the body's {len(dsts)} same-dtype copies into the "
                  f"static tensors (each momentum, the loss; {copy_mb:.1f} MB, held twice: "
                  f"the graph's pool keeps the new values) alone in a graph: {copy_ms:.4f} "
                  f"ms per replay ({card})")
            del cg, srcs, dsts
            out[f"{pol}_bn{bn}"] = dict(res, **prof, copy_ms=copy_ms, copy_mb=copy_mb)
            del eager, graphed, cw, cm, m0
            torch.cuda.empty_cache()

    # -- a cosine schedule with decay: three replays, one capture ----------------------
    sched = make_lr_schedule("cosine", 0.01, total_steps=3)
    kw = dict(lr=0.01, clip_norm=1.0, momentum=0.9, weight_decay=1e-4, lr_schedule=sched,
              kernel_policy="gen")
    _, graphed, res = hold(f"resnet50 b{x.shape[0]} bf16 gen, cosine lr "
                           f"{[float(sched(i)) for i in range(3)]} with decay 1e-4",
                           kw, two + [(x, labels, 2)])
    out["cosine"] = res
    del graphed
    torch.cuda.empty_cache()

    # -- a capture that fails raises, names the op and leaves no graph ------------------
    mp, mdims = build_model("mini_resnet", img=8, num_cls=16, in_sz=16)
    first = next(o for o in mp.topo_op_order() if mp.ops[o].type == "Convolution")
    orig = ptrain._lower_train

    def planted(p, op, ctx, gen, info_log):
        fn, preps = orig(p, op, ctx, gen, info_log)
        if op.name != first:
            return fn, preps

        def failing(*args):
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a failure planted in the capture")
            return fn(*args)
        return failing, preps
    ptrain._lower_train = planted
    try:
        step = make_train_step(mp, find_logits_node(mp), lr=0.05, momentum=0.9,
                               cuda_graph=True)
    finally:
        ptrain._lower_train = orig
    wm = {k: torch.from_numpy(np.ascontiguousarray(v.data)).to(dev)
          for k, v in mp.weights.items()}
    xm = torch.zeros(mdims["data"].shape, device=dev)
    msg = ""
    try:
        step(wm, {"data": xm}, torch.zeros(8, dtype=torch.int64, device=dev))
    except RuntimeError as e:
        msg = str(e)
    print(f"[train-graph] a failure planted in {first!r} during the capture: raised "
          f"{msg[:160]!r}; graph left {step.captured.graph}")
    check(f"capture failed at op {first!r}" in msg and step.captured.graph is None,
          "train-graph: the planted capture failure")
    out["seconds"] = time.perf_counter() - t0
    print(f"[train-graph] took {out['seconds']:.1f} s ({card})")
    return out


def train_phase(card: str, pipe, fc_scale: float, counted: dict, cases: dict) -> dict:
    """[train]: the training step (parallel/train.py) on the card. ResNet-50
    b32 224x224 bf16 in train_bench's configuration (weights bf16, clip 1.0,
    lr 0.01; fc1000 scaled as everywhere), one step from the same weights and
    batch under gen and lib with BN frozen and in train mode: the loss and
    the running stats within TRAIN_TOL, and every trainable weight's gradient
    (a step with momentum 0.9 from zero momentum: its momentum is the
    clipped f32 gradient) of gen's step forced to lib's conv and fc outputs
    (``conv_taps``) against lib's; the same at b8 f32 within TRAIN_F32_TOL,
    with cuDNN's deterministic algorithms. The gen step's launches per wrapper,
    exact, and no library conv but the strided k > 1 backwards (profiler op
    counts); each distinct K1, K2, K3 and K5 call of the gen step against its
    plain version, its path asserted, its device time beside its bound;
    train_bench through the CLI under gen and lib; the learning gate of
    tests/test_learning.py (shapesnet2, 150 steps, test_lmdb --ckpt-fn) and
    its bn_freeze_at run; kill and resume (mini_resnet 3+3 against 6)."""
    import os
    import re

    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern
    from boda_tpu_torch.parallel.train import make_train_step
    from boda_tpu_torch.utils.digest import comp_vars
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"card": card}
    dev = torch.device("cuda")
    logits = "fc1000"
    n_img = pipe.must_dims("data")["img"]
    labels = (torch.arange(n_img) % 1000).to(dev)

    def batch(p, dt):
        d = p.must_dims("data")
        return gen_data_pattern(d.shape, d.tn).to(dev, dt)

    def weights_of(p, dt):
        return {k: torch.from_numpy(np.asarray(w.data, np.float32)).to(dev, dt)
                for k, w in p.weights.items()}

    def one_step(p, w, x, lab, pol, mom, bn, prec="default"):
        step = make_train_step(p, logits, lr=0.01, clip_norm=1.0, momentum=mom,
                               bn_momentum=bn, precision=prec, kernel_policy=pol)
        r = step(w, {"data": x}, lab)
        torch.cuda.synchronize()
        return r, step

    def layer_filts(p) -> dict:
        """Each weight -> the filters of the conv or fc it follows (its own,
        or the one upstream of its BN or Scale)."""
        prod = {t: op for op in p.ops.values() for t in op.tops}
        out = {}
        for op in p.ops.values():
            src = op
            while src is not None and src.type not in ("Convolution", "InnerProduct"):
                src = prod.get(src.bots[0]) if src.bots else None
            for b in op.bots[1:] if src is not None else ():
                out[b] = src.bots[1]
        return out

    def agree(ref: dict, got: dict, tol: float, floor=None) -> tuple[list, float, str]:
        """comp_vars(tol, atol=tol * scale) per tensor, scale its max|ref| or,
        given ``floor`` (weight -> the filters of its layer), the larger of
        that and its layer's filter gradient's max|ref|: a bias or Scale
        parameter ahead of train-mode BN has a gradient of ~0 (BN takes out
        the batch mean), so its computed value is rounding noise."""
        fails, worst, at = [], 0.0, ""
        for k in ref:
            a, b = ref[k].float().cpu().numpy(), got[k].float().cpu().numpy()
            check(bool(np.isfinite(b).all()), f"train: {k} not finite")
            scale = max(1e-30, float(np.abs(a).max()))
            if floor is not None and floor.get(k) in ref:
                scale = max(scale, float(ref[floor[k]].float().abs().max()))
            r = comp_vars(a, b, mrd_toler=tol, atol=tol * scale)
            if r.mad / scale > worst:
                worst, at = r.mad / scale, k
            if not r.ok():
                fails.append(f"{k}: {r}")
        return fails, worst, at

    def compare(tag, p, dt, tol, prec):
        """One step under gen and under lib (free runs: loss and running
        stats gated; the gradients reported, since the two forwards put some
        ReLU inputs on opposite sides of 0), then gen's step forced to lib's
        conv and fc outputs: every gradient gated."""
        w, x = weights_of(p, dt), batch(p, dt)
        lab = labels[:p.must_dims("data")["img"]]
        floor = layer_filts(p)
        for bn in (0.0, 0.1):
            res, lib_outs = {}, {}
            for pol, taps in (("lib", {"record": lib_outs}), ("gen", {}),
                              ("gen_forced", {"force": lib_outs})):
                with conv_taps(**taps):
                    (loss, nw, mom), _ = one_step(p, w, x, lab, pol[:3], 0.9, bn, prec)
                stats = {k: v for k, v in nw.items() if k.endswith(("__means", "__vars"))}
                res[pol] = (float(loss), mom, stats)
            (lg, mg, sg), (ll, ml, sl), mf = res["gen"], res["lib"], res["gen_forced"][1]
            lerr = abs(lg - ll) / abs(ll)
            _, gw, gat = agree(ml, mg, tol, floor)
            strict = agree(ml, mf, tol)[0]
            ffails, fw, fat = agree(ml, mf, tol, floor)
            sfails, sw, sat = agree(sl, sg, tol) if bn else ([], 0.0, "")
            mode = "train-mode BN (bn_momentum 0.1)" if bn else "BN frozen"
            print(f"[train] {tag}, {mode}, one step gen vs lib: loss {lg:.6g} / {ll:.6g} "
                  f"(rel {lerr:.3e})"
                  + (f"; {len(sl)} running stats, {len(sfails)} disagree, worst {sw:.3e} "
                     f"at {sat}" if bn else "")
                  + f"; {len(ml)} gradients, free run worst max|err|/max|lib| {gw:.3e} at "
                  f"{gat} (not gated); gen forced to lib's conv/fc outputs: "
                  f"{len(ffails)} disagree, worst {fw:.3e} at {fat} (comp_vars {tol}, atol "
                  f"from the layer's filter gradient; against each tensor's own max: "
                  f"{len(strict)} disagree) ({card})")
            if strict:
                print("[train] off their own max only: " + ", ".join(
                    ln.split(":")[0] for ln in strict))
            for ln in (ffails + sfails)[:10]:
                print(f"[train] FAIL {ln}")
            check(lerr <= tol and not ffails and not sfails,
                  f"train {tag} {mode}: gen vs lib")
            out.setdefault("agree", {})[f"{tag} {mode}"] = {
                "loss_rel": lerr, "grad_forced_worst": fw, "grad_free_worst": gw,
                "stats_worst": sw}
            del res, lib_outs
        del w, x

    # -- bf16 b32 and f32 b8: gen against lib ------------------------------------
    compare(f"resnet50 b{n_img} bf16", pipe, torch.bfloat16, TRAIN_TOL, "default")
    fpipe, _ = load_net("resnet50", img=TRAIN_F32_BATCH)
    scale_fc1000([fpipe], fc_scale)
    torch.backends.cudnn.deterministic = True
    try:
        compare(f"resnet50 b{TRAIN_F32_BATCH} f32", fpipe, torch.float32, TRAIN_F32_TOL,
                "highest")
    finally:
        torch.backends.cudnn.deterministic = False
    del fpipe

    # -- the gen step's launches, exact; library convs only as named ---------------
    calls = train_calls(pipe)
    want = train_launches(calls)
    w, x = weights_of(pipe, torch.bfloat16), batch(pipe, torch.bfloat16)
    for pol in ("gen", "lib"):
        step = make_train_step(pipe, logits, lr=0.01, clip_norm=1.0, kernel_policy=pol)
        step(w, {"data": x}, labels)  # warm-up: cuDNN's algorithms, the plan caches
        torch.cuda.synchronize()
        zero_counts(counted)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            loss, _ = step(w, {"data": x}, labels)
            torch.cuda.synchronize()
        got = read_counts(counted)
        ops, kern, n_dev = {}, {}, 0
        for ev in prof.events():
            if ev.name in ("aten::convolution", "aten::convolution_backward", "aten::mm",
                           "aten::addmm"):
                ops[ev.name] = ops.get(ev.name, 0) + 1
            if ev.device_type == torch.autograd.DeviceType.CUDA and \
                    "Memcpy" not in ev.name and "Memset" not in ev.name:
                kern[ev.name] = kern.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3
                n_dev += 1
        busy = sum(kern.values())
        by = {}
        for n, t in kern.items():
            by[kernel_class(n)] = by.get(kernel_class(n), 0.0) + t
        named = [ln.split(":")[0] for ln in step.info_log if "bck=library" in ln]
        print(f"[train] resnet50 b{n_img} bf16 {pol} step (momentum 0, BN frozen): loss "
              f"{float(loss):.6g}; launches {got}; library ops {ops}"
              + (f"; library backward (strided k>1): {named}" if pol == "gen" else "")
              + f"; device (torch.profiler): {n_dev} kernels, {busy:.3f} ms busy: "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(by.items())) + f" ms ({card})")
        out[f"device_{pol}"] = {"kernels": n_dev, "busy_ms": busy, "by_class_ms": by}
        if pol == "gen":
            check(all(got[k] == v for k, v in want.items()) and
                  all(got[k] == 0 for k in got if k not in want),
                  f"train gen launches {got}, expected {want}")
            check(ops.get("aten::convolution", 0) == 0 and
                  ops.get("aten::convolution_backward", 0) == len(named) and
                  ops.get("aten::mm", 0) == ops.get("aten::addmm", 0) == 0,
                  f"train gen: library ops {ops}, named fallbacks {named}")
            out["launches_gen"] = got
            out["library_bck"] = named
        else:
            check(not any(got.values()), f"train lib launched kernels: {got}")
            out["launches_lib"] = got
    del w, x

    # -- each distinct K1, K2, K3 and K5 call of the gen step vs its plain version ---
    rows, per_step = train_call_checks("train", f"the gen b{n_img} bf16 step", calls,
                                       counted, cases, card)
    out["calls"], out["kernel_us_per_step"] = rows, per_step

    # -- the compiled step against the eager step -------------------------------------
    torch.backends.cudnn.deterministic = True
    try:
        out["graph"] = train_graph_checks(card, pipe, weights_of(pipe, torch.bfloat16),
                                          batch(pipe, torch.bfloat16), labels, want, counted)
    finally:
        torch.backends.cudnn.deterministic = False

    # -- train_bench through the CLI: BN frozen (its default) and train-mode, the step
    # -- captured (its default) and eager; the busy share from [train-graph]'s profile
    for bn in ("0", "0.1"):
        for pol in ("gen", "lib"):
            for cg in ("1", "0"):
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated() / 2 ** 30  # the script's own tensors
                rc, lines = run_cli(["train_bench", "--model=resnet50", f"--img={n_img}",
                                     f"--kernel-policy={pol}", f"--bn-momentum={bn}",
                                     f"--cuda-graph={cg}"])
                peak = torch.cuda.max_memory_allocated() / 2 ** 30 - held
                js = json.loads(next((ln for ln in reversed(lines) if ln.startswith("{")),
                                     "{}"))
                ms = js.get("secs_per_step", 0) * 1e3
                busy = out["graph"][f"{pol}_bn{float(bn)}"][
                    "replay_busy_ms" if cg == "1" else "eager_busy_ms"]
                print(f"[train] train_bench resnet50 b{n_img} bf16 {pol} --bn-momentum={bn} "
                      f"--cuda-graph={cg} rc={rc}: {ms:.3f} ms/step, "
                      f"{js.get('img_per_sec')} img/s, {js.get('TF_per_s')} TF/s, device "
                      f"busy share {busy / max(ms, 1e-9):.3f} ({busy:.3f} ms of kernels per "
                      f"step), peak {peak:.2f} GiB over the {held:.2f} the script held, loss "
                      f"{js.get('loss_first')} -> {js.get('loss_last')} ({card})")
                check(rc == 0 and js.get("loss_decreased") is True,
                      f"train_bench {pol} --cuda-graph={cg}: {js}")
                out[f"train_bench_{pol}_bn{bn}_cg{cg}"] = dict(js, peak_gib=peak,
                                                               busy_share=busy / max(ms, 1e-9))

    # -- learning on the card: the deep gate, and bn_freeze_at ----------------------
    bdir = os.path.join(root, "build", "chip_smoke")
    os.makedirs(bdir, exist_ok=True)
    t0 = time.perf_counter()
    rc, lines = run_cli(["train_lmdb", *LEARN_ARGS, "--ckpt-fn=shapesnet2_train.npz",
                         f"--boda-output-dir={bdir}"])
    curve = {int(m.group(1)): float(m.group(2)) for ln in lines
             for m in [re.match(r"step (\d+): loss ([0-9.eE+-]+)", ln)] if m}
    learn_s = time.perf_counter() - t0
    ms = [curve.get(i, float("inf")) for i in (0, 25, 50, 100, 125)]
    print(f"[train] train_lmdb shapesnet2 150 steps b16 rc={rc}: losses at 0/25/50/100/125 "
          f"{ms} (bounds >= {LEARN_INIT_MIN}, <= {LEARN_BOUNDS}), {learn_s:.1f} s; "
          f"{lines[-1] if lines else ''}")
    check(rc == 0 and ms[0] >= LEARN_INIT_MIN and
          all(curve.get(i, float("inf")) <= b for i, b in LEARN_BOUNDS.items()) and
          all(a > b for a, b in zip(ms, ms[1:])), f"learning gate: curve {ms}")
    rc, lines = run_cli(["test_lmdb", "--ptt-fn=testdata/nets/shapesnet2.prototxt",
                         "--rec-fn=testdata/lmdb/shapes10_test.rec", "--img=8",
                         f"--ckpt-fn={bdir}/shapesnet2_train.npz"])
    got = next((ln for ln in reversed(lines) if ln.startswith("test_lmdb: n=")), "")
    top1 = float(re.search(r"top1=([0-9.]+)", got).group(1)) if got else 0.0
    print(f"[train] test_lmdb --ckpt-fn on the card's checkpoint rc={rc}: "
          + " / ".join(ln for ln in lines if ln.startswith("test_lmdb:"))
          + f" (gate top1 >= {LEARN_TOP1})")
    check(rc == 0 and top1 >= LEARN_TOP1, f"learning gate: top1 {top1}")
    rc, lines = run_cli(["train_lmdb", "--ptt-fn=testdata/nets/shapesnet2.prototxt",
                         "--rec-fn=testdata/lmdb/shapes10_train.rec", "--img=8",
                         "--n-steps=20", "--lr=0.05", "--bn-momentum=0.1",
                         "--bn-freeze-at=10", "--log-every=5"])
    froze = "step 10: BN frozen (inference running stats)" in lines
    print(f"[train] train_lmdb --bn-freeze-at=10 rc={rc}: switch printed {froze}; "
          f"{lines[-1] if lines else ''}")
    check(rc == 0 and froze and lines[-1].endswith("(improved)"), "bn_freeze_at run")
    out["learning"] = {"curve": curve, "top1": top1, "seconds": learn_s}

    # -- kill and resume: mini_resnet 3+3 against 6 --------------------------------
    common = ["train_lmdb", "--rec-fn=testdata/lmdb/cifar_mini.rec", "--model=mini_resnet",
              "--img=4", "--lr-schedule=cosine", "--warmup-steps=2"]
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for args in (["--n-steps=6", f"--boda-output-dir={bdir}/full"],
                     ["--n-steps=3", "--ckpt-fn=ck.npz", f"--boda-output-dir={bdir}/split"],
                     ["--n-steps=6", "--ckpt-fn=ck.npz", "--resume=1",
                      f"--boda-output-dir={bdir}/split"]):
            if "--resume=1" not in args and os.path.exists(f"{bdir}/split/ck.npz"):
                os.remove(f"{bdir}/split/ck.npz")
            rc, lines = run_cli(common + args)
            check(rc == 0, f"kill and resume: {args} rc {rc}")
            runs.append({int(m.group(1)): float(m.group(2)) for ln in lines
                         for m in [re.match(r"step (\d+): loss ([0-9.eE+-]+)", ln)] if m})
    finally:
        torch.backends.cudnn.deterministic = False
    full, resumed = runs[0], runs[2]
    rerr = max(abs(full[i] - resumed[i]) / abs(full[i]) for i in (3, 4, 5)) \
        if set(resumed) == {3, 4, 5} else float("inf")
    print(f"[train] kill and resume mini_resnet on the card: steps 3-5 resumed "
          f"{[resumed.get(i) for i in (3, 4, 5)]} vs straight {[full[i] for i in (3, 4, 5)]}, "
          f"worst rel {rerr:.3e} (tol {TRAIN_RESUME_TOL})")
    check(rerr <= TRAIN_RESUME_TOL, "kill and resume on the card")
    out["resume_rel"] = rerr
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[train] phase took {out['seconds']:.1f} s ({card})")
    return out


# [tools] (rtc's tooling): net_trace's in-net share, train_trace's rollup and
# the ipc worker on the card
TRACE_MAPPED_MIN = 0.95   # net_trace: the share of kernel time a graph op holds
TRACE_BUSY_TOL = 0.15     # net_trace's total per forward vs the eager device-busy time
TRAIN_TRACE_SUM_TOL = 0.01  # train_trace's rollup vs the trace's kernel total
TRAIN_TRACE_OTHER_MAX = 0.05  # train_trace's (other) share


def trace_rows(lines: list[str], marker: str, per_what: str) -> dict:
    """{row: us per forward or step} of a tool mode's table after the line
    holding ``marker``."""
    rows, on = {}, False
    for ln in lines:
        if marker in ln:
            on = True
        elif on and ln.startswith("  ") and f" us/{per_what}" in ln:
            rows[ln[2:].rsplit(f" us/{per_what}", 1)[0].rsplit(None, 1)[0].strip()] = \
                float(ln.rsplit(f" us/{per_what}", 1)[0].rsplit(None, 1)[1])
        elif on:
            break
    return rows


def kernel_rows(evs: list, ops, pick, train: bool) -> dict:
    """{row: number of kernels} of a trace, over the kernels whose names
    ``pick`` takes: net_trace's attribution with every kernel counted 1."""
    from boda_tpu_torch.modes.net_trace import attribute
    sub = [dict(e, dur=1.0) if e.get("cat") == "kernel" else e for e in evs
           if e.get("cat") != "kernel" or pick(e["name"])]
    if not any(e.get("cat") == "kernel" for e in sub):
        return {}  # (a trace without kernels is attributed as host time)
    return attribute(sub, ops, train=train)[0]


def ipc_sgemm(be, a, b) -> np.ndarray:
    """c = a @ b through the rtc sgemm op on backend ``be`` (bf16)."""
    from boda_tpu_torch.ops.op_base import Op
    from boda_tpu_torch.ops.registry import Codegen
    from boda_tpu_torch.utils.dims import NDA, Dims
    (m, k), n = a.shape, b.shape[1]
    ds = {"a": Dims.of(M=m, K=k, tn="bfloat16"), "b": Dims.of(K=k, N=n, tn="bfloat16"),
          "c": Dims.of(M=m, N=n, tn="bfloat16")}
    cg = Codegen(be)
    fi = cg.gen_func(Op("sgemm", {}, ds))
    be.create_var_from_nda("a", NDA(ds["a"], a))
    be.create_var_from_nda("b", NDA(ds["b"], b))
    be.create_var_with_dims("c", ds["c"])
    cg.compile()
    cg.run_func(fi, {"a": "a", "b": "b", "c": "c"})
    return be.copy_var_to_nda("c").data


def tools_phase(card: str, out_dir, counted: dict) -> dict:
    """[tools]: rtc's tooling through the CLI in process, ResNet-50 b32 bf16
    gen. net_trace --per-op over 4 eager forwards: the share of kernel time
    attributed to graph ops, every conv and fc row on the hand kernels (no
    cuDNN or cuBLAS kernel in them), its total per forward against the same
    engine's eager device-busy time (torch.profiler, this script's own sum),
    the replay's ms beside it. train_trace over 2 steps, BN frozen and
    train-mode: the rollup against the trace's kernel total, (other), every
    conv's [fwd] and [bwd] rows, K5's kernels and K3's (the conv kernel's
    launches through conv2d_nhwc) in [bwd] rows only, K2's in [fwd] ones.
    net_ab gen against lib; net_tune on the hottest signature group, and on
    the stem's across programs, its wisdom read back by run_cnet; cnn_prof
    and cnn_op_info timed (every row, %-peak <= 100); net_decomp's stage
    table; cs_test_master over a spawned worker on the card; sgemm through
    an ipc worker over fds: and tcp:, bit-equal to the call in process. The
    tables go to build/chip_smoke/tools/."""
    import os
    import re
    import socket

    from boda_tpu_torch.config import make
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.modes.net_trace import attribute, load_trace
    from boda_tpu_torch.ops.kernels.conv import conv2d_nhwc
    from boda_tpu_torch.utils.lexp import parse_lexp
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    tdir = os.path.join(root, "build", "chip_smoke", "tools")
    os.makedirs(tdir, exist_ok=True)
    out = {"card": card}
    gen_cfg = "(mode=cuda,compute_tn=bfloat16)"
    lib_cfg = "(mode=cuda,compute_tn=bfloat16,kernel_policy=lib)"
    net = ["--model=resnet50", f"--img={BATCH}"]
    pipe, in_dims = load_net("resnet50", img=BATCH)
    convfc = [o for o, op in pipe.ops.items() if op.type in ("Convolution", "InnerProduct")]
    zero_counts(counted)

    def cli(name, argv):
        rc, lines = run_cli(argv + [f"--boda-output-dir={tdir}"])
        with open(os.path.join(tdir, f"{name}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        return rc, lines

    # -- net_trace: the gen forward per op, eager, beside the replay ------------------
    rc, lines = cli("net_trace", ["net_trace", *net, "--per-op=1", "--n-iters=4", "--top-k=0",
                                  "--unmapped=8", f"--conv-fwd={gen_cfg}"])
    check(rc == 0, "net_trace")
    rows = trace_rows(lines, "per-op device time over 4 forwards", "fwd")
    tot = sum(rows.values())
    mapped = 1.0 - rows.get("(other)", 0.0) / max(tot, 1e-9)
    replay_ms = float(re.search(r"replay ([0-9.]+) ms/fwd", lines[0]).group(1))
    evs = load_trace(os.path.join(tdir, "trace", "resnet50.pt.trace.json"))
    lib_rows = kernel_rows(evs, pipe.ops, lambda n: kernel_class(n) == "library", False)
    hand_rows = kernel_rows(evs, pipe.ops, lambda n: kernel_class(n) == "hand", False)
    on_lib = sorted(o for o in convfc if o in lib_rows)
    lib_names = sorted({e["name"][:90] for e in evs if e.get("cat") == "kernel"
                        and kernel_class(e["name"]) == "library"})
    # the chain heads: a conv fused with its BN/Scale/ReLU is one row
    heads = [o for o in convfc if o in rows]
    off_hand = sorted(o for o in heads if o not in hand_rows)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16", cuda_graph=False)
    eng.init(pipe)
    ins = gen_data_inputs(in_dims)
    eng.run_fwd(ins, ["prob"])
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(4):
            eng.run_fwd(ins, ["prob"])
        torch.cuda.synchronize()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "Memcpy" not in e.name and "Memset" not in e.name) / 4
    del eng
    print(f"[tools] net_trace resnet50 b{BATCH} bf16 gen, 4 eager forwards: {len(rows)} rows, "
          f"{tot:.1f} us/fwd in kernels, {100 * mapped:.2f}% on graph ops (min "
          f"{100 * TRACE_MAPPED_MIN:.0f}%); eager device-busy {busy:.1f} us/fwd (torch.profiler, "
          f"no attribution: {tot / busy:.3f}x); replay {replay_ms:.3f} ms/fwd; {len(heads)} "
          f"conv/fc rows, {len(off_hand)} without a hand kernel, {len(on_lib)} with a library "
          f"kernel; library kernels in the trace {lib_names} ({card})")
    for ln in lines[:40]:
        print(f"[tools]   {ln}")
    check(mapped >= TRACE_MAPPED_MIN, f"net_trace: {mapped:.4f} of kernel time on graph ops")
    check(abs(tot / busy - 1) <= TRACE_BUSY_TOL, f"net_trace total {tot:.1f} vs busy {busy:.1f}")
    check(len(heads) >= 20 and not off_hand and not on_lib,
          f"net_trace conv/fc rows: off the hand kernels {off_hand[:5]}, library {on_lib[:5]}")
    out["net_trace"] = {"rows": rows, "us_per_fwd": tot, "mapped": mapped, "busy_us": busy,
                        "replay_ms": replay_ms}

    # -- train_trace: BN frozen and train-mode ----------------------------------------
    convs = [o for o, op in pipe.ops.items() if op.type == "Convolution"]
    k2_fwd = sum(1 for o in convs if pipe.ops[o].kern_sz() != (1, 1))

    # the GEMM core's kernels by mode (csrc/gemm.cuh: 0 dense, 1 conv, 2 and 3
    # K5's): K2's and K3's launches run the conv mode, the C = 3 stem on mma
    def conv_mode(n):
        return re.search(r"gemm_wgmma<\s*1\s*,", n) is not None or "gemm_bf16<true" in n
    for bn in ("0", "0.1"):
        k3_0 = conv2d_nhwc.launches
        rc, lines = cli(f"train_trace_bn{bn}", ["train_trace", *net, "--n-iters=2",
                                                f"--bn-momentum={bn}", "--top-k=0",
                                                "--unmapped=8"])
        check(rc == 0, f"train_trace --bn-momentum={bn}")
        k3 = (conv2d_nhwc.launches - k3_0) * 2 // 3  # 3 steps ran, 2 traced
        evs = load_trace(os.path.join(tdir, "trace", "resnet50_train.pt.trace.json"))
        ktot = sum(float(e["dur"]) for e in evs if e.get("cat") == "kernel") / 2
        roll = trace_rows(lines, "train-step phase rollup", "step")
        per = attribute(evs, pipe.ops, train=True)[0]
        missing = [c for c in convs if f"{c} [fwd]" not in per or f"{c} [bwd]" not in per]
        k5 = kernel_rows(evs, pipe.ops, lambda n: re.search(r"gemm_wgmma<\s*[23]\s*,", n)
                         is not None or "atb_bf16" in n or "atb_f32" in n, True)
        cm = kernel_rows(evs, pipe.ops, conv_mode, True)
        cm_f = sum(v for k, v in cm.items() if k.endswith("[fwd]"))
        cm_b = sum(v for k, v in cm.items() if k.endswith("[bwd]"))
        k5_off = sorted(k for k in k5 if not k.endswith("[bwd]"))
        rsum = sum(roll.values())
        oth = roll.get("(other)", 0.0) / max(ktot, 1e-9)
        names = sorted({e["name"].split("(")[0] for e in evs if e.get("cat") == "kernel"
                        and kernel_class(e["name"]) == "hand"})
        mode = "train-mode BN (bn_momentum 0.1)" if bn != "0" else "BN frozen"
        print(f"[tools] train_trace resnet50 b{BATCH} bf16 gen, {mode}, 2 steps: rollup "
              + ", ".join(f"{k} {v:.1f}" for k, v in roll.items())
              + f" us/step, sum {rsum:.1f} against the trace's kernels {ktot:.1f} "
              f"({rsum / ktot - 1:+.3%}); (other) {100 * oth:.2f}%; convs without a [fwd] and a "
              f"[bwd] row {missing[:3]}; K5 kernels per step off [bwd] rows {k5_off[:3]}; "
              f"conv-mode kernels [fwd] {cm_f / 2:g} (K2 {k2_fwd}) [bwd] {cm_b / 2:g} (K3 "
              f"{k3 / 2:g}); hand kernels {names} ({card})")
        for ln in lines[:60]:
            print(f"[tools]   {ln}")
        check(abs(rsum / ktot - 1) <= TRAIN_TRACE_SUM_TOL, f"train_trace rollup {rsum} vs {ktot}")
        check(oth <= TRAIN_TRACE_OTHER_MAX, f"train_trace (other) {oth:.4f}")
        check(not missing and not k5_off and sum(k5.values()) > 0,
              f"train_trace rows: convs {missing[:3]}, K5 off [bwd] {k5_off[:3]}")
        check(cm_b == k3 and cm_f == 2 * k2_fwd and k3 > 0,
              f"train_trace conv-mode kernels [fwd] {cm_f} [bwd] {cm_b}, K3 launches {k3}")
        out[f"train_trace_bn{bn}"] = {"rollup_us": roll, "kernel_us": ktot, "other": oth}

    # -- net_ab, net_tune and its wisdom read back --------------------------------------
    rc, lines = cli("net_ab", ["net_ab", *net, f"--a={gen_cfg}", f"--b={lib_cfg}"])
    print(f"[tools] net_ab gen (A) vs lib (B) rc={rc}: {lines[-1] if lines else ''} ({card})")
    check(rc == 0, "net_ab")
    out["net_ab"] = lines[-1]
    # the stem's group across programs (replays), at a margin under its
    # library conv's gain (7.9% of the forward on an H100 80GB HBM3, 700 W)
    louts = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib")
    louts.init(pipe)
    ref = louts.run_fwd(ins, ["fc1000"])["fc1000"].data
    del louts
    from boda_tpu_torch.prof.wisdom import read_wisdom
    readback = 0
    for name, extra in (("net_tune", ["--max-groups=1"]),
                        ("net_tune_stem", ["--ab=0", "--op-filter=conv1", "--max-groups=1",
                                           "--n-iters=20", "--margin=0.04"])):
        wis = os.path.join(tdir, f"{name}.wis")
        rc, lines = cli(name, ["net_tune", *net, *extra, f"--wisdom-out-fn={name}.wis"])
        print(f"[tools] net_tune {' '.join(extra)} rc={rc}: " + " | ".join(lines) + f" ({card})")
        check(rc == 0, f"net_tune {extra}")
        sigs = {w.op.key() for w in read_wisdom(wis)}
        weng = make("conv_fwd", "cuda", compute_tn="bfloat16", wisdom_fn=wis)
        weng.init(pipe)
        tuned = {op for op in convfc if weng.wisdom_sig(op).key() in sigs}
        _, e_w = rel_err(torch.from_numpy(weng.run_fwd(ins, ["fc1000"])["fc1000"].data),
                         torch.from_numpy(ref))
        del weng
        rc, lines = run_cli(["run_cnet", *net, "--n-iters=10",
                             f"--conv-fwd=(mode=cuda,compute_tn=bfloat16,wisdom_fn={wis})"])
        got = {ln.split(":")[0] for ln in lines if ": wisdom tune " in ln and " on net:" in ln}
        print(f"[tools] run_cnet --wisdom-fn={name}.wis rc={rc}: a net: wisdom tune on "
              f"{sorted(got)} (the tuned groups' ops {sorted(tuned)}); fc1000 vs lib "
              f"{e_w:.3e} (tol {SLICE_TOL['fc1000']}); "
              f"{next((ln for ln in lines if ln.startswith('{')), '')}")
        check(rc == 0 and got == tuned and e_w <= SLICE_TOL["fc1000"],
              f"{name}.wis read back: {sorted(got ^ tuned)[:3]}, fc1000 {e_w:.3g}")
        readback += bool(tuned)
    print(f"[tools] net_tune wisdom with a tuned group read back from {readback} of 2 runs")
    out["net_tune_readback"] = readback

    # -- cnn_prof, cnn_op_info, net_decomp ------------------------------------------
    for name, argv in (("cnn_prof", ["cnn_prof", *net, "--time=1", "--json-out=1"]),
                       ("cnn_op_info", ["cnn_op_info",
                                        "--ops-fn=testdata/ops/resnet50-ops-img8.txt",
                                        "--time=1", "--tune-comp=(use_xla=1)",
                                        "--json-out=1"])):
        rc, lines = cli(name, argv)
        recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
        untimed = [r for r in recs if "us" not in r]
        over = [r for r in recs if r.get("pct_peak", 0) > 100]
        pk = [r.get("pct_peak", 0) for r in recs]
        comp = [r["speedup_vs_comp"] for r in recs if r.get("speedup_vs_comp")]
        print(f"[tools] {name} --time=1 rc={rc}: {len(recs)} rows, {len(untimed)} untimed, "
              f"%-peak {min(pk, default=0):.2f}-{max(pk, default=0):.2f}, {len(over)} over 100"
              + (f"; gen vs lib speedup {min(comp):.2f}-{max(comp):.2f}x" if comp else "")
              + f"; {lines[-1] if lines else ''} ({card})")
        check(rc == 0 and recs and not untimed and not over, f"{name} --time=1")
        out[name] = {"rows": len(recs), "pct_peak_max": max(pk, default=0)}
    rc, lines = cli("net_decomp", ["net_decomp", *net, "--n-iters=10", "--repeats=2"])
    for ln in lines:
        print(f"[tools] {ln}")
    check(rc == 0 and any("stage ->" in ln for ln in lines), "net_decomp")
    out["net_decomp"] = lines

    # -- the ipc backend: cs_test_master, sgemm over fds: and tcp: ----------------------
    rc, lines = cli("cs_test_master", ["cs_test_master", "--worker-be=(be=cuda)"])
    print(f"[tools] cs_test_master --worker-be=(be=cuda) rc={rc}: {lines[-1] if lines else ''}")
    check(rc == 0 and lines and "PASS" in lines[-1] and "ipc:cuda:" in lines[-1],
          "cs_test_master")
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((1024, 2048), dtype=np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((2048, 512), dtype=np.float32) *
                         np.float32(2048 ** -0.5)).bfloat16()
    a, b = a.float().numpy(), b.float().numpy()
    want = ipc_sgemm(make("be", "cuda"), a, b)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = subprocess.Popen([sys.executable, "-m", "boda_tpu_torch", "ipc_compute_worker",
                               f"--addr=tcp:127.0.0.1:{port}", "--listen=1"], cwd=root)
    try:
        res = {}
        for how in ("fds", "tcp"):
            be = None
            deadline = time.time() + 120
            while be is None:
                try:
                    be = make("be", "ipc", worker_be=parse_lexp("(be=cuda)"),
                              addr="" if how == "fds" else f"tcp:127.0.0.1:{port}")
                except OSError:
                    check(time.time() < deadline, "no tcp worker")
                    time.sleep(0.5)
            try:
                res[how] = (be.get_plat_tag(), ipc_sgemm(be, a, b))
            finally:
                be.shutdown()
    finally:
        worker.wait(timeout=60)
    for how, (tag, got) in res.items():
        same = bool(np.array_equal(got, want))
        print(f"[tools] sgemm 1024x2048x512 bf16 through an ipc worker over {how}: ({tag}) "
              f"bit-equal to be=cuda in process: {same}")
        check(same and tag.startswith("ipc:cuda:"), f"ipc sgemm over {how}")
    counts = read_counts(counted)
    out["launches"] = counts
    check(counts["sgemm"] > 0 and counts["conv"] > 0 and counts["atb"] > 0,
          f"tools launches {counts}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[tools] launches in this process {counts}; phase took {out['seconds']:.1f} s "
          f"({card})")
    return out


# [serve]: the serving path (modes/serve_bench.py: preprocess+net captured in
# one CUDA graph, pinned uploads on a copy stream), zmq_det, cnet_predict
SERVE_BATCHES = 50          # batches per full-width serving measurement
SERVE_DEPTH = 2             # serve_bench's default pipeline_depth
SERVE_P_TOL = 1e-4          # cnet_predict f32 p, card against the CPU
# the random-weight net's softmax is one-hot on the fixtures (p = 1.0, then
# zeros: any class order and any forward with the right argmax pass a p
# gate), so cnet_predict's p is compared with fc1000 scaled to put the
# larger of the two fixtures' top p here
SERVE_P_TARGET = 0.3
SERVE_SUM_TOL = 2e-2        # softmax row sums in bf16 (serve_bench.py's prob_ok)
ZMQ_REQUESTS = 8


def run_cli_err(argv) -> tuple[int, list[str], str]:
    """One CLI command in process: (exit code, stdout lines, stderr)."""
    from boda_tpu_torch import cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue().splitlines(), err.getvalue()


def pil_batches(paths, batch: int, y: int, x: int) -> list:
    """uint8 RGBA batches decoded and resized by PIL (utils/img_io.Img): one
    batch per fixture, each image of it the fixture."""
    from boda_tpu_torch.utils.img_io import Img
    return [np.ascontiguousarray(np.broadcast_to(Img.load(p).resize(y, x).data,
                                                 (batch, y, x, 4))) for p in paths]


class PoolLoader:
    """Stands in for utils/native.BatchLoader: ``next(out=)`` writes batch i,
    ``pool[i % len(pool)]``, into ``out`` (a pinned buffer's numpy view), for
    ``n`` batches."""

    def __init__(self, pool, n):
        self.pool, self.n, self.i = pool, n, 0

    def next(self, out):
        if self.i == self.n:
            return None
        out[...] = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self.i - 1, out


@contextlib.contextmanager
def fc1000_scaled(k: float):
    """The app modes' nets (modes/apps.py's load_net) with fc1000's weights
    times ``k`` (``scale_fc1000``), in this process."""
    from boda_tpu_torch.modes import apps
    load = apps.load_net

    def scaled(*a, **kw):
        pipe, in_dims = load(*a, **kw)
        scale_fc1000([pipe], k)
        return pipe, in_dims
    apps.load_net = scaled
    try:
        yield
    finally:
        apps.load_net = load


def predict_tops(img_fns: str, engine: str, *extra) -> list:
    """cnet_predict --model=resnet50 through the CLI: per image, its class ->
    value map over all 1000 classes and the classes in rank order."""
    rc, lines = run_cli(["cnet_predict", "--model=resnet50", img_fns, "--top-n=1000",
                         f"--conv-fwd={engine}", *extra])
    check(rc == 0 and lines, f"cnet_predict {engine} {extra} rc={rc}")
    tops = [json.loads(ln)["top"] for ln in lines]
    return [({t["cls"]: t["p"] for t in top}, [t["cls"] for t in top]) for top in tops]


def logit_err(got: dict, ref: dict) -> float:
    """max|err|/max|ref| of two class -> logit maps over the same classes."""
    check(set(got) == set(ref) and len(ref) == 1000, "logits over 1000 classes")
    a = np.array([got[c] for c in sorted(ref)])
    b = np.array([ref[c] for c in sorted(ref)])
    check(bool(np.isfinite(a).all()) and float(np.ptp(b)) > 0, "logits finite, not flat")
    return float(np.abs(a - b).max() / np.abs(b).max())


def zmq_roundtrip(root: str, img: str, engine: str) -> dict:
    """zmq_det_server --model=resnet50 serving fc1000's 1000 logits (a
    softmax of the random-weight net is one-hot) in a process of its own: 8
    requests through zmq_det_client (the CLI, in process), then 8 timed ones
    through its Client; each reply equal to cnet_predict's logits for the
    image on the same engine and held to the CPU's within F32_NODE_TOL of
    max|ref|. The server is stopped whatever happens."""
    import socket

    from boda_tpu_torch.apps.zmq_det import Client
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ep = f"tcp://127.0.0.1:{port}"
    srv = subprocess.Popen([sys.executable, "-u", "-m", "boda_tpu_torch", "zmq_det_server",
                            "--model=resnet50", f"--endpoint={ep}", f"--conv-fwd={engine}",
                            "--out-node-name=fc1000", "--top-n=1000"],
                           cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    try:
        head = []  # the server binds once its engine is up, and says so
        while not (head and head[-1].startswith("zmq_det server listening")):
            ln = srv.stdout.readline()
            check(bool(ln), f"zmq_det_server ended before listening: {''.join(head)[-500:]}")
            head.append(ln)
        imgs = ",".join(f"i{k}={img}" for k in range(ZMQ_REQUESTS))
        rc, lines = run_cli(["zmq_det_client", f"--endpoint={ep}", f"--img-fns=({imgs})"])
        check(rc == 0 and len(lines) == ZMQ_REQUESTS, f"zmq_det_client rc={rc}: {lines}")
        replies = [json.loads(ln) for ln in lines]
        c = Client(ep)
        ms = []
        try:
            for _ in range(ZMQ_REQUESTS):
                t0 = time.perf_counter()
                replies.append(c.predict_file(img))
                ms.append((time.perf_counter() - t0) * 1e3)
            c.quit_server()
        finally:
            c.close()
        tail, _ = srv.communicate(timeout=120)
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
    check(srv.returncode == 0 and f"served {2 * ZMQ_REQUESTS} requests" in tail,
          f"zmq_det_server rc={srv.returncode}: {tail[-500:]}")
    fns = f"--img-fns=(a={img})"
    (want, order), = predict_tops(fns, engine, "--out-node-name=fc1000")
    (cpu, _), = predict_tops(fns, "(mode=cuda,device=cpu)", "--out-node-name=fc1000")
    worst = 0.0
    for r in replies:
        got = {t["cls"]: round(t["p"], 5) for t in r["top"]}
        check(got == want and [t["cls"] for t in r["top"]] == order,
              "zmq reply differs from cnet_predict's fc1000 on the same engine")
        worst = max(worst, logit_err({t["cls"]: t["p"] for t in r["top"]}, cpu))
    check(worst <= F32_NODE_TOL, f"zmq logits vs the CPU {worst:.3e} (tol {F32_NODE_TOL})")
    return {"requests": len(replies), "median_ms": float(np.median(ms)),
            "ms": [round(m, 3) for m in ms], "top5": [(c, want[c]) for c in order[:5]],
            "logit_err_vs_cpu": worst}


def serve_phase(card: str, pipe, in_dims, out_dir, counted: dict) -> dict:
    """[serve]: what the machine has (the native library, pyzmq, PIL); the
    preprocess on the card bit-equal to the host's; the served ResNet-50 b32
    bf16 gen forward (preprocess+net in one CUDA graph) bit-equal to the
    engine's replay of the host-preprocessed batch, with K1 and K2 launched
    as often as in [graph]'s gen forward; the pipeline's pinned host
    buffers, its copy stream, its last batch against a serial run, and every
    batch a stand-in loader writes into the pinned buffers against the
    engine's replay of it; serve_bench and serve_stages at full width
    through the CLI (or, where the native library does not build, their
    error, and the same served function driven on PIL-decoded batches);
    their goldens; zmq_det's logits against cnet_predict and the CPU; and
    cnet_predict f32 on the card against the CPU, p off one-hot."""
    import os

    from boda_tpu_torch.apps.preproc import img_to_batch_np, img_to_batch_torch
    from boda_tpu_torch.config import make
    from boda_tpu_torch.modes.serve_bench import (ServedNet, Uploader, cached_batches,
                                                  loader_batches, pinned_cache, serve_batches,
                                                  stage_rates, stage_report)
    from boda_tpu_torch.utils import native
    from boda_tpu_torch.utils.dims import NDA
    from boda_tpu_torch.utils.features import is_feature_enabled
    root = os.path.dirname(os.path.abspath(__file__))
    imgs = [os.path.join(root, "testdata", "images", f) for f in ("test2.jpg", "test1.png")]
    sdir = out_dir / "serve"
    sdir.mkdir(parents=True, exist_ok=True)
    out = {"card": card}

    # -- 1. the machine --------------------------------------------------------------
    have_native = native.native_available()
    have_zmq, have_pil = is_feature_enabled("zmq"), is_feature_enabled("PIL")
    why = native.why_unavailable()
    print(f"[serve] machine: native library {'built' if have_native else 'NOT built: ' + why}; "
          f"pyzmq {'present' if have_zmq else 'absent'}; PIL "
          f"{'present' if have_pil else 'absent'} ({card})")
    out.update(native=have_native, native_error=why, pyzmq=have_zmq, pil=have_pil)
    check(have_pil, "PIL is needed for the fixtures' decode")

    # -- 2. the preprocess, card against host ------------------------------------------
    rng = np.random.default_rng(19)
    d = in_dims["data"]
    shape = (BATCH, d["y"], d["x"], 4)
    u8 = [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(4)]
    ref = img_to_batch_np(u8[0])
    x_dev = torch.from_numpy(u8[0]).cuda()
    for layout in ("nchw", "nhwc"):
        got = img_to_batch_torch(x_dev, layout=layout).cpu().numpy()
        want = ref if layout == "nchw" else ref.transpose(0, 2, 3, 1)
        check(np.array_equal(got, want), f"img_to_batch_torch f32 {layout}")
    got = img_to_batch_torch(x_dev, out_dtype=torch.bfloat16, layout="nhwc").cpu()
    want = torch.from_numpy(np.ascontiguousarray(ref.transpose(0, 2, 3, 1))).bfloat16()
    check(torch.equal(got, want), "img_to_batch_torch bf16 nhwc")
    print(f"[serve] img_to_batch_torch on the card bit-equal to img_to_batch_np: "
          f"f32 nchw and nhwc, bf16 nhwc ({BATCH}x{d['y']}x{d['x']} seeded u8)")

    # -- 3. the served forward ------------------------------------------------------
    # fc1000 scaled again, from this u8 batch's logits (its pixels span ~100x
    # the gen-data pattern's range): prob not one-hot here either
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    fc_max = float(np.abs(eng.run_fwd({"data": NDA(d, img_to_batch_np(u8[0]))},
                                      ["fc1000"])["fc1000"].data).max())
    scale_fc1000([pipe], 1.0 / fc_max)
    eng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    eng.init(pipe)
    served = ServedNet(eng, "prob", BATCH, d["y"], d["x"])
    t0 = time.perf_counter()
    served.prepare()
    zero_counts(counted)
    served.capture()
    launches = read_counts(counted)
    cap_s = time.perf_counter() - t0
    print(f"[serve] served resnet50 b{BATCH} bf16 gen (preprocess+net, one CUDA graph): "
          f"launches per batch {launches}; warm-up + capture {cap_s:.2f} s")
    check(launches["sgemm"] == 37 and launches["conv"] == 17,
          f"served launches sgemm {launches['sgemm']} (37), conv {launches['conv']} (17)")
    check(all(v == 0 for k, v in launches.items() if k not in ("sgemm", "conv")),
          f"served gen forward launched other kernels: {launches}")
    out["launches"] = launches
    cache = pinned_cache(u8, torch.device("cuda"))
    up = Uploader(shape, torch.device("cuda"), SERVE_DEPTH + 1)
    dev_u8, ev = up.upload(0, cache[0])
    s_out = served.run(dev_u8, ev).float().cpu().numpy()
    up.release(0)
    e_out = eng.run_fwd({"data": NDA(d, img_to_batch_np(u8[0]))}, ["prob"])["prob"].data
    check(s_out.shape == e_out.shape == (BATCH, 1000) and bool(np.isfinite(s_out).all()),
          f"served prob {s_out.shape}")
    bit = np.array_equal(s_out, e_out)
    _, err = rel_err(torch.from_numpy(s_out), torch.from_numpy(e_out))
    sums = s_out.sum(axis=1)
    print(f"[serve] served prob vs the engine's replay of img_to_batch_np: "
          f"{'bit-equal' if bit else f'max|err|/max|ref| {err:.3e}'}; row sums "
          f"{sums.min():.5f}..{sums.max():.5f}; max|prob| {s_out.max():.4g}")
    check(bit, f"served forward not bit-equal to the engine's replay ({err:.3e})")
    check(s_out.max() < 0.5, "served prob is saturated: its gates would check nothing")
    check(bool((np.abs(sums - 1.0) < SERVE_SUM_TOL).all()), f"row sums {sums.min()}..{sums.max()}")

    # -- 4. the pipeline ------------------------------------------------------------
    check(all(h.is_pinned() for h in up.host) and all(c.is_pinned() for c in cache),
          "serving host buffers are not pinned")
    check(up.stream.cuda_stream != torch.cuda.current_stream().cuda_stream,
          "uploads run on the replay's stream")
    n_ovl = 10
    _, last = serve_batches(served, up, cached_batches(cache, n_ovl), SERVE_DEPTH)
    last = last.float().cpu().numpy()
    serial = eng.run_fwd({"data": NDA(d, img_to_batch_np(u8[(n_ovl - 1) % len(u8)]))},
                         ["prob"])["prob"].data
    check(np.array_equal(last, serial), "overlapped run's last batch differs from a serial run")
    print(f"[serve] pipeline: {len(up.host)} pinned host buffers and {len(cache)} pinned cache "
          f"batches, uploads on stream {up.stream.cuda_stream:#x} (replays on "
          f"{torch.cuda.current_stream().cuda_stream:#x}); the last of {n_ovl} overlapped "
          f"batches (depth {SERVE_DEPTH}) bit-equal to a serial run")
    # a loader writing each batch into the pinned buffers, more batches than
    # buffers: a buffer refilled before its upload ran would serve another
    # batch (with 1 buffer and 3 in flight an upload waits for the replay
    # before it, which widens that window)
    want = [eng.run_fwd({"data": NDA(d, img_to_batch_np(b))}, ["prob"])["prob"].data
            for b in u8]
    n_load = 12
    for n_bufs, depth in ((SERVE_DEPTH + 1, SERVE_DEPTH), (1, SERVE_DEPTH + 1)):
        lup = Uploader(shape, torch.device("cuda"), n_bufs)
        outs = []
        n_done, _ = serve_batches(served, lup, loader_batches(PoolLoader(u8, n_load), lup),
                                  depth, outs=outs)
        check(n_done == len(outs) == n_load, f"loader run served {n_done} of {n_load}")
        bad = [i for i, o in enumerate(outs)
               if not np.array_equal(o.float().cpu().numpy(), want[i % len(u8)])]
        check(not bad, f"loader run ({n_bufs} buffers, depth {depth}): batches {bad} "
                       "differ from the engine's replay of what the loader wrote")
        print(f"[serve] loader_batches: {n_load} batches written by a stand-in loader into "
              f"{n_bufs} pinned buffers, depth {depth}: each bit-equal to the engine's "
              f"replay of its batch")
        del lup, outs

    # -- 5. full width: the modes through the CLI, or the served function ---------------
    argv = ["--model=resnet50", f"--img={BATCH}", f"--n-batches={SERVE_BATCHES}",
            f"--img-fns=(a={imgs[0]})", "--report-perf=1", f"--boda-output-dir={sdir}"]
    if have_native:
        reps = {}
        for name, extra in (("serve_bench", []), ("serve_bench_cached", ["--cache-batches=4"]),
                            ("serve_stages", [])):
            rc, lines, err_txt = run_cli_err([name.replace("_cached", "")] + argv + extra)
            check(rc == 0 and lines, f"{name} rc={rc}: {err_txt[-300:]}")
            reps[name] = json.loads(lines[-1])
            print(f"[serve] {name}: {lines[-1]} ({card})")
        out["rates"] = reps
        rc, lines, _ = run_cli_err(["test_cmds", "--filt=^serve_", f"--boda-output-dir={sdir}"])
        print(f"[serve] goldens: {lines[-1] if lines else ''}")
        check(rc == 0 and lines and lines[-1].startswith("test_cmds: 2/2 passed"),
              f"serve goldens: {lines}")
    else:
        for name in ("serve_bench", "serve_stages"):
            rc, _, err_txt = run_cli_err([name] + argv)
            want = f"error: {name} needs the native library (make -C native failed?)"
            check(rc == 1 and err_txt.strip() == want, f"{name} without the native "
                  f"library: rc={rc} {err_txt.strip()!r}")
        print("[serve] serve_bench and serve_stages raise boda_tpu's error without the "
              "native library: the decode stage was not measured; "
              "the same served function runs below on PIL-decoded batches")
        pcache = pinned_cache(pil_batches(imgs, BATCH, d["y"], d["x"]), torch.device("cuda"))
        t0 = time.perf_counter()
        n_done, _ = serve_batches(served, up, cached_batches(pcache, SERVE_BATCHES),
                                  SERVE_DEPTH)
        secs = time.perf_counter() - t0
        bench = {"mode": "serve_bench", "net": pipe.name, "batches": n_done, "img": BATCH,
                 "cached": True, "img_per_sec": round(n_done * BATCH / secs, 1),
                 "secs": round(secs, 3), "decode": "not measured (PIL-decoded cache)"}
        st = stage_rates(served, up, pcache, SERVE_BATCHES, SERVE_DEPTH)
        stages = {"mode": "serve_stages", "net": pipe.name, "img": BATCH,
                  "batches": SERVE_BATCHES,
                  **stage_report(st, BATCH, SERVE_BATCHES, int(np.prod(shape)), None),
                  "decode_img_s": "not measured (no native library)"}
        for rep in (bench, stages):
            print(f"[serve] {json.dumps(rep)} ({card})")
        out["rates"] = {"serve_bench_cached": bench, "serve_stages": stages}
        print("[serve] goldens serve_bench_mini, serve_stages_mini: not run (no native "
              "library; [corpus] skips them naming it)")
    st = out["rates"]["serve_stages"]
    out["dispatch_ms"] = BATCH / st["dispatch_img_s"] * 1e3
    print(f"[serve] dispatch {st['dispatch_img_s']} img/s = {out['dispatch_ms']:.3f} ms per "
          f"b{BATCH} batch; overlapped {st['overlapped_img_s']}, h2d {st['h2d_img_s']} "
          f"({st['h2d_GB_s']} GB/s), overlap quality {st['overlap_quality']} ({card})")
    del served, up, cache, eng

    out.update(predict_gates(card, root, imgs, have_zmq))
    return out


def predict_gates(card: str, root: str, imgs: list, have_zmq: bool) -> dict:
    """[serve]'s f32 app gates: zmq_det (7) and cnet_predict (8)."""
    import os

    from boda_tpu_torch.apps.preproc import img_to_batch_np
    from boda_tpu_torch.config import make
    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.utils.dims import NDA
    out = {}
    # -- 7. zmq_det --------------------------------------------------------------------
    f32 = "(mode=cuda)"
    if have_zmq:
        z = zmq_roundtrip(root, imgs[0], f32)
        # the server's forward alone: the same engine's b1 replay
        p1, d1 = load_net("resnet50", img=1)
        e1 = make("conv_fwd", "cuda")
        e1.init(p1)
        z["replay_ms"] = e1.time_fwd({"data": NDA(d1["data"], img_to_batch_np(
            pil_batches(imgs[:1], 1, d1["data"]["y"], d1["data"]["x"])[0]))}, ["prob"]) * 1e3
        del e1
        out["zmq"] = z
        print(f"[serve] zmq_det_server --model=resnet50 (f32 b1, fc1000): {z['requests']} "
              f"replies of 1000 logits equal to cnet_predict's on the card (top {z['top5'][:2]}"
              f"...), vs the CPU max|err|/max|ref| {z['logit_err_vs_cpu']:.3e} (tol "
              f"{F32_NODE_TOL}); median {z['median_ms']:.3f} ms per request, of which the "
              f"b1 f32 replay {z['replay_ms']:.3f} ms ({card})")
    else:
        out["zmq"] = None
        print("[serve] zmq_det: not run, pyzmq is not installed")

    # -- 8. cnet_predict, f32 on the card against the CPU --------------------------------
    # the logits first: the random-weight net's softmax is one-hot on the
    # fixtures at any input --scale (its bias-driven floor alone saturates
    # it), so p is compared with fc1000's weights times k, k chosen on the
    # host from the card's logits (fc1000's biases are 0: the logits become
    # k times these, and the top p grows with k)
    fns = f"--img-fns=(a={imgs[1]},b={imgs[0]})"
    cpu = "(mode=cuda,device=cpu)"
    lg = {w: predict_tops(fns, e, "--out-node-name=fc1000") for w, e in (("card", f32),
                                                                         ("cpu", cpu))}
    lerr = max(logit_err(a, b) for (a, _), (b, _) in zip(lg["card"], lg["cpu"]))
    check(lerr <= F32_NODE_TOL, f"cnet_predict fc1000 card vs cpu {lerr:.3e}")
    print(f"[serve] cnet_predict resnet50 f32 fc1000 on the two fixtures: card vs CPU "
          f"max|err|/max|ref| {lerr:.3e} over 1000 logits (tol {F32_NODE_TOL}) ({card})")
    logits = np.array([[m[c] for c in range(1000)] for m, _ in lg["card"]], np.float64)

    def top_p(k):
        z = k * (logits - logits.max(axis=1, keepdims=True))
        return float((1.0 / np.exp(z).sum(axis=1)).max())
    lo, hi = 0.0, 1.0
    for _ in range(60):
        k = (lo + hi) / 2
        lo, hi = (k, hi) if top_p(k) < SERVE_P_TARGET else (lo, k)
    k = (lo + hi) / 2
    with fc1000_scaled(k):
        tops = {w: predict_tops(fns, e) for w, e in (("card", f32), ("cpu", cpu))}
    worst = 0.0
    for (pa, ra), (pb, rb) in zip(tops["card"], tops["cpu"]):
        check(max(pa.values()) < 0.5 and max(pb.values()) < 0.5,
              "cnet_predict's p is saturated: its gate would check nothing")
        check(set(pa) == set(pb) and len(pa) == 1000, "cnet_predict p over 1000 classes")
        worst = max(worst, max(abs(pa[c] - pb[c]) for c in pa))
        for r, (ca, cb) in enumerate(zip(ra, rb)):
            gap = min(abs(pa[ca] - pa[ra[j]]) for j in (r - 1, r + 1) if 0 <= j < len(ra))
            check(ca == cb or gap <= SERVE_P_TOL, f"cnet_predict rank {r}: card {ca} cpu {cb}")
    check(worst <= SERVE_P_TOL, f"cnet_predict p card vs cpu {worst:.3g}")
    top5 = [[(c, pa[c]) for c in ra[:5]] for pa, ra in tops["card"]]
    print(f"[serve] cnet_predict resnet50 f32 on the two fixtures, fc1000 times {k:.4g}: card "
          f"vs CPU max |dp| over 1000 classes {worst:.3g} (tol {SERVE_P_TOL}), the same ranks "
          f"where neighbours differ by more; card top-5 {top5} ({card})")
    out.update(cnet_predict_max_dp=worst, cnet_predict_fc1000_times=k,
               cnet_predict_top5=top5, cnet_predict_logit_err=lerr)
    return out


def corpus_phase(card: str, out_dir) -> dict:
    """[corpus]: the port's test_all with its slow suites (test_cmds on
    testdata/test_cmds.xml, then every test_compute suite of
    testdata/test_all.xml: the forward ones, the gradient matrix and the
    xla/pallas suite) in process on the card; every entry outside the skip
    tables must pass, run_cnet_int8 among them.
    Outputs under build/chip_smoke/corpus/."""
    import os
    import xml.etree.ElementTree as ET

    from boda_tpu_torch.modes.test_cmds import NOT_RUN_SUITES, PIL_ENTRIES
    from boda_tpu_torch.utils.features import is_feature_enabled
    print(f"[corpus] machine: PIL {'present' if is_feature_enabled('PIL') else 'absent'} "
          f"(without it {', '.join(PIL_ENTRIES)} skip)")
    cdir = out_dir / "corpus"
    rc, lines, err_txt = run_cli_err(["test_all", "--run-slow=1", f"--boda-output-dir={cdir}"])
    (cdir / "test_all.txt").write_text("\n".join(lines) + "\n" + err_txt)
    skips = [ln for ln in lines if ln.startswith("SKIP ")]
    fails = [i for i, ln in enumerate(lines) if ln.startswith("FAIL ") or ln.startswith("error:")]
    summary = [ln for ln in lines if ln.startswith("test_cmds:") or ln.startswith("test_all:")]
    # each suite that ran, with its mode's summary line (test_compute's nodes
    # and verdict); every suite of testdata/test_all.xml outside the skip
    # table must run
    suites = [ln[4:] for ln in lines if ln.startswith("=== ")]
    for ln in skips:
        print(f"[corpus] {ln[:400]}")
    for cli_str in suites:
        i = lines.index(f"=== {cli_str}")
        end = next((j for j in range(i + 1, len(lines)) if lines[j].startswith("=== ")),
                   len(lines))
        last = [ln for ln in lines[i + 1:end] if ln.startswith(cli_str.split()[0])]
        print(f"[corpus] {cli_str} -> {last[-1][:300] if last else ''}")
    xml_fn = os.path.join(os.path.dirname(os.path.abspath(__file__)), "testdata", "test_all.xml")
    listed = [li.get("cli_str") for li in ET.parse(xml_fn).getroot().iter("li")]
    want = [c for c in listed if c not in NOT_RUN_SUITES]
    for i in fails:  # each failure with its diff
        for ln in lines[i:i + 24]:
            print(f"[corpus] {ln[:400]}")
    for ln in summary:
        print(f"[corpus] {ln}")
    check(rc == 0 and not fails and summary and summary[-1] == "test_all: PASS",
          f"test_all rc={rc}: {len(fails)} failures")
    check(suites == want, f"test_all ran {len(suites)} suites, testdata/test_all.xml lists "
                          f"{len(want)} outside the skip table")
    # boda_tpu's engines: run_cnet_int8 (pallas) and the xla/pallas suite run
    check(not any(ln.startswith("SKIP run_cnet_int8") for ln in skips)
          and any("(oracle=(mode=xla)" in c for c in suites),
          "[corpus] run_cnet_int8 or test_all's xla/pallas suite did not run")
    return {"summary": summary, "skipped": len(skips), "suites_run": len(suites), "card": card}

def mesh_devices(n: int) -> list:
    """n mesh devices: the first n cards, or, with fewer cards, the cards in
    turn (on a one-card machine cuda:0 n times)."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def mesh_phase(card: str, fc_scale: float, out_dir, counted: dict) -> dict:
    """[mesh]: the engine's ``mesh`` on a 2-device mesh (mesh_devices; on a
    one-card machine cuda:0 twice) at ResNet-50 b32 224x224 bf16, fc1000
    scaled as in [graph]: gen and fused ``(dp=2)`` replayed, each half of
    the output bit-equal to the no-mesh engine's replay at b16 on its 16
    images (the same shapes, so the same plans) with twice b16's launches;
    lib ``(dp=2,tp=2)`` against the no-mesh lib forward within SLICE_TOL;
    gen ``(tp=2)`` raising "dp only"; ms per dp=2 forward beside the no-mesh
    b32; then ``gen_src_dir`` on the card: the plan, the captured graph and
    the kernels' PTX of the gen forward."""
    import os

    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph.pipe import PipeError
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.parallel.mesh import make_mesh
    from boda_tpu_torch.utils.dims import NDA
    from boda_tpu_torch.utils.lexp import parse_lexp
    devs = mesh_devices(2)
    one_card = devs[0] == devs[1]
    print(f"[mesh] the 2-device mesh: {', '.join(map(str, devs))}"
          + (" (one card: its shards share cuda:0)" if one_card else ""))
    pipe, in_dims = load_net("resnet50", img=BATCH)
    half, hdims = load_net("resnet50", img=BATCH // 2)
    scale_fc1000([pipe, half], fc_scale)
    ins = gen_data_inputs(in_dims)
    h = BATCH // 2
    halves = [{"data": NDA(hdims["data"], ins["data"].data[i * h:(i + 1) * h])}
              for i in range(2)]
    outs = ["prob", "fc1000"]
    res = {"devices": [str(d) for d in devs], "card": card}
    for tag, kw in (("gen", {}), ("fused", {"fuse_block": True,
                                            "tune": parse_lexp(FUSED_TUNE)})):
        ref = make("conv_fwd", "cuda", compute_tn="bfloat16", **kw)
        ref.init(half)
        ref.prepare(halves[0], outs)
        zero_counts(counted)
        want = [ref.run_fwd(halves[0], outs)]
        n_half = read_counts(counted)
        want.append(ref.run_fwd(halves[1], outs))  # a replay of the same graph
        e = make("conv_fwd", "cuda", compute_tn="bfloat16",
                 mesh=make_mesh({"dp": 2}, devices=devs), **kw)
        e.init(pipe)
        e.prepare(ins, outs)
        zero_counts(counted)
        got = e.run_fwd(ins, outs)
        n_mesh = read_counts(counted)
        bit = all(np.array_equal(got[n].data[i * h:(i + 1) * h], want[i][n].data)
                  for i in range(2) for n in outs)
        check(bit, f"mesh {tag} (dp=2): a half differs from the no-mesh b{h} replay")
        check(n_mesh == {k: 2 * v for k, v in n_half.items()},
              f"mesh {tag} (dp=2) launches {n_mesh}, b{h} {n_half}")
        b32 = make("conv_fwd", "cuda", compute_tn="bfloat16", **kw)
        b32.init(pipe)
        ms = e.time_fwd(ins, ["prob"], n_iters=20, warmup=3) * 1e3
        ms_b32 = b32.time_fwd(ins, ["prob"], n_iters=20, warmup=3) * 1e3
        res[tag] = {"launches": n_mesh, "launches_b16": n_half, "ms_dp2": ms,
                    "ms_b32": ms_b32}
        print(f"[mesh] resnet50 b{BATCH} bf16 {tag} (dp=2): each half bit-equal to the "
              f"no-mesh b{h} replay; launches {n_mesh} = 2 x b{h}'s; {ms:.3f} ms per dp=2 "
              f"forward, no mesh b{BATCH} {ms_b32:.3f} ms ({card})")
        del ref, e, b32
    lib = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib")
    lib.init(pipe)
    ref = lib.run_fwd(ins, outs)
    mt = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib",
              mesh=make_mesh({"dp": 2, "tp": 2}, devices=mesh_devices(4)))
    mt.init(pipe)
    zero_counts(counted)
    got = mt.run_fwd(ins, outs)
    n_lib = read_counts(counted)
    errs = {n: rel_err(torch.from_numpy(got[n].data), torch.from_numpy(ref[n].data))[1]
            for n in outs}
    split = len(mt._weights_dev["__tp__"].parts)
    check(all(errs[n] <= SLICE_TOL[n] for n in outs), f"mesh lib (dp=2,tp=2): {errs}")
    check(sum(n_lib.values()) == 0 and split > 0 and not mt._blocks,
          f"mesh lib (dp=2,tp=2): launches {n_lib}, {split} split weights")
    ms_tp = mt.time_fwd(ins, ["prob"], n_iters=20, warmup=3) * 1e3
    ms_lib = lib.time_fwd(ins, ["prob"], n_iters=20, warmup=3) * 1e3
    res["lib_dp2_tp2"] = {"max_rel_err": errs, "split_weights": split, "ms": ms_tp,
                          "ms_b32": ms_lib}
    print(f"[mesh] resnet50 b{BATCH} bf16 lib (dp=2,tp=2) on {', '.join(map(str, mesh_devices(4)))}"
          f": {split} weights split over out_chan, vs no-mesh lib max|err|/max|ref| "
          + ", ".join(f"{n} {errs[n]:.3e}" for n in outs)
          + f" (tol {SLICE_TOL['fc1000']}); no hand kernel; {ms_tp:.3f} ms per forward, "
          f"no mesh {ms_lib:.3f} ms ({card})")
    del lib, mt
    gtp = make("conv_fwd", "cuda", compute_tn="bfloat16",
               mesh=make_mesh({"tp": 2}, devices=devs))
    gtp.init(pipe)
    try:
        gtp.run_fwd(ins, outs)
        raised = ""
    except PipeError as e:
        raised = str(e)
    check("dp only" in raised, f"mesh gen (tp=2) did not raise 'dp only': {raised!r}")
    print(f"[mesh] gen (tp=2) raises: {raised}")
    # gen_src_dir on the card: the plan, the captured graph, the kernels' PTX
    gdir = out_dir / "gen_src"
    t0 = time.perf_counter()
    gs = make("conv_fwd", "cuda", compute_tn="bfloat16", gen_src_dir=str(gdir))
    gs.init(pipe)
    gs.run_fwd(ins, ["prob"])
    line = next((ln for ln in gs.get_info_log().splitlines() if ln.startswith("gen_src: ")), "")
    files = sorted(os.listdir(gdir))
    plan = next(f for f in files if f.endswith(".plan.txt"))
    text = (gdir / plan).read_text()
    check(any(f.endswith(".cuda_graph.dot") for f in files) and "sgemm.ptx" in files
          and "conv.ptx" in files and "kernel: K2 conv2d_halo route=wgmma" in text,
          f"gen_src on the card: {files}")
    res["gen_src"] = {"files": files, "secs": time.perf_counter() - t0}
    print(f"[mesh] gen_src_dir: {line} ({time.perf_counter() - t0:.1f} s; under "
          f"build/chip_smoke/gen_src/)")
    return res


def dist_phase(card: str, out_dir) -> dict:
    """[dist]: the dp training step across ranks on the card. The golden
    case, ``dist_test_master --num-procs=2 --devices-per-proc=2 --steps=3``
    through the CLI, its ranks bit-equal (the master compares their digests
    of the losses, weights and momenta) and its losses within 1e-4 relative
    of the same command's on the CPU; the flagship case (resnet50 224x224,
    1000 classes, remat=seg, global b8, 2 steps), its ranks bit-equal and
    its losses within 1e-3 relative of the single-process step on the global
    batch on the card; a one-rank NCCL group's step, eager and captured,
    bit-equal to the step with no group (mini_resnet b8, 3 steps, every
    weight and momentum, with cuDNN's deterministic algorithms), then the
    captured one-rank NCCL step at ResNet-50 b32 (``nccl_graph_checks``).
    The ranks share the machine's cards (modes/dist_modes.py: gloo where two
    share one, and the step eager, as each worker's step line says). Prints
    ms per step per rank and the backend."""
    import re

    import torch.distributed as dist

    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.modes.dist_modes import _free_port
    from boda_tpu_torch.parallel.train import find_logits_node, make_train_step
    res = {"card": card}

    def master(*extra):
        rc, lines, err = run_cli_err(["dist_test_master", "--num-procs=2",
                                      "--devices-per-proc=2", *extra])
        (out_dir / "dist").mkdir(parents=True, exist_ok=True)
        with open(out_dir / "dist" / "dist_test_master.txt", "a") as f:
            f.write(" ".join(extra) + "\n" + "\n".join(lines) + "\n" + err + "\n")
        check(rc == 0 and lines and lines[-1].endswith("all ranks agree OK"),
              f"dist_test_master {' '.join(extra)} rc={rc}: {lines[-3:]} {err[-800:]}")
        losses = [[float(v) for v in m.group(1).split(",")] for m in
                  (re.search(r"losses=([\d.,-]+)", ln) for ln in lines) if m]
        steps = [ln for ln in lines if "ms_per_step=" in ln]
        for ln in steps + [ln for ln in lines if " step: " in ln] + lines[-1:]:
            print(f"[dist] {' '.join(extra) or 'card'}: {ln}")
        return losses, steps, lines[-1]

    t0 = time.perf_counter()
    card_l, steps, last = master("--steps=3")
    cpu_l, _, cpu_last = master("--steps=3", "--device=cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card_l[0], cpu_l[0]))
    check(len(card_l) == 2 and card_l[0] == card_l[1], f"dist golden: ranks {card_l}")
    check(rel <= 1e-4, f"dist golden: card {card_l[0]} vs CPU {cpu_l[0]} rel {rel:.3g}")
    res["golden"] = {"losses": card_l[0], "cpu_losses": cpu_l[0], "max_rel": rel,
                     "ranks": steps, "line": last, "secs": time.perf_counter() - t0}
    print(f"[dist] golden 2x2: card {card_l[0]} vs CPU {cpu_l[0]}, max rel {rel:.3e} "
          f"(tol 1e-4); {last}")

    t0 = time.perf_counter()
    flag = ("--model=resnet50", "--in-sz=224", "--num-cls=1000")
    fl, fsteps, flast = master("--steps=2", *flag)
    check(fl[0] == fl[1], f"dist flagship: ranks {fl}")
    pipe, in_dims = build_model("resnet50", img=8, num_cls=1000, in_sz=224)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*in_dims["data"].shape).astype(np.float32)).cuda()
    y = torch.from_numpy(rng.randint(0, 1000, size=(8,)).astype(np.int32)).cuda()
    step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9,
                           bn_momentum=0.1, clip_norm=1.0, remat="seg")
    w = {k: torch.from_numpy(np.ascontiguousarray(v.data)).cuda()
         for k, v in pipe.weights.items()}
    mom, single, ms_single = None, [], []
    for _ in range(2):
        t1 = time.perf_counter()
        loss, w, mom = step(w, {"data": x}, y, mom)
        single.append(float(loss))
        ms_single.append((time.perf_counter() - t1) * 1e3)
    del w, mom
    frel = max(abs(a - b) / abs(b) for a, b in zip(fl[0], single))
    check(frel <= 1e-3, f"dist flagship: ranks {fl[0]} vs one process {single} rel {frel:.3g}")
    res["flagship"] = {"losses": fl[0], "single_process": single, "max_rel": frel,
                       "ranks": fsteps, "line": flast, "single_ms_per_step": ms_single,
                       "secs": time.perf_counter() - t0}
    print(f"[dist] flagship resnet50 224 b8 (2 ranks x b4, remat=seg): {fl[0]} vs one "
          f"process {single}, max rel {frel:.3e} (tol 1e-3); one process b8: ms per step "
          + ",".join(f"{v:.3f}" for v in ms_single) + f" ({card})")

    # a one-rank NCCL group: eager and captured, bit-equal to no group
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        pipe, in_dims = build_model("mini_resnet", img=8, num_cls=16, in_sz=16)
        rng = np.random.RandomState(0)
        x = torch.from_numpy(rng.randn(*in_dims["data"].shape).astype(np.float32)).cuda()
        y = torch.from_numpy(rng.randint(0, 16, size=(8,)).astype(np.int32)).cuda()
        w0 = {k: torch.from_numpy(np.ascontiguousarray(v.data)).cuda()
              for k, v in pipe.weights.items()}
        runs = {}
        for tag, group, cg in (("none", None, False), ("nccl", dist.group.WORLD, False),
                               ("nccl captured", dist.group.WORLD, True)):
            step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, momentum=0.9,
                                   bn_momentum=0.1, clip_norm=1.0, group=group, cuda_graph=cg)
            runs[tag] = train_step_states(step, w0, [(x, y, i) for i in range(3)])
            step.release()  # before the group's teardown, which waits for its graphs
            if cg:
                check(step.captured.captures == 1
                      and not any(ln.startswith("eager") for ln in step.info_log),
                      f"dist: the one-rank NCCL step was not captured once: {step.info_log[-2:]}")
        same = {tag: not any(d for a, b in zip(runs["none"], r)
                             for d in max_diffs(a, b).values()) for tag, r in runs.items()}
        res["nccl_one_rank_bit_equal"] = same
        print(f"[dist] a one-rank NCCL group: 3 steps of mini_resnet b8 bit-equal to no group "
              f"(loss, weights, momenta): eager {same['nccl']}, captured "
              f"{same['nccl captured']} ({card})")
        check(all(same.values()), f"dist: the one-rank NCCL steps against no group: {same}")
        del runs
        res["graph"] = nccl_graph_checks(card, dist.group.WORLD)
    finally:
        torch.backends.cudnn.deterministic = det
        dist.destroy_process_group()
    return res


def nccl_graph_checks(card: str, group) -> dict:
    """[dist]'s compiled step at full width: ResNet-50 b32 224x224 bf16 on a
    one-rank NCCL ``group`` (fc1000 unscaled, as train_bench), held by
    ``captured_step_checks`` (hand kernels per replay by ``train_calls``)."""
    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern
    from boda_tpu_torch.parallel.train import make_train_step
    pipe, dims = load_net("resnet50", img=BATCH)
    d = dims["data"]
    x = gen_data_pattern(d.shape, d.tn).to("cuda", torch.bfloat16)
    labels = (torch.arange(BATCH) % 1000).cuda()
    w0 = {k: torch.from_numpy(np.asarray(v.data, np.float32)).to("cuda", torch.bfloat16)
          for k, v in pipe.weights.items()}
    return captured_step_checks(
        "dist", f"resnet50 b{BATCH} bf16 gen, train-mode BN, a one-rank NCCL group", pipe,
        lambda cg: make_train_step(pipe, "fc1000", group=group, cuda_graph=cg, **TP_KW),
        w0, w0, x, labels, train_launches(train_calls(pipe)), counted_wrappers(), card, 28)


# -- the [tp-train] phase: tensor parallelism in the training step -------------------

TP_STEPS = 3
TP_F32_BATCH = 4
TP_F32_TOL = 1e-4  # boda_tpu's sharded-vs-local bound (tests/test_parallel.py:71-73)
# the step of [train] with momentum and train-mode BN
TP_KW = dict(lr=0.01, clip_norm=1.0, momentum=0.9, bn_momentum=0.1, kernel_policy="gen")


def tp_train_phase(card: str, pipe, fc_scale: float, counted: dict, cases: dict) -> dict:
    """[tp-train]: the training step on a (tp=2) mesh (mesh_devices; on a
    one-card machine cuda:0 twice). ResNet-50 b32 224x224 bf16 gen in
    [train]'s configuration with momentum 0.9 and train-mode BN (fc1000
    scaled as everywhere): TP_STEPS steps on the (tp=2) row and without a
    mesh from the same weights on a fixed batch, the loss falling and each
    step's within TRAIN_TOL of the no-mesh step's; each run's K1/K2/K3/K5
    launches and paths in its second step exact by ``train_calls`` (every
    conv and fc1000 per slice at out_chan / 2: fc1000's forward at N = 500
    on wgmma_edge, its dgrad at K = 500 on wgmma and its wgrad at N = 500 on
    wgmma_edge, both reading dY from rows padded to 504: none on mma.sync;
    the K1 launches on A's padded rows counted by matmul.padded_a);
    each distinct call of the tp step against its plain version
    (``train_call_checks``); ms per step of both. The compiled (tp=2) step
    (``captured_step_checks``): replays bit-equal to the eager (tp=2) steps on two
    batches, the hand kernels per replay exact, ms per step replayed and
    eager beside the no-mesh replay. Then ResNet-50 b4 f32, one
    step (tp=2) against no mesh, weights and momenta at TP_F32_TOL by
    tests/test_torch_train_step.py's ``_close`` rule; and a (tp=1)
    mini_resnet step bit-equal to no mesh."""
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.modes.cnet import load_net
    from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern
    from boda_tpu_torch.parallel.mesh import gather_weights, make_mesh, shard_weights
    from boda_tpu_torch.parallel.train import find_logits_node, make_train_step
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    devs = mesh_devices(2)
    mesh = make_mesh({"tp": 2}, devices=devs)
    out = {"card": card, "devices": [str(d) for d in devs]}
    print(f"[tp-train] the (tp=2) row: {', '.join(map(str, devs))}"
          + (" (one card: both slices on cuda:0)" if devs[0] == devs[1] else ""))
    kw = TP_KW

    def steps(p, w0, x, labels, m, n, counts=False):
        """n steps from w0 on the fixed batch: losses, ms per step, and the
        second step's launches and paths (the first builds the plans), and
        its K1 launches on A's padded rows (``matmul.padded_a``)."""
        step = make_train_step(p, "fc1000", mesh=m, **kw)
        w = w0 if m is None else shard_weights(w0, p, m)
        mom, losses, ms, seen = None, [], [], {}
        for i in range(n):
            if counts and i == 1:
                zero_counts(counted)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, w, mom = step(w, {"data": x}, labels, mom)
            losses.append(float(loss))
            ms.append((time.perf_counter() - t0) * 1e3)
            if counts and i == 1:
                seen = {"launches": read_counts(counted),
                        "paths": {k: {q: v for q, v in counted[k].paths.items() if v}
                                  for k in ("sgemm", "conv", "atb")},
                        "k1_padded_a": counted["sgemm"].padded_a}
        return losses, ms, seen, step, w, mom

    # -- ResNet-50 b32 bf16 gen: (tp=2) against no mesh ---------------------------------
    n_img = pipe.must_dims("data")["img"]
    d = pipe.must_dims("data")
    x = gen_data_pattern(d.shape, d.tn).to(dev, torch.bfloat16)
    labels = (torch.arange(n_img) % 1000).to(dev)
    w0 = {k: torch.from_numpy(np.asarray(w.data, np.float32)).to(dev, torch.bfloat16)
          for k, w in pipe.weights.items()}
    runs = {}
    for tag, m, tp in (("none", None, 1), ("tp2", mesh, 2)):
        calls = train_calls(pipe, tp)
        want_paths: dict = {}
        for (kname, what, sig), cnt in calls.items():
            wk = {"conv_nhwc": "conv"}.get(kname, kname)
            q = want_paths.setdefault(wk, {})
            q[call_path(kname, sig, what)] = q.get(call_path(kname, sig, what), 0) + cnt
        losses, ms, seen, step, _, _ = steps(pipe, w0, x, labels, m, TP_STEPS, counts=True)
        want = train_launches(calls)
        got = seen["launches"]
        ok = all(got[k] == v for k, v in want.items()) and \
            all(got[k] == 0 for k in got if k not in want)
        print(f"[tp-train] resnet50 b{n_img} bf16 gen {'(tp=2)' if m else 'no mesh'}: "
              f"losses {[f'{v:.6g}' for v in losses]}, ms per step "
              f"{[f'{v:.3f}' for v in ms]}; launches per step {got} (by train_calls "
              f"{want}); paths {seen['paths']} (by the core's rule {want_paths}) ({card})")
        if m is not None:
            print("[tp-train] " + next(ln for ln in step.info_log if ln.startswith("mesh ")))
        check(ok, f"tp-train {tag}: launches {got}, expected {want}")
        check(seen["paths"] == want_paths,
              f"tp-train {tag}: paths {seen['paths']}, expected {want_paths}")
        check(all(np.isfinite(losses)), f"tp-train {tag}: losses {losses}")
        padded = sum(cnt for (kname, what, sig), cnt in calls.items()
                     if kname == "sgemm" and what.startswith("fc ") and sig[1] % 8)
        print(f"[tp-train] {tag}: K1 launches on A's padded rows (matmul.padded_a) "
              f"{seen['k1_padded_a']} (by train_calls, the fc dgrads at K % 8 != 0: {padded})")
        check(seen["k1_padded_a"] == padded,
              f"tp-train {tag}: {seen['k1_padded_a']} K1 launches on padded rows, "
              f"expected {padded}")
        runs[tag] = {"losses": losses, "ms": ms, "launches": got, "paths": seen["paths"],
                     "k1_padded_a": seen["k1_padded_a"], "calls": calls}
        del step
    a, b = runs["tp2"]["losses"], runs["none"]["losses"]
    rel = [abs(u - v) / abs(v) for u, v in zip(a, b)]
    print(f"[tp-train] (tp=2) vs no mesh per step: loss rel {[f'{r:.3e}' for r in rel]} "
          f"(tol {TRAIN_TOL}); (tp=2) loss {a[0]:.6g} -> {a[-1]:.6g}; ms per step after "
          f"the first: (tp=2) {min(runs['tp2']['ms'][1:]):.3f}, no mesh "
          f"{min(runs['none']['ms'][1:]):.3f} ({card})")
    check(max(rel) <= TRAIN_TOL, f"tp-train: losses {a} vs no mesh {b}")
    check(a[-1] < a[0], f"tp-train: the (tp=2) loss did not fall: {a}")
    for tag in ("tp2", "none"):
        out[tag] = {k: v for k, v in runs[tag].items() if k != "calls"}
    out["loss_rel"] = rel

    # -- each distinct K1, K2, K3 and K5 call of the (tp=2) step vs plain -------------
    rows, per_step = train_call_checks("tp-train", f"the gen b{n_img} bf16 (tp=2) step",
                                       runs["tp2"]["calls"], counted, cases, card)
    out["calls"], out["kernel_us_per_step"] = rows, per_step
    want = train_launches(runs["tp2"]["calls"])
    del runs

    # -- the compiled (tp=2) step: captured on its one-card row, replayed -----------
    out["graph"] = captured_step_checks(
        "tp-train", f"resnet50 b{n_img} bf16 gen, train-mode BN, (tp=2)", pipe,
        lambda cg: make_train_step(pipe, "fc1000", mesh=mesh, cuda_graph=cg, **kw),
        shard_weights(w0, pipe, mesh), w0, x, labels, want, counted, card, 27)

    # -- ResNet-50 b4 f32: one step (tp=2) against no mesh ------------------------------
    fpipe, fdims = load_net("resnet50", img=TP_F32_BATCH)
    scale_fc1000([fpipe], fc_scale)
    d = fdims["data"]
    xf = gen_data_pattern(d.shape, d.tn).to(dev, torch.float32)
    lf = (torch.arange(TP_F32_BATCH) % 1000).to(dev)
    wf = {k: torch.from_numpy(np.asarray(w.data, np.float32)).to(dev)
          for k, w in fpipe.weights.items()}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res = {}
        for tag, m in (("none", None), ("tp2", mesh)):
            losses, _, _, _, w, mom = steps(fpipe, wf, xf, lf, m, 1)
            res[tag] = (losses[0], gather_weights(w), gather_weights(mom))
    finally:
        torch.backends.cudnn.deterministic = det
    (gl, gw, gm), (rl, rw, rm) = res["tp2"], res["none"]
    upd = max(float((rw[k] - wf[k]).abs().max()) for k in wf)
    werr = max(float((gw[k] - rw[k]).abs().max()) / max(float(rw[k].abs().max()), upd)
               for k in rw)
    mmax = max(float(v.abs().max()) for v in rm.values())
    merr = max(float((gm[k] - rm[k]).abs().max()) for k in rm) / mmax
    lrel = abs(gl - rl) / abs(rl)
    print(f"[tp-train] resnet50 b{TP_F32_BATCH} f32 one step (tp=2) vs no mesh: loss "
          f"{gl:.7g} / {rl:.7g} (rel {lrel:.3e}); weights worst {werr:.3e} of max(max|w|, "
          f"the largest update), momenta worst {merr:.3e} of the largest (tol {TP_F32_TOL}) "
          f"({card})")
    check(max(lrel, werr, merr) <= TP_F32_TOL, "tp-train: f32 (tp=2) vs no mesh")
    out["f32"] = {"loss_rel": lrel, "weights": werr, "momenta": merr}
    del res, wf, fpipe

    # -- mini_resnet: a (tp=1) mesh is the step without one, bit for bit ---------------
    mp, mdims = build_model("mini_resnet", img=8, num_cls=16, in_sz=16)
    rng = np.random.RandomState(0)
    xm = torch.from_numpy(rng.randn(*mdims["data"].shape).astype(np.float32)).to(dev)
    ym = torch.from_numpy(rng.randint(0, 16, size=(8,)).astype(np.int32)).to(dev)
    wm = {k: torch.from_numpy(np.ascontiguousarray(v.data)).to(dev)
          for k, v in mp.weights.items()}
    torch.backends.cudnn.deterministic = True
    try:
        one = {}
        for tag, m in (("none", None), ("tp1", make_mesh({"tp": 1}, devices=devs[:1]))):
            step = make_train_step(mp, find_logits_node(mp), mesh=m, **dict(kw, lr=0.05))
            w, mom, ls = wm, None, []
            for _ in range(3):
                loss, w, mom = step(w, {"data": xm}, ym, mom)
                ls.append(loss)
            one[tag] = (ls, w, mom)
    finally:
        torch.backends.cudnn.deterministic = det
    (la, wa, ma), (lb, wb, mb) = one["none"], one["tp1"]
    same = all(torch.equal(u, v) for u, v in zip(la, lb)) and \
        all(torch.equal(wa[k], wb[k]) for k in wa) and all(torch.equal(ma[k], mb[k]) for k in ma)
    print(f"[tp-train] mini_resnet b8 gen (tp=1): 3 steps bit-equal to no mesh: {same} "
          f"({card})")
    check(same, "tp-train: the (tp=1) step differs from the step without a mesh")
    out["tp1_bit_equal"] = same
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[tp-train] phase took {out['seconds']:.1f} s ({card})")
    return out

def captured_step_checks(phase: str, tag: str, pipe, make, ws: dict, w0: dict,
                         x: torch.Tensor, labels: torch.Tensor, want: dict, counted: dict,
                         card: str, seed: int) -> dict:
    """A mesh's or a group's compiled step, ``make(cuda_graph)``, at
    ResNet-50 in TP_KW's configuration (gen, train-mode BN), under cuDNN's
    deterministic algorithms: captured (no eager line in its info_log),
    ``graph_vs_eager`` from ``ws`` (the weights as the step takes them) on two
    batches, ``replay_profile`` (the hand kernels per wrapper of every
    profiled replay equal to ``want``); its ms per step replayed and eager
    beside the replay of the step with neither mesh nor group, from ``w0``."""
    from boda_tpu_torch.parallel.train import make_train_step
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        eager, graphed, res = graph_vs_eager(phase, tag, make, ws, second_batch(x, labels, seed),
                                             counted, card)
        check(not any(ln.startswith("eager") for ln in graphed.info_log),
              f"{phase} {tag}: not captured: {graphed.info_log[-2:]}")
        m0 = zero_state(graphed.captured.m)
        cw, cm = dict(graphed.captured.w), dict(graphed.captured.m)
        prof = replay_profile(phase, tag, lambda: eager(ws, {"data": x}, labels, m0),
                              lambda: graphed(cw, {"data": x}, labels, cm), graphed, want,
                              res["capture_counts"], card)
        graphed.release()  # before a group's teardown, which waits for its graphs
        del eager, graphed, cw, cm, m0
        torch.cuda.empty_cache()
        single = make_train_step(pipe, "fc1000", cuda_graph=True, **TP_KW)
        _, sw, sm = single(w0, {"data": x}, labels)
        single_ms = cuda_ms(lambda: single(sw, {"data": x}, labels, sm), TRAIN_GRAPH_REPS, 1)
    finally:
        torch.backends.cudnn.deterministic = det
    print(f"[{phase}] {tag}: ms per step replayed {prof['replay_ms']:.3f}, eager "
          f"{prof['eager_ms']:.3f}; the step without a mesh or group replayed {single_ms:.3f} "
          f"({card})")
    del single, sw, sm
    torch.cuda.empty_cache()
    return dict(res, **prof, single_replay_ms=single_ms)


# [xla]: boda_tpu's own engines. The NCHW route's hand-kernel launches per
# ResNet-50 forward (ops/cnn_variants.py): K1 the 36 1x1 convs (the four
# strided ones on their subsample) and fc1000, K3 the 16 3x3s (all stride
# 1; the conv kernel counted under conv and conv_nhwc); the 7x7 s2 stem is
# a strided k x k conv, so the logical rule's
XLA_LAUNCHES = {"sgemm": 37, "conv": 16, "conv_nhwc": 16}
XLA_CALL_TOL = 1e-2     # each distinct K1/K3 call of the NCHW route vs its plain version
XLA_F32_NODE_TOL = 1e-4  # resnet50 f32 b2, every node of xla vs cuda lib
XLA_GRAD_BATCH = 4
LIB_R50_PR13_MS = 2.888  # cuda lib's b32 bf16 replay, PERF.md (PR 13 run 1)


def xla_phase(card: str, pipe, ins: dict, fc_scale: float, counted: dict) -> dict:
    """[xla]: boda_tpu's engines on the card. ResNet-50 b32 224x224 bf16
    (fc1000 scaled as in every phase) under ``(mode=xla)``, the
    logical-layout rules on the library's ops, and ``(mode=pallas,
    layout=nchw,kernel_policy=gen)``, the NCHW route on K1/K3, beside the
    ``cuda`` engine's lib policy: each captured and replayed, fc1000 within
    SLICE_TOL of cuda lib's, replay bit-equal to eager on two batches
    (cuDNN held to its deterministic algorithms for that comparison), the
    route's launches exact (XLA_LAUNCHES; the stem on the logical rule),
    each distinct K1/K3 call of the route against its plain version on the
    route's own operands, ms per replay and per eager forward (with cuDNN's
    default algorithms). Then f32: resnet50 b2, every node of xla against
    cuda lib within 1e-4; resnet50 b4 with add_bck_ops, xla against cuda
    lib under test_compute's rule at 1e-3, the forward nodes of free runs
    and the gradient nodes of both backwards from lib's forward values (two
    free forwards put some ReLU inputs on opposite sides of 0). Last,
    googlenet_conv b32 bf16 (its classifier scaled as in [caffe]) and
    ssd300 b4 bf16 under xla against cuda lib, and ssd300's head of the xla
    engine on the card against the same rule on the CPU (SSD_HEAD_TOL)."""
    from boda_tpu_torch.config import make
    from boda_tpu_torch.graph import ssd_ops
    from boda_tpu_torch.graph.autodiff import add_bck_ops
    from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
    from boda_tpu_torch.ops import cnn_variants
    from boda_tpu_torch.ops.kernels.conv import conv2d_plain
    from boda_tpu_torch.ops.kernels.sgemm import matmul_plain
    out = {"card": card}
    engines = {"cuda lib": ("cuda", {"kernel_policy": "lib"}), "xla": ("xla", {}),
               "pallas nchw gen": ("pallas", {"layout": "nchw", "kernel_policy": "gen"})}

    def replays(tag, net, mode, kw, pins, outs, lib_res=None, logits=None):
        """One engine: captured, replay vs eager on two batches (bit-equal),
        launches of the captured forward, logits vs cuda lib's, ms per
        replay and eager forward."""
        deterministic = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            e = make("conv_fwd", mode, compute_tn="bfloat16", **kw)
            e.init(pipe_of[net])
            e.prepare(pins, outs)
            zero_counts(counted)
            replay = e.run_fwd(pins, outs)
            n = read_counts(counted)
            e.cuda_graph = False
            eager = e.run_fwd(pins, outs)
            e.cuda_graph = True
            eager2, replay2 = replay_follows(e, other_batch(pins, 29), outs)
        finally:
            torch.backends.cudnn.deterministic = deterministic
        n_bit = sum(np.array_equal(a[k].data, b[k].data) for a, b in
                    ((replay, eager), (replay2, eager2)) for k in outs)
        check(n_bit == 2 * len(outs), f"[xla] {net} {tag}: replay vs eager, {n_bit} of "
                                      f"{2 * len(outs)} outputs bit-equal")
        check(not np.array_equal(eager[outs[0]].data, eager2[outs[0]].data),
              f"[xla] {net} {tag}: the second batch left {outs[0]} as it was")
        e.drop_graph()
        e.cuda_graph = False
        eager_s = e.time_fwd(pins, outs, n_iters=10, warmup=2)
        e.cuda_graph = True
        secs = e.time_fwd(pins, outs, n_iters=20, warmup=3)
        row = {"launches": n, "replay_ms": secs * 1e3, "eager_ms": eager_s * 1e3,
               "img_per_s": pins["data"].data.shape[0] / secs}
        if lib_res is not None:
            row["logits_vs_lib"] = rel_err(torch.from_numpy(replay[logits].data),
                                           torch.from_numpy(lib_res[logits].data))[1]
            check(row["logits_vs_lib"] <= SLICE_TOL["fc1000"],
                  f"[xla] {net} {tag}: {logits} vs cuda lib {row['logits_vs_lib']:.3g}")
        print(f"[xla] {net} b{pins['data'].data.shape[0]} bf16 {tag}: replay "
              f"{row['replay_ms']:.3f} ms, eager {row['eager_ms']:.3f} ms ("
              f"{row['img_per_s']:.1f} img/s); replay bit-equal to eager on two batches"
              + (f"; {logits} vs cuda lib {row['logits_vs_lib']:.3e} (tol "
                 f"{SLICE_TOL['fc1000']})" if lib_res is not None else "")
              + f"; launches {n} ({card})")
        return e, replay, row

    # -- ResNet-50 b32 bf16 -------------------------------------------------------------
    pipe_of = {"resnet50": pipe}
    outs = ["fc1000", "prob"]
    rows, res = {}, {}
    for tag, (mode, kw) in engines.items():
        e, res[tag], rows[tag] = replays(tag, "resnet50", mode, kw, ins, outs,
                                         res.get("cuda lib"), "fc1000")
        n = rows[tag]["launches"]
        if tag == "pallas nchw gen":
            log = e.get_info_log()
            want = dict.fromkeys(n, 0) | XLA_LAUNCHES
            print(f"[xla] the NCHW route: {log.count(': k1conv ')} k1conv, "
                  f"{log.count(': ipmatmul ')} ipmatmul, {log.count(': pallas_conv ')} "
                  f"pallas_conv; conv1: {'strided conv -> xla' in log}")
            check(n == want, f"[xla] nchw gen launches {n}, expected {want}")
            check("conv1: strided conv -> xla" in log, "[xla] the stem is not on the logical rule")
            route_e = e
        else:
            check(not any(n.values()), f"[xla] {tag} launched hand kernels {n}")
        del e
    print(f"[xla] resnet50 b{BATCH} bf16 replay ms: " + ", ".join(
        f"{t} {r['replay_ms']:.3f}" for t, r in rows.items())
        + f"; cuda lib's {LIB_R50_PR13_MS} ms in PR 13 ({card})")
    out["resnet50"] = rows

    # each distinct K1/K3 call of the NCHW route, on the route's own operands
    calls, real = {}, {"K1": cnn_variants.matmul, "K3": cnn_variants.conv2d_nhwc}

    def recorder(k):
        def call(*a, **kw):
            key = (k, tuple((tuple(t.shape), str(t.dtype)) for t in a), tuple(sorted(kw.items())))
            calls.setdefault(key, (k, [t.clone() for t in a], dict(kw)))
            return real[k](*a, **kw)
        return call
    cnn_variants.matmul, cnn_variants.conv2d_nhwc = recorder("K1"), recorder("K3")
    try:
        route_e.cuda_graph = False
        route_e.run_fwd(ins, outs)
    finally:
        cnn_variants.matmul, cnn_variants.conv2d_nhwc = real["K1"], real["K3"]
    worst = (0.0, "")
    for k, args, kw in calls.values():
        with torch.inference_mode():
            got = real[k](*args, **kw)
            ref = matmul_plain(*args, **kw) if k == "K1" else conv2d_plain(*args, **kw)
        err = rel_err(got, ref)[1]
        what = f"{k} " + "x".join(map(str, args[0].shape)) + " @ " + \
            "x".join(map(str, args[1].shape)) + f" relu={int(kw.get('relu', False))}"
        worst = max(worst, (err, what))
        check(err <= XLA_CALL_TOL, f"[xla] {what}: {err:.3g} of max|plain|")
    print(f"[xla] {len(calls)} distinct K1/K3 calls of the NCHW route vs plain: worst "
          f"{worst[0]:.3e} at {worst[1]} (tol {XLA_CALL_TOL})")
    out["route_calls"] = {"n": len(calls), "worst": worst[0], "at": worst[1]}
    del route_e, res

    # -- f32: every node at b2, the gradient graph at b4 ---------------------------------
    spipe, sdims = load_net("resnet50", img=2)
    scale_fc1000([spipe], fc_scale)
    sins, nodes = gen_data_inputs(sdims), check_nodes(spipe)
    fres = {}
    for tag, mode, kw in (("lib", "cuda", {"kernel_policy": "lib"}), ("xla", "xla", {})):
        e = make("conv_fwd", mode, cuda_graph=False, **kw)  # eager: a check, not a replay
        e.init(spipe)
        fres[tag] = e.run_fwd(sins, nodes)
        del e
    fails, worst = node_agreement(fres["lib"], fres["xla"], nodes, XLA_F32_NODE_TOL)
    print(f"[xla] resnet50 f32 b2, every node xla vs cuda lib: {len(nodes) - len(fails)}/"
          f"{len(nodes)} agree, worst {worst[0]:.3e} at {worst[1]} (tol {XLA_F32_NODE_TOL})")
    check(not fails, f"[xla] f32 nodes: {fails[:3]}")
    out["f32_nodes_worst"] = worst[0]
    del fres

    gpipe, gdims = load_net("resnet50", img=XLA_GRAD_BATCH)
    scale_fc1000([gpipe], fc_scale)
    add_bck_ops(gpipe)
    gdims["label"] = gpipe.nodes["label"].dims
    gins, gnodes = gen_data_inputs(gdims), check_nodes(gpipe)
    fwd = [n for n in gnodes if "__grad" not in n]
    grad = [n for n in gnodes if "__grad" in n]
    geng = {"lib": make("conv_fwd", "cuda", kernel_policy="lib", cuda_graph=False),
            "xla": make("conv_fwd", "xla", cuda_graph=False)}
    gres = {}
    for tag, e in geng.items():
        e.init(gpipe)
        gres[tag] = e.run_fwd(gins, gnodes)
    fails, worst = node_agreement(gres["lib"], gres["xla"], fwd, GRAD_F32_TOL)
    gfails, gworst = node_agreement(gres["lib"], gres["xla"], grad, GRAD_F32_TOL)
    print(f"[xla] resnet50 f32 b{XLA_GRAD_BATCH} add_bck_ops, free runs: forward nodes "
          f"{len(fwd) - len(fails)}/{len(fwd)} agree (worst {worst[0]:.3e} at {worst[1]}); "
          f"gradient nodes {len(grad) - len(gfails)}/{len(grad)} (worst {gworst[0]:.3e}, "
          f"not gated)")
    check(not fails, f"[xla] gradient graph forward nodes: {fails[:3]}")
    forced = dict(gins)
    forced.update({n: gres["lib"][n] for n in fwd})
    del gres
    bres = {tag: e.run_fwd(forced, grad) for tag, e in geng.items()}
    fails, worst = node_agreement(bres["lib"], bres["xla"], grad, GRAD_F32_TOL)
    print(f"[xla] backward from lib's forward values, {len(grad)} gradient nodes xla vs cuda "
          f"lib: {len(grad) - len(fails)} agree, worst {worst[0]:.3e} at {worst[1]} "
          f"(comp_vars {GRAD_F32_TOL})")
    check(not fails, f"[xla] gradient nodes: {fails[:3]}")
    out["grad_worst"] = worst[0]
    del bres, geng, forced

    # -- GoogLeNet b32 and ssd300 b4, bf16, under xla ------------------------------------
    gpipe, gdims = load_net("googlenet_conv", img=BATCH)
    lib = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib")
    lib.init(gpipe)
    g_ins = gen_data_inputs(gdims)
    lmax = float(np.abs(lib.run_fwd(g_ins, [GOOGLENET_LOGITS])[GOOGLENET_LOGITS].data).max())
    gpipe.weights[f"{GOOGLENET_LOGITS}__filts"].data *= np.float32(1.0 / lmax)
    del lib
    spipe, s_dims = load_net("ssd300", img=SSD_BATCH)
    pipe_of.update(googlenet_conv=gpipe, ssd300=spipe)
    s_ins = gen_data_inputs(s_dims)
    for net, nins, nouts, logits in (("googlenet_conv", g_ins, [GOOGLENET_LOGITS, "prob"],
                                      GOOGLENET_LOGITS),
                                     ("ssd300", s_ins, SSD_BF16_NODES, None)):
        _, lres, lrow = replays("cuda lib", net, "cuda", {"kernel_policy": "lib"}, nins, nouts)
        _, xres, xrow = replays("xla", net, "xla", {}, nins, nouts, lres, logits or nouts[0])
        if logits is None:
            errs = {n: rel_err(torch.from_numpy(xres[n].data),
                               torch.from_numpy(lres[n].data))[1] for n in nouts}
            print(f"[xla] ssd300 bf16 xla vs cuda lib: " + ", ".join(
                f"{n} {v:.3e}" for n, v in errs.items()) + f" (tol {SSD_BF16_TOL})")
            check(max(errs.values()) <= SSD_BF16_TOL, f"[xla] ssd300 vs lib {errs}")
            xrow["vs_lib"] = errs
        out[net] = {"cuda lib": lrow, "xla": xrow}
    e32 = make("conv_fwd", "xla")
    e32.init(spipe)
    r32 = e32.run_fwd(s_ins, SSD_HEAD_INS + ["detection_out"])
    op = spipe.ops["detection_out"]
    head = ssd_ops._detection_output_fn(op, int(op.p("num_classes")), SSD_BATCH, "cpu")
    with torch.inference_mode():
        on_cpu = head(*(torch.from_numpy(r32[k].data) for k in SSD_HEAD_INS))[0] \
            .numpy().reshape(-1, 7)
    same, herr = head_agree(r32["detection_out"].data.reshape(-1, 7), on_cpu)
    valid = int((on_cpu[:, 1] >= 0).sum())
    print(f"[xla] ssd300 f32 b{SSD_BATCH} xla: the replayed head vs the CPU's on its inputs, "
          f"image/label/order equal {same}, scores and boxes {herr:.3e} (tol {SSD_HEAD_TOL}); "
          f"{valid} valid rows")
    check(same and herr <= SSD_HEAD_TOL and valid > 0, f"[xla] ssd300 head {same} {herr:.3g}")
    out["ssd300"]["head_vs_cpu"] = herr
    return out


def mma_conv(x, w, bias, stride: int, pad: int, relu: bool = True):
    """One launch of the GEMM core's mma.sync loop on a bf16 conv, past the
    plan (the route of a conv with C % 8 != 0 before wgmma_narrow, and of
    N % 8 != 0 before wgmma_edge), to time beside the planned route; it
    counts no launch. w may have padded rows (``pad_rows``)."""
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import PATH_CODES, check_rows
    n, h, wd, c = x.shape
    kh, kw, _, oc = w.shape
    ldb = check_rows("w", w, x.device, x.dtype, w.shape)
    oh, ow = (h + 2 * pad - kh) // stride + 1, (wd + 2 * pad - kw) // stride + 1
    out = torch.empty((n, oh, ow, oc), dtype=x.dtype, device=x.device)
    rc = build.load().lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(), None,
                                      out.data_ptr(), None, n, h, wd, c, oh, ow, oc, kh, kw,
                                      stride, stride, pad, pad, int(relu), 1, PATH_CODES["mma"],
                                      128, 128, 1, ldb, build.stream_ptr(x))
    build.check(rc, "boda_conv2d on the mma.sync loop")
    return out


def mma_gemm(a, b, bias=None):
    """mma_conv's counterpart for K1: a @ b (+ bias) on the mma.sync loop,
    past the plan; a and b may have padded rows."""
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.common import PATH_CODES, check_rows, ptr
    (M, K), N = a.shape, b.shape[1]
    lda = check_rows("a", a, a.device, a.dtype, a.shape)
    ldb = check_rows("b", b, a.device, a.dtype, b.shape)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    rc = build.load().lib.boda_gemm(a.data_ptr(), b.data_ptr(), ptr(bias), None,
                                    out.data_ptr(), None, M, N, K, 0, 1, PATH_CODES["mma"],
                                    128, 128, 1, lda, ldb, build.stream_ptr(a))
    build.check(rc, "boda_gemm on the mma.sync loop")
    return out


def mma_atb(a, b):
    """The same for K5: a^T @ b in f32 on its WMMA (mma.sync) loop with the
    plan a dense b of that shape gets (the route before wgmma_edge); b may
    have padded rows."""
    from boda_tpu_torch.ops.kernels import build
    from boda_tpu_torch.ops.kernels.bconv import atb_workspace, plan_atb
    from boda_tpu_torch.ops.kernels.common import PATH_CODES, check_rows, ptr, sm_count
    (K, M), N = a.shape, b.shape[1]
    ldb = check_rows("b", b, a.device, a.dtype, b.shape)
    plan = plan_atb(M, N, K, 1, sm_count(a.device), a.dtype)
    check(plan.path == "mma", f"mma_atb: a dense b of {tuple(b.shape)} plans {plan}")
    out = torch.empty((M, N), dtype=torch.float32, device=a.device)
    ws = atb_workspace(plan, 1, M, N, a.device)
    rc = build.load().lib.boda_atb(a.data_ptr(), b.data_ptr(), out.data_ptr(), ptr(ws), M, N,
                                   K, plan.split, plan.chunk, 0, 0, 0, 0, 0, 1, 1, 0, 0, 1,
                                   PATH_CODES["mma"], plan.bm, plan.bn, ldb,
                                   build.stream_ptr(a))
    build.check(rc, "boda_atb on the mma.sync loop")
    return out


def narrow_phase(card: str) -> dict:
    """[narrow]: K2's narrow route at each of NARROW_SHAPES, ReLU fused as the
    engine fuses it, on seeded bf16 operands: the path the launch counted
    (wgmma_narrow), the output within TOL of ``conv2d_plain``; the device
    time in a CUDA graph (``graph_time``, L2 warm) of the kernel, of the
    mma.sync loop on the same operands (held to plain as well), and of
    cuDNN's ``F.conv2d`` in bf16 on the channels_last views with ReLU; the
    plain version's back-to-back time; the bound. Returns the rows by
    shape."""
    import torch.nn.functional as F

    from boda_tpu_torch.ops.kernels.conv import conv2d, conv2d_plain
    from boda_tpu_torch.rtc.backends import graph_time
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = {}
    for sig, where in NARROW_SHAPES.items():
        n, h, c, oc, k, st, p = sig
        x = torch.randn((n, h, h, c), generator=gen, device=dev).to(bf)
        w = (torch.randn((k, k, c, oc), generator=gen, device=dev) * (k * k * c) ** -0.5).to(bf)
        bias = (torch.randn((oc,), generator=gen, device=dev) * 0.1).to(bf)
        kw = dict(stride=(st, st), pad=(p, p), relu=True)
        before = dict(conv2d.paths)
        out = conv2d(x, w, bias, **kw)
        torch.cuda.synchronize()
        ran = [q for q in before if conv2d.paths[q] != before[q]]
        plan = conv2d.last_plan
        ref = conv2d_plain(x, w, bias, **kw)
        ae, re = rel_err(out, ref)
        _, re_mma = rel_err(mma_conv(x, w, bias, st, p), ref)
        w_lib = w.permute(3, 0, 1, 2).contiguous()  # OHWI: channels_last OIHW view
        xn, wn = x.permute(0, 3, 1, 2), w_lib.permute(0, 3, 1, 2)

        def lib():
            return torch.relu(F.conv2d(xn, wn, bias, stride=st, padding=p))
        b_ms, o_ms = work("conv", sig + (False,))
        row = {"where": where, "path": ran, "plan": plan_str(plan), "max_abs_err": ae,
               "max_rel_err": re, "mma_rel_err": re_mma,
               "us": graph_time(lambda: conv2d(x, w, bias, **kw)) * 1e6,
               "mma_us": graph_time(lambda: mma_conv(x, w, bias, st, p)) * 1e6,
               "library_us": graph_time(lib) * 1e6,
               "plain_ms": cuda_ms(lambda: conv2d_plain(x, w, bias, **kw), reps=5),
               "bound_us": max(b_ms, o_ms) * 1e3,
               "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        rows[sig] = row
        print(f"[narrow] {where} {sig}: {re:.3e} on {ran} (mma.sync loop {re_mma:.3e}), plan "
              f"{row['plan']}; kernel {row['us']:.2f} us, mma.sync loop {row['mma_us']:.2f} us, "
              f"cuDNN {row['library_us']:.2f} us, bound {row['bound_us']:.2f} us "
              f"({row['bound_by']}) ({card})")
        check(ran == ["wgmma_narrow"] and plan.path == "wgmma_narrow",
              f"narrow {sig}: path {ran}, plan {plan}")
        check(bool(torch.isfinite(out.float()).all()) and re <= TOL[bf] and re_mma <= TOL[bf],
              f"narrow {sig}: rel err {re:.3g}, mma.sync loop {re_mma:.3g} > {TOL[bf]}")
        del x, w, out, ref, xn, wn, w_lib
    return rows


def edge_phase(card: str) -> dict:
    """[edge]: the GEMM core's edge route at each of EDGE_SHAPES (K2, without
    ReLU, as the engine runs ssd300's mbox_conf heads) and the products on
    16-byte rows of EDGE_GEMMS (the (tp=2) step's fc1000 slice: K1's forward
    on wgmma_edge, its dgrad on wgmma with A = dY's padded rows, K5's wgrad
    on wgmma_edge with B = dY's padded rows), on seeded bf16 operands in the
    padded rows the engine's HWIO prep (``pad_rows``) and GenFc
    (``copy_rows``) store: the path the launch counted and no copy, the
    output within TOL of the plain version; the device time in a CUDA graph
    (``graph_time``, L2 warm) of the kernel, of the mma.sync loop on the same
    operands (an explicit plan past the planner, held to plain as well) and
    of the library's call on the same layout (cuDNN's ``F.conv2d`` on the
    channels_last views, cuBLAS's ``torch.addmm`` or ``torch.mm``); for K1's
    forward also the call on a dense b, whose padded copy the wrapper makes;
    the plain version's back-to-back time; the bound. Returns the rows by
    key (EDGE_SHAPES' sig, EDGE_GEMMS' (kernel, sig))."""
    import torch.nn.functional as F

    from boda_tpu_torch.ops.kernels.bconv import matmul_atb, matmul_atb_plain
    from boda_tpu_torch.ops.kernels.common import copy_rows, pad_rows
    from boda_tpu_torch.ops.kernels.conv import conv2d, conv2d_plain
    from boda_tpu_torch.ops.kernels.sgemm import matmul, matmul_plain
    from boda_tpu_torch.rtc.backends import graph_time
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(25)

    def rnd(shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(bf)
    rows = {}
    for key, where in {**EDGE_SHAPES, **EDGE_GEMMS}.items():
        kname, sig = ("conv", key) if key in EDGE_SHAPES else key
        want, dense_b, lib_name = "wgmma_edge", None, "cuBLAS"
        if kname == "conv":
            n, h, c, oc, k, st, p = sig
            x = rnd((n, h, h, c))
            dense = rnd((k, k, c, oc), (k * k * c) ** -0.5)
            bias = rnd((oc,), 0.1)
            kw = dict(stride=(st, st), pad=(p, p))
            ops = (x, pad_rows(dense), bias)
            fk, counter = (lambda x, w, bias: conv2d(x, w, bias, **kw)), conv2d
            plain = (lambda x, w, bias: conv2d_plain(x, w, bias, **kw))
            mma = (lambda x, w, bias: mma_conv(x, w, bias, st, p, relu=False))
            w_lib = dense.permute(3, 0, 1, 2).contiguous()  # OHWI: channels_last OIHW view
            xn, wn = x.permute(0, 3, 1, 2), w_lib.permute(0, 3, 1, 2)
            lib = (lambda: F.conv2d(xn, wn, bias, stride=st, padding=p))
            lib_name = "cuDNN"
            b_ms, o_ms = work("conv", sig + (False,))
        elif kname == "sgemm":
            M, K, N = sig
            fk, plain, mma, counter = matmul, matmul_plain, mma_gemm, matmul
            b_ms, o_ms = work("sgemm", (M, K, N, False, False))
            if K % 8 == 0:  # the forward: x @ W + b, W's rows padded
                dense_b = rnd((K, N), K ** -0.5)
                ops = (rnd((M, K)), pad_rows(dense_b), rnd((N,), 0.1))
                lib = (lambda a=ops[0], b=dense_b, bias=ops[2]: torch.addmm(bias, a, b))
            else:  # the dgrad: dY @ W^T, dY's rows padded (K = the slice's width)
                ops = (copy_rows(rnd((M, K)), bf), rnd((K, N), K ** -0.5))
                want = "wgmma"
                lib = (lambda a=ops[0], b=ops[1]: torch.mm(a, b))
        else:  # atb, (K, M, N): the wgrad x^T @ dY, dY's rows padded
            K, M, N = sig
            ops = (rnd((K, M)), copy_rows(rnd((K, N)), bf))
            fk, plain, mma, counter = matmul_atb, matmul_atb_plain, mma_atb, matmul_atb
            lib = (lambda a=ops[0], b=ops[1]: a.t() @ b)
            b_ms, o_ms = work("atb_dense", sig)
        before = dict(counter.paths)
        copies = getattr(counter, "pad_copies", 0)
        out = fk(*ops)
        torch.cuda.synchronize()
        ran = [q for q in before if counter.paths[q] != before[q]]
        copies = getattr(counter, "pad_copies", 0) - copies
        plan = counter.last_plan
        ref = plain(*ops)
        ae, re = rel_err(out, ref)
        _, re_mma = rel_err(mma(*ops), ref)
        row = {"where": where, "kernel": kname, "path": ran, "plan": plan_str(plan),
               "max_abs_err": ae, "max_rel_err": re, "mma_rel_err": re_mma,
               "us": graph_time(lambda: fk(*ops)) * 1e6,
               "mma_us": graph_time(lambda: mma(*ops)) * 1e6,
               "library_us": graph_time(lib) * 1e6,
               "plain_ms": cuda_ms(lambda: plain(*ops), reps=5),
               "bound_us": max(b_ms, o_ms) * 1e3,
               "bound_by": "bytes" if b_ms >= o_ms else "operations"}
        re_dense = 0.0
        if dense_b is not None:
            _, re_dense = rel_err(fk(ops[0], dense_b, ops[2]), ref)
            row["dense_rel_err"] = re_dense
            row["dense_us"] = graph_time(lambda: fk(ops[0], dense_b, ops[2])) * 1e6
        if kname == "atb":  # split-K reduced in one order: a second launch, the same bits
            row["again_equal"] = bool(torch.equal(fk(*ops), out))
        rows[key] = row
        print(f"[edge] {where} {sig}: {re:.3e} on {ran} (mma.sync loop {re_mma:.3e}"
              + (f", dense B {re_dense:.3e}" if dense_b is not None else "")
              + f"), plan {row['plan']}; kernel {row['us']:.2f} us"
              + (f" ({row['dense_us']:.2f} us on a dense b, its copy included)"
                 if dense_b is not None else "")
              + f", mma.sync loop {row['mma_us']:.2f} us, {lib_name} "
              f"{row['library_us']:.2f} us, bound {row['bound_us']:.2f} us "
              f"({row['bound_by']}) ({card})")
        check(ran == [want] and plan.path == want and copies == 0
              and row.get("again_equal", True),
              f"edge {key}: path {ran} (want {want}), plan {plan}, {copies} copies, "
              f"again equal {row.get('again_equal')}")
        check(bool(torch.isfinite(out.float()).all()) and max(re, re_mma, re_dense) <= TOL[bf],
              f"edge {key}: rel err {re:.3g}, mma.sync loop {re_mma:.3g}, dense B "
              f"{re_dense:.3g} > {TOL[bf]}")
        del ops, out, ref
    return rows


def main() -> int:
    t_main = time.perf_counter()
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
    from boda_tpu_torch.ops.kernels.common import copy_rows
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

    # the seconds each phase takes, for the time budget: lap(name) ends a phase
    laps, t_lap = {}, [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        laps[name], t_lap[0] = now - t_lap[0], now

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

    lap("build")
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

    def atb_case(K, M, N, dt, padded=False):
        a, b = rnd((K, M), dt), rnd((K, N), dt)
        b = copy_rows(b, dt) if padded else b
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

    lap("kernels")
    # -- phase 2a: K2's narrow route (C % 8 != 0) at every shape a path runs ----------
    narrow = narrow_phase(card)

    lap("narrow")
    # -- phase 2a': the edge route (N % 8 != 0) at every shape a path runs -------------
    edge = edge_phase(card)

    lap("edge")
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

    lap("eltwise")
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

    lap("stem")
    # -- phase 2d: NaN at ReLU and max, as jnp.maximum gives it --------------------
    misses = []
    for name in NAN_CASES:
        ok, line = nan_check(name, dev)
        print(line)
        if not ok:
            misses.append(name)
    check(not misses, f"nan phase: {misses} differ from their plain versions")

    lap("nan")
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
    gen_paths = {"sgemm": dict(matmul.paths), "conv": dict(conv2d.paths)}
    check_paths("gen forward sgemm", matmul.paths, launches["sgemm"], 0)
    check_paths("gen forward conv", conv2d.paths, launches["conv"], 0, 1)  # the C = 3 stem
    launches["conv_narrow"] = conv2d.paths["wgmma_narrow"]
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

    lap("slice")
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

    lap("fused")
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

    lap("grad-f32")
    # -- phase 5: the gradient graph, bf16, b32: loss, input and weight grads -------
    bins = gen_data_inputs(bdims)
    bwant = ["prob_loss", "data__grad__p0"] + weight_grads(bpipe)
    beng = make("conv_fwd", "cuda", compute_tn="bfloat16")
    beng.init(bpipe)
    blib = make("conv_fwd", "cuda", compute_tn="bfloat16", kernel_policy="lib")
    blib.init(bpipe)
    beng.prepare(bins, bwant)
    zero_counts(counted)
    bres = {"gen": beng.run_fwd(bins, bwant)}
    launches_bck = read_counts(counted)
    # exact, as the pipe gives them; the forward's convs and the 46 dgrads
    # all on wgmma but the C = 3 stem, on wgmma_narrow
    want_bck = grad_graph_launches(bpipe)
    print(f"[grad-bf16] resnet50 b{BATCH} gen: launches {launches_bck} (expected from the "
          f"pipe {want_bck}; bck-conv ops {n_bck_conv})")
    check(launches_bck == want_bck and want_bck["conv_nhwc"] == n_bck_conv,
          f"grad-bf16 launches {launches_bck}, expected {want_bck}")
    check_paths("grad-bf16 sgemm", counted["sgemm"].paths, launches_bck["sgemm"], 0)
    check_paths("grad-bf16 conv (forward + 46 dgrads)", counted["conv"].paths,
                launches_bck["conv"], 0, 1)
    check_paths("grad-bf16 atb (46 wgrads)", counted["atb"].paths, launches_bck["atb"], 0)
    grad_gate_vs_lib("grad-bf16", bpipe, beng, blib, bins, bwant, bres["gen"])
    del bres
    # [graph-grad]: each gradient graph's replay against eager, two batches
    grad_rows = grad_replays("graph-grad", f"resnet50 b{BATCH}", {"gen": beng, "lib": blib},
                             bins, bwant, card)
    grad_rates = {pol: r["img_per_s"] for pol, r in grad_rows.items()}
    grad_eager_rates = {pol: r["eager_img_per_s"] for pol, r in grad_rows.items()}
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

    lap("grad-bf16")
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

    # the replayed gen forward's early nodes, conv1 through res2a, against lib's
    early = {pol: e.run_fwd(ins, list(EARLY_NODES)) for pol, e in (("gen", eng), ("lib", lib))}
    early_errs = {}
    for n in EARLY_NODES:
        g, r = (torch.from_numpy(early[p][n].data) for p in ("gen", "lib"))
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(1e-30))) - 7)
        early_errs[n] = (rel_err(g, r)[1], float(((g - r).abs() > ulp).float().mean()),
                         float((g - r).mean() / r.abs().mean().clamp_min(1e-30)))
    print(f"[graph] resnet50 b{BATCH} bf16 replayed gen vs lib, early nodes, max|err|/max|ref| "
          f"(share of elements > 1 bf16 ulp apart, mean err / mean|ref|): "
          + ", ".join(f"{n} {a:.3e} ({b:.4f}, {c:+.2e})" for n, (a, b, c) in early_errs.items())
          + f" (tol {EARLY_NODE_TOL}; mean err {EARLY_BIAS_TOL})")
    check(max(a for a, _, _ in early_errs.values()) <= EARLY_NODE_TOL
          and max(abs(c) for _, _, c in early_errs.values()) <= EARLY_BIAS_TOL,
          f"graph: early nodes gen vs lib {early_errs}")
    graph_rows["early_nodes"] = early_errs
    del early

    lap("graph")
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

    lap("input_s2d")
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

    lap("stats")
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

    lap("run_cnet")
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

    lap("rtc")
    # -- phase 7: [caffe] the Caffe frontend; GoogLeNet b32 bf16 read back ------------
    caffe = caffe_phase(card, out_dir, counted, {"gemm": gemm_case, "conv": conv_case,
                                                 "pool": pool_case, "s2d": s2d_case})
    g_gen, g_fused = caffe["googlenet"]["gen"]["launches"], caffe["googlenet"]["fused"]["launches"]

    lap("caffe")
    # -- phase 7b: [caffe-grad] GoogLeNet's gradient graph, gen and lib -------------
    caffe_grad = caffe_grad_phase(card, counted)

    lap("caffe-grad")
    # -- phase 8: [int8] ResNet-50 b32 int8-static in bench.py's configuration --------
    int8 = int8_phase(card, pipe, ins, counted)

    lap("int8")
    # -- phase 9: [lmdb] records in: net_calib and test_lmdb; the last four rules -----
    lmdb = lmdb_phase(card, out_dir)

    lap("lmdb")
    # -- phase 10: [ssd] ssd300 b4, the detection head in the captured forward ------
    ssd = ssd_phase(card, out_dir, counted, {"gemm": gemm_case, "conv": conv_case,
                                             "pool": pool_case, "s2d": s2d_case})

    lap("ssd")
    # -- phase 11: [train] the training step, train_bench, learning, resume ---------
    train = train_phase(card, pipe, fc_scale, counted,
                        {"gemm": gemm_case, "conv": conv_case, "dgrad": dgrad_case,
                         "wgrad": wgrad_case, "atb": atb_case})

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
        if kname in ("sgemm", "conv", "atb", "dgrad"):  # one gen b32 bf16 training step
            entry["launches_train"] = train["launches_gen"][
                "conv_nhwc" if kname == "dgrad" else kname]
            # and one replay of it captured (BN frozen, momentum 0.9), from the
            # replay's device profile: K3's dgrads run the conv kernel, in conv's
            if kname != "dgrad":
                entry["launches_train_replay"] = train["graph"]["gen_bn0.0"][
                    "hand_replay"][kname]
            # and one gen pass of GoogLeNet's b32 bf16 gradient graph
            entry["launches_googlenet_grad"] = caffe_grad["launches_gen"][
                "conv_nhwc" if kname == "dgrad" else kname]
        if kname in ("sgemm", "conv"):
            entry["launches_fused"] = launches_fused[kname]
            entry["paths"] = gen_paths[kname]  # the gen forward's launches per route
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
            entry["launches_ssd300"] = (ssd["launches_gen"] if kname in ("sgemm", "conv")
                                        else ssd["launches_fused"])[kname]
        kernels.append(entry)
    # K2's narrow route: the gen forward's stem; its times at that shape, and
    # at every narrow shape under "shapes"
    nm = narrow[NARROW_MAIN]
    kernels.append({"name": "conv_narrow", "route": "cuda", "source": "boda_tpu_torch/csrc/conv.cu",
                    "replaces": "boda_tpu/ops/kernels/conv.py:575", "path": "wgmma_narrow",
                    "launches": launches["conv_narrow"], "max_abs_err": nm["max_abs_err"],
                    "ms": nm["us"] * 1e-3, "plain_ms": nm["plain_ms"],
                    "bound_ms": nm["bound_us"] * 1e-3, "bound_by": nm["bound_by"],
                    "library_ms": nm["library_us"] * 1e-3, "mma_ms": nm["mma_us"] * 1e-3,
                    "shapes": {str(sig): r for sig, r in narrow.items()}})
    # K2's edge route: ssd300's six mbox_conf heads, one launch each per gen
    # forward ([ssd]'s captured forward gives the launches); the times of the
    # six summed, as one forward runs them, and each under "shapes"
    heads = [edge[sig] for sig in EDGE_SHAPES]
    kernels.append({"name": "conv_edge", "route": "cuda", "source": "boda_tpu_torch/csrc/conv.cu",
                    "replaces": "boda_tpu/ops/kernels/conv.py:575", "path": "wgmma_edge",
                    "launches": ssd["conv_paths_gen"]["wgmma_edge"],
                    "max_abs_err": max(r["max_abs_err"] for r in heads),
                    "ms": sum(r["us"] for r in heads) * 1e-3,
                    "plain_ms": sum(r["plain_ms"] for r in heads),
                    "bound_ms": sum(r["bound_us"] for r in heads) * 1e-3,
                    "bound_by": max(heads, key=lambda r: r["bound_us"])["bound_by"],
                    "library_ms": sum(r["library_us"] for r in heads) * 1e-3,
                    "mma_ms": sum(r["mma_us"] for r in heads) * 1e-3,
                    "main_path": f"ssd300 b{SSD_BATCH} bf16 gen, the captured forward",
                    "shapes": {str(sig): edge[sig] for sig in EDGE_SHAPES}})
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
    lap("train")
    # -- phase 12: [tools] net_trace, train_trace, net_tune, cnn_prof, the ipc worker --
    tools = tools_phase(card, out_dir, counted)
    for entry in kernels:
        k = {"dgrad": "conv_nhwc"}.get(entry["name"], entry["name"])
        if k in tools["launches"]:
            entry["launches_tools"] = tools["launches"][k]
    lap("tools")
    # -- phase 13: [serve] the served forward, the pipeline, zmq_det, cnet_predict ------
    serve = serve_phase(card, pipe, in_dims, out_dir, counted)
    for entry in kernels:
        if entry["name"] in ("sgemm", "conv"):
            entry["launches_serve"] = serve["launches"][entry["name"]]
    lap("serve")
    # -- phase 14: [corpus] the golden corpus through the port's test_all ------------
    corpus = corpus_phase(card, out_dir)
    lap("corpus")
    # -- phase 15: [mesh] the engine's dp/tp mesh; gen_src_dir on the card -------------
    mesh = mesh_phase(card, fc_scale, out_dir, counted)
    for entry in kernels:  # one gen dp=2 forward's launches
        if entry["name"] in ("sgemm", "conv"):
            entry["launches_mesh"] = mesh["gen"]["launches"][entry["name"]]
    lap("mesh")
    # -- phase 16: [dist] the dp training step across ranks ----------------------------
    dist_run = dist_phase(card, out_dir)
    lap("dist")
    # -- phase 17: [tp-train] tensor parallelism in the training step ----------------
    tp_train = tp_train_phase(card, pipe, fc_scale, counted,
                              {"gemm": gemm_case, "conv": conv_case, "dgrad": dgrad_case,
                               "wgrad": wgrad_case, "atb": atb_case})
    for entry in kernels:  # the second step of the gen b32 bf16 (tp=2) step
        k = {"dgrad": "conv_nhwc"}.get(entry["name"], entry["name"])
        if entry["name"] in ("sgemm", "conv", "dgrad", "atb"):
            entry["launches_tp_train"] = tp_train["tp2"]["launches"][k]
        if entry["name"] in ("sgemm", "conv", "atb"):  # one replay of it captured
            entry["launches_tp_train_replay"] = tp_train["graph"]["hand_replay"][k]
    # the (tp=2) step's fc1000 per slice, its launches from that step's
    # second step: K1's forward on wgmma_edge, K1's dgrad on wgmma at K =
    # 500 (dY's padded rows: matmul.padded_a's launches), K5's wgrad on
    # wgmma_edge; none on the mma.sync loop (the dgrad's and the wgrad's
    # route before dY's rows were padded: mma_ms)
    tp_paths = tp_train["tp2"]["paths"]
    for (kname, gsig), name, path, launches in (
            (("sgemm", (BATCH, 2048, 500)), "sgemm_edge", "wgmma_edge",
             tp_paths["sgemm"].get("wgmma_edge", 0)),
            (("sgemm", (BATCH, 500, 2048)), "sgemm_padded_a", "wgmma",
             tp_train["tp2"]["k1_padded_a"]),
            (("atb", (BATCH, 2048, 500)), "atb_edge", "wgmma_edge",
             tp_paths["atb"].get("wgmma_edge", 0))):
        fc = edge[(kname, gsig)]
        kernels.append({"name": name, "route": "cuda",
                        "source": "boda_tpu_torch/csrc/" + ("sgemm.cu" if kname == "sgemm"
                                                            else "atb.cu"),
                        "replaces": "boda_tpu/ops/kernels/" + ("sgemm.py:80" if kname == "sgemm"
                                                               else "bconv.py:53"),
                        "path": path, "launches": launches,
                        "max_abs_err": fc["max_abs_err"], "ms": fc["us"] * 1e-3,
                        "plain_ms": fc["plain_ms"], "bound_ms": fc["bound_us"] * 1e-3,
                        "bound_by": fc["bound_by"], "library_ms": fc["library_us"] * 1e-3,
                        "mma_ms": fc["mma_us"] * 1e-3,
                        "main_path": "the gen b32 bf16 (tp=2) training step, its second step",
                        "shapes": {str(gsig): fc}})
        if "dense_us" in fc:
            kernels[-1]["dense_ms"] = fc["dense_us"] * 1e-3
    check(all(e["launches"] > 0 for e in kernels if e["name"].endswith(("_edge", "_padded_a"))),
          "a route on 16-byte rows ran on no main path: "
          f"{[(e['name'], e['launches']) for e in kernels if '_' in e['name']]}")
    lap("tp-train")
    # -- phase 18: [xla] boda_tpu's engines: the logical-layout oracle, the NCHW route --
    xla = xla_phase(card, pipe, ins, fc_scale, counted)
    for entry in kernels:  # one ResNet-50 b32 forward of the NCHW route
        k = {"dgrad": "conv_nhwc"}.get(entry["name"], entry["name"])
        if entry["name"] in ("sgemm", "dgrad"):
            entry["launches_xla"] = xla["resnet50"]["pallas nchw gen"]["launches"][k]
    lap("xla")
    print("chip_smoke: seconds per phase: " + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()))
    print(f"chip_smoke: {time.perf_counter() - t_main:.1f} s from start to the kernels line")
    print(json.dumps({"kernels": kernels, "img_per_s": rates, "img_per_s_eager": eager_rates,
                      "graph": graph_rows, "input_s2d_img_per_s": s2d_rates,
                      "host_us_per_launch": host_us, "grad_img_per_s": grad_rates,
                      "grad_img_per_s_eager": grad_eager_rates,
                      "sgemm_run_4096": {tn: {k: r[k] for k in ("secs", "GF/s", "pct_peak")}
                                         for tn, r in sg.items()},
                      "caffe": caffe, "caffe_grad": caffe_grad, "int8": int8, "lmdb": lmdb, "ssd": ssd,
                      "train": train, "tools": tools, "serve": serve, "corpus": corpus,
                      "mesh": mesh, "dist": dist_run, "tp_train": tp_train, "xla": xla,
                      "phase_seconds": laps, "card": card}))
    print(smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
