"""GEMM with a fused bias(+residual)(+ReLU) store: the port of K1.

Counterpart of ``boda_tpu/ops/kernels/sgemm.py:pallas_matmul``. The CUDA
kernel is ``csrc/sgemm.cu`` on the shared core ``csrc/gemm.cuh``: bf16 on
wgmma with a TMA ring, a tile plan per shape and split-K
(:func:`~.common.plan_gemm`), on ``wgmma_edge`` for an even N % 8 != 0
(B's rows padded to 16 bytes, the output stored from the accumulators), or on
the mma.sync loop for the shapes TMA cannot take; f32 on FMA. A with K % 8 !=
0 takes wgmma when its rows are padded to 16 bytes (:func:`~.common.copy_rows`'s
view, as the training step's fc writes dY), the mma.sync loop when dense.
Ragged edges are masked in the kernel; only a dense B with N % 8 != 0 on
``wgmma_edge`` is copied, once per call, into padded rows
(``matmul.pad_copies``), which a caller avoids by passing
:func:`~.common.pad_rows`'s view. :func:`matmul`
launches it for CUDA tensors and runs :func:`matmul_plain` for CPU tensors;
there is no other fallback.
:func:`matmul_splitk_plain` sums K splits as the split kernel does.
:func:`gen_sgemm` is the rtc ``sgemm`` op.
"""

from __future__ import annotations

import torch

from ...rtc.compute import FuncInfo
from ...utils.dims import torch_dtype
from ..op_base import Op
from ..registry import GenCtx, kernel_gen, tune_note
from ..tune import OpTune
from . import build
from .common import (PATH_CODES, WGMMA_CHUNK, WGMMA_PATHS, aligned16, cdiv, check_operand,
                     check_rows, epilogue, kernel_dtype, kernel_entry, pad_rows, plan_gemm,
                     ptr, sm_count, splitk_workspace)


def matmul_plain(a, b, bias=None, *, relu: bool = False, residual=None):
    """The plain PyTorch version: f32 ``torch.matmul`` plus the epilogue,
    output in a's dtype."""
    return epilogue(torch.matmul(a.float(), b.float()), bias, residual, relu,
                    a.dtype)


def matmul_splitk_plain(a, b, bias=None, *, relu: bool = False, residual=None,
                        split: int = 1):
    """The split kernel's arithmetic in plain PyTorch: K cut into ``split``
    equal runs of 64-deep chunks (the last may be short), each run's f32
    partial product summed in order from 0, then the epilogue."""
    K = a.shape[1]
    per = cdiv(cdiv(K, WGMMA_CHUNK), split) * WGMMA_CHUNK
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32, device=a.device)
    for k0 in range(0, K, per):
        acc = acc + torch.matmul(a[:, k0:k0 + per].float(), b[k0:k0 + per].float())
    return epilogue(acc, bias, residual, relu, a.dtype)


@kernel_entry("K1", lambda: matmul.last_plan)
def matmul(a, b, bias=None, *, relu: bool = False, residual=None):
    """a[M,K] @ b[K,N] (+bias[N]) (+residual[M,N]) (+ReLU), f32 accumulate,
    output in a's dtype (float32 or bfloat16). Row-major operands; a's and
    b's rows may lie further apart than K and N (:func:`~.common.check_rows`)."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, bias, relu=relu, residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    dt = kernel_dtype(a)
    lda = check_rows("a", a, a.device, a.dtype, (M, K))
    ldb = check_rows("b", b, a.device, a.dtype, (K, N))
    if bias is not None:
        check_operand("bias", bias, a.device, a.dtype, (N,))
    if residual is not None:
        check_operand("residual", residual, a.device, a.dtype, (M, N))
    plan = plan_gemm(M, N, K, sm_count(a.device), a.dtype,
                     aligned=aligned16(a, b, bias, residual), lda=lda)
    if plan.path in WGMMA_PATHS and ldb % 8:  # TMA reads B's rows 16 bytes apart
        b = pad_rows(b)
        ldb = b.stride(0)
        matmul.pad_copies += 1
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    ws = splitk_workspace(plan, M, N, a.device)
    kb = build.load()
    with torch.cuda.device(a.device):
        rc = kb.lib.boda_gemm(a.data_ptr(), b.data_ptr(), ptr(bias), ptr(residual),
                              out.data_ptr(), ptr(ws), M, N, K, int(relu), dt,
                              PATH_CODES[plan.path], plan.bm, plan.bn, plan.split, lda,
                              ldb, build.stream_ptr(a))
    if rc:
        build.check(rc, f"boda_gemm {plan}")
    matmul.launches += 1
    matmul.paths[plan.path] += 1
    matmul.padded_a += lda != K
    matmul.last_plan = plan
    return out


# kernel launches, in all and per path of the plan (CPU plain-version calls
# do not count); a split-K launch (two kernels) counts once
matmul.launches = 0
matmul.paths = dict.fromkeys(PATH_CODES, 0)
matmul.last_plan = None  # the plan of the latest launch
matmul.pad_copies = 0  # launches on a padded copy of a dense b (N % 8 != 0 on wgmma_edge)
matmul.padded_a = 0  # launches with a's rows further apart than K (lda != K)


# -- standalone rtc-layer sgemm op ----------------------------------------------------
# signature: (type=sgemm,a=(M,K),b=(K,N),c=(M,N))

@kernel_gen("sgemm")
def gen_sgemm(op: Op, tune: OpTune, ctx: GenCtx) -> FuncInfo:
    """boda_tpu's ``gen_sgemm`` (sgemm.py:155): ``use_ref`` -> the plain f32
    version; ``use_xla`` -> ``torch.matmul`` (cuBLAS, the library path, at
    the tune's precision for f32); otherwise the hand GEMM (K1)."""
    ad, bd, cd = op.dims("a"), op.dims("b"), op.dims("c")
    M, K = ad["M"], ad["K"]
    N = bd["N"]
    if bd["K"] != K or cd["M"] != M or cd["N"] != N:
        raise ValueError(f"sgemm: inconsistent dims a={ad} b={bd} c={cd}")
    flops = 2.0 * M * N * K
    byts = float((M * K + K * N + M * N) * 4)

    if ctx.use_ref:
        def fn(a, b):
            return matmul_plain(a, b)
        info = "ref:plain matmul"
    elif tune.use_xla:
        def fn(a, b):
            from ...graph.lowering import lib_precision
            with lib_precision(tune.precision):
                return torch.matmul(a, b)
        info = "lib:torch.matmul (library path)"
    else:
        def fn(a, b):
            return matmul(a, b)
        if ctx.plain:
            info = "cuda:matmul (its plain version on the CPU)"
        else:
            sms = sm_count(torch.device(ctx.device))
            plan = plan_gemm(M, N, K, sms, torch_dtype(ad.tn))
            info = (f"cuda:matmul plan {plan.path} {plan.bm}x{plan.bn} split {plan.split}, "
                    f"{plan.ctas} blocks on {sms} SMs (per shape, "
                    f"ops/kernels/common.py:plan_gemm; tune bm/bn/bk unused)")

    return FuncInfo(name="", args=[("a", "in"), ("b", "in"), ("c", "out")],
                    fn=fn, flops=flops, bytes_accessed=byts, info=info + tune_note(tune),
                    in_dims=[ad, bd])
