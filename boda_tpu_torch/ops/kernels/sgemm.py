"""GEMM with a fused bias(+residual)(+ReLU) store: the port of K1.

Counterpart of ``boda_tpu/ops/kernels/sgemm.py:pallas_matmul``. The CUDA
kernel is ``csrc/sgemm.cu`` (tiled mma.sync for bf16, FMA for f32, ragged
edges masked in the kernel, so nothing is padded in HBM). :func:`matmul`
launches it for CUDA tensors and runs :func:`matmul_plain` for CPU tensors;
there is no other fallback. :func:`gen_sgemm` is the rtc ``sgemm`` op.
"""

from __future__ import annotations

import torch

from ...rtc.compute import FuncInfo
from ..op_base import Op
from ..registry import GenCtx, kernel_gen, tune_note
from ..tune import OpTune
from . import build
from .common import check_operand, epilogue, kernel_dtype, ptr


def matmul_plain(a, b, bias=None, *, relu: bool = False, residual=None):
    """The plain PyTorch version: f32 ``torch.matmul`` plus the epilogue,
    output in a's dtype."""
    return epilogue(torch.matmul(a.float(), b.float()), bias, residual, relu,
                    a.dtype)


def matmul(a, b, bias=None, *, relu: bool = False, residual=None):
    """a[M,K] @ b[K,N] (+bias[N]) (+residual[M,N]) (+ReLU), f32 accumulate,
    output in a's dtype (float32 or bfloat16). Row-major operands."""
    if a.device.type == "cpu":
        return matmul_plain(a, b, bias, relu=relu, residual=residual)
    if a.device.type != "cuda":
        raise ValueError(f"matmul: no kernel for device {a.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: bad shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    M, K = a.shape
    N = b.shape[1]
    dt = kernel_dtype(a)
    check_operand("a", a, a.device, a.dtype, (M, K))
    check_operand("b", b, a.device, a.dtype, (K, N))
    if bias is not None:
        check_operand("bias", bias, a.device, a.dtype, (N,))
    if residual is not None:
        check_operand("residual", residual, a.device, a.dtype, (M, N))
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    kb = build.load()
    with torch.cuda.device(a.device):
        rc = kb.lib.boda_gemm(a.data_ptr(), b.data_ptr(), ptr(bias),
                              ptr(residual), out.data_ptr(), M, N, K, int(relu),
                              dt, build.stream_ptr(a))
    build.check(rc, "boda_gemm")
    matmul.launches += 1
    return out


matmul.launches = 0  # kernel launches (CPU plain-version calls do not count)


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
        info = (f"cuda:matmul tune bm={tune.bm} bn={tune.bn} bk={tune.bk}, unused: the "
                f"kernel's tiles are fixed at compile time (csrc/gemm.cuh)")

    return FuncInfo(name="", args=[("a", "in"), ("b", "in"), ("c", "out")],
                    fn=fn, flops=flops, bytes_accessed=byts, info=info + tune_note(tune),
                    in_dims=[ad, bd])
