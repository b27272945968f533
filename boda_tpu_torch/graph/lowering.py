"""Shared lowering context and helpers for the NHWC op rules.

Counterpart of the parts of ``boda_tpu/graph/lowering.py`` that the NHWC
engine uses: ``LowerCtx`` (``train`` and ``det_drop_seed`` among its
fields), the precision names, ``_softmax`` and ``lrn_inv_pow``, plus
:func:`lib_precision`, which applies a precision to the library ops, and
:func:`jax_maximum`, ``jnp.maximum`` with JAX's gradient. The NCHW per-op
rules of that module are not ported (the port runs channels-last only).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Optional

import torch

from .pipe import PipeError

# boda_tpu's precision names, as torch's fp32_precision of the library's f32
# matmuls (cuBLAS) and convs (cuDNN): 'highest' = full f32 ("ieee"); 'high'
# and 'default' = TF32 (on a GPU, XLA's default f32 dot is TF32 as well).
# The hand kernels run full f32 for f32 operands and bf16 inputs with an f32
# accumulator for bf16 operands, whatever the precision.
PRECISIONS = {"default": "tf32", "high": "tf32", "highest": "ieee"}


@contextlib.contextmanager
def lib_precision(precision: str):
    """Run the library's f32 matmuls and convs at ``precision``, then restore
    the previous settings. Only the ``fp32_precision`` settings are touched:
    recent torch refuses a process that mixes them with the legacy
    ``allow_tf32`` flags. (cuDNN convs default to TF32, so without this an
    f32 lib conv at 'highest' would run TF32.)"""
    mm, cv = torch.backends.cuda.matmul, torch.backends.cudnn.conv
    old = (mm.fp32_precision, cv.fp32_precision)
    mm.fp32_precision = cv.fp32_precision = PRECISIONS[precision]
    try:
        yield
    finally:
        mm.fp32_precision, cv.fp32_precision = old


class _JaxMaximum(torch.autograd.Function):
    """max(a, b) whose gradient follows ``jnp.maximum`` (lax.max's
    ``_balanced_eq``): where a == b each side gets half the cotangent.
    torch.relu sends 0 there and torch.clamp_min 1, so a ReLU on exact
    zeros (a zero input, a dead channel) would differ from boda_tpu."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.maximum(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        ea, eb = (a == out).to(g.dtype), (b == out).to(g.dtype)
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = (g * ea / (1 + eb)).sum_to_size(a.shape)
        if ctx.needs_input_grad[1]:
            gb = (g * eb / (1 + ea)).sum_to_size(b.shape)
        return ga, gb


def jax_maximum(a: torch.Tensor, b) -> torch.Tensor:
    """``jnp.maximum(a, b)``: torch.maximum's value, JAX's gradient when
    autograd records (a plain max otherwise). ``b`` may be a Python float:
    it becomes a 0-dim tensor on the host, which a CUDA kernel takes as a
    scalar argument, so no host value is copied to the card (a copy that a
    CUDA-graph capture refuses)."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(b, dtype=a.dtype)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _JaxMaximum.apply(a, b)
    return torch.maximum(a, b)


@dataclass(frozen=True)
class LowerCtx:
    precision: str = "highest"     # matmul/conv pass precision
    compute_tn: str = ""           # '' = keep input dtype; else cast for compute
    # static int8 calibration: node name -> activation amax (prof/calib.py);
    # None = dynamic quantization (a per-tensor amax per forward)
    act_amax: Optional[dict] = None
    # act_int8's signed storage scales (node -> float): an int8 conv fed a
    # stored int8 input dequantizes with the engine's own storage scale
    act_store_scale: Optional[dict] = None
    device: str = "cpu"            # where the lowerings' constants live
    det_drop_seed: int = 0         # deterministic dropout seed
    train: bool = False            # training mode (dropout active)

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise PipeError(f"unknown precision {self.precision!r}; "
                            f"have {sorted(PRECISIONS)}")


def _softmax(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    x32 = x.float()
    m = torch.amax(x32, dim=axis, keepdim=True)
    e = torch.exp(x32 - m)
    return e / torch.sum(e, dim=axis, keepdim=True)


def lrn_inv_pow(scale: torch.Tensor, beta: float) -> torch.Tensor:
    """scale**(-beta) in boda_tpu's forms (lowering.py:271-285): beta = 0.75
    as rsqrt(s) * sqrt(rsqrt(s)) and beta = 0.5 as rsqrt(s), two root ops in
    place of the exp/log pow chain. Same math as pow; the forms are kept
    because they are the reference's rounding."""
    if beta == 0.75:
        t = torch.rsqrt(scale)
        return t * torch.sqrt(t)
    if beta == 0.5:
        return torch.rsqrt(scale)
    return torch.pow(scale, -beta)
