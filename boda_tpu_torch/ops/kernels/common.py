"""Shared helpers for the kernel wrappers."""

from __future__ import annotations

import torch

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C side's dtype codes


def epilogue(acc: torch.Tensor, bias, residual, relu: bool, out_dtype):
    """The kernels' store epilogue on an f32 accumulator: +bias (+residual)
    (+ReLU), then cast (the order of sgemm.py:_matmul_bias_kernel)."""
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(out_dtype)


def check_operand(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    """What a launch needs of each operand: same card, same dtype, the shape
    the kernel indexes with, and dense row-major storage."""
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def kernel_dtype(t: torch.Tensor) -> int:
    code = KERNEL_DTYPES.get(t.dtype)
    if code is None:
        raise ValueError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()
