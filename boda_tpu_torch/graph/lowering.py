"""Shared lowering context and helpers for the NHWC op rules.

Counterpart of the parts of ``boda_tpu/graph/lowering.py`` that the NHWC
engine uses: ``LowerCtx``, the precision names and ``_softmax``. The NCHW
per-op rules of that module are not ported (the port runs channels-last
only).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .pipe import PipeError

# boda_tpu's precision names, with the float32 matmul precision torch calls
# the same thing: 'default' = bf16 inputs, 'high' = TF32-class, 'highest' =
# full f32. The hand kernels run full f32 for f32 operands and bf16 inputs
# with an f32 accumulator for bf16 operands.
PRECISIONS = {"default": "medium", "high": "high", "highest": "highest"}


@dataclass(frozen=True)
class LowerCtx:
    precision: str = "highest"     # matmul/conv pass precision
    compute_tn: str = ""           # '' = keep input dtype; else cast for compute

    def __post_init__(self):
        if self.precision not in PRECISIONS:
            raise PipeError(f"unknown precision {self.precision!r}; "
                            f"have {sorted(PRECISIONS)}")


def _softmax(x: torch.Tensor, axis: int = 1) -> torch.Tensor:
    x32 = x.float()
    m = torch.amax(x32, dim=axis, keepdim=True)
    e = torch.exp(x32 - m)
    return e / torch.sum(e, dim=axis, keepdim=True)
