"""Operations and bytes of the conv and fc work, and the chip's peaks.

The arithmetic is frozen from chip_smoke.py:762 (``work``): each input read
once and each output written once, in bfloat16 (2 bytes); operations at
the bf16 tensor-core rate. Two changes: the shapes come from the reference's
own layer table (``reference/<model>.layers``), so the counts are the same
work whatever implements it, with dilation and non-square strides taken
from the table; and a backward pass counts what the algorithm needs: the
input gradient has the forward's operations at any stride (not n*h*h's),
the first conv has none, and the weight gradient is written in the
gradient's own dtype.
"""

from __future__ import annotations

BF16_OPS = 989e12   # dense bf16 tensor-core FLOP/s, H100 SXM at 700 W
HBM_BPS = 3.35e12   # HBM3 bytes/s, H100 SXM
ES = 2              # bytes per bf16 element


def conv_ops(L: dict) -> float:
    """Multiply-adds x 2 of one forward conv or fc of the layer table."""
    return 2.0 * L["n"] * L["oh"] * L["ow"] * L["oc"] * L["k"] * L["k"] * L["c"]


def _bytes(L: dict, part: str) -> float:
    x = L["n"] * L["h"] * L["w"] * L["c"]
    y = L["n"] * L["oh"] * L["ow"] * L["oc"]
    w = L["k"] * L["k"] * L["c"] * L["oc"]
    if part == "fwd":
        return ES * (x + w + L["oc"] + y)
    if part == "dgrad":
        return ES * (y + w + x)
    if part == "wgrad":
        return ES * (x + y + w)
    raise KeyError(part)


def bound_s(L: dict, part: str) -> float:
    """The least time of one layer's pass: operations at peak or bytes at
    peak bandwidth, whichever is longer."""
    return max(conv_ops(L) / BF16_OPS, _bytes(L, part) / HBM_BPS)


def passes(training: bool) -> tuple:
    return ("fwd", "dgrad", "wgrad") if training else ("fwd",)


def roofline_s(layers: list, training: bool) -> float:
    """Summed least time of the conv and fc work of one forward (serving) or
    one training step (forward, input gradient, weight gradient)."""
    return sum(bound_s(L, p) for L in layers for p in passes(training)
               if not (p == "dgrad" and L["first"]))


def model_flops(layers: list, training: bool) -> float:
    """The conv and fc FLOPs of one forward (x3 for a training step: the
    forward, the input and the weight gradient), the model-FLOPs count of
    MFU."""
    return sum(conv_ops(L) for L in layers) * (3 if training else 1)
