"""What the per-layer metric readers share: each reads the ``reading`` a
traffic driver leaves (its kind, the profiled ``trace``, the CUDA-event
timings, the spans, the reference's layer table and the window's rate) and
returns None where it finds nothing to read."""

from __future__ import annotations

from portbench import harness as H
from portbench import work as W

CONV_CLASSES = ("hand_conv", "library")


def conv_roofline(reading: dict, kind: str):
    """The summed roofline bound of one unit's conv and fc work over the
    device time of the conv-class kernels (hand and library) per unit, %."""
    tr = reading.get("conv_trace", reading.get("trace"))
    if reading["kind"] != kind or tr is None or not tr.units:
        return None
    cls = tr.class_ms(H.kernel_rules())
    ms = sum(cls.get(c, 0.0) for c in CONV_CLASSES) / tr.units
    if ms <= 0:
        return None
    return 100.0 * W.roofline_s(reading["layers"], reading["training"]) * 1e3 / ms


def mfu(reading: dict, kind: str):
    """Model FLOPs per image times the window's images per second over the
    bf16 peak of the cards used, %."""
    if reading["kind"] != kind or not reading.get("rate_img_s"):
        return None
    per_img = W.model_flops(reading["layers"], reading["training"]) / reading["images_per_unit"]
    return 100.0 * per_img * reading["rate_img_s"] / (W.BF16_OPS * reading.get("chips", 1))


def idle(reading: dict, kind: str):
    """1 - the union of device-kernel intervals over the profiled window, %."""
    tr = reading.get("trace")
    if reading["kind"] != kind or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy()[0] / tr.window_s)


def class_ms(reading: dict, kind: str, cls: str):
    """Device ms per unit in the kernels of one class."""
    tr = reading.get("trace")
    if reading["kind"] != kind or tr is None or not tr.units:
        return None
    return tr.class_ms(H.kernel_rules()).get(cls, 0.0) / tr.units


def timing(reading: dict, kind: str, key: str):
    return reading.get(key) if reading["kind"] == kind else None


def span_us(reading: dict, kind: str, names: tuple, per: str):
    """Host microseconds per ``per`` span in the spans ``names``."""
    sp = reading.get("spans")
    if reading["kind"] != kind or sp is None or not sp.count.get(per):
        return None
    return 1e6 * sum(sp.total.get(n, 0.0) for n in names) / sp.count[per]


def head_ms(reading: dict):
    if reading["kind"] != "detect" or reading.get("trunk_ms") is None:
        return None
    return reading["replay_ms"] - reading["trunk_ms"]
