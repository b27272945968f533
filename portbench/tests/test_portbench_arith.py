"""The metric arithmetic on synthetic data: a rate is all the work over the
whole window, a p95 is over all requests, the idle share comes from the
union of kernel intervals, kernels sort into their classes, and the
roofline and MFU readers divide what they should."""

import statistics

import pytest
import torch

from portbench import harness as H
from portbench import readers as R
from portbench import work as W
from portbench.run import run_cell


def test_p95_is_over_all_values():
    vals = [float(v) for v in range(1, 201)]
    assert H.p95(vals) == statistics.quantiles(vals, n=20)[18]
    assert 190 < H.p95(vals) < 191


def test_union_busy_and_gaps():
    busy, gaps = H.union_busy([(10, 20), (15, 30), (40, 50), (55, 70)], 0, 60)
    assert busy == 20 + 10 + 5
    assert gaps == [(0, 10), (30, 40), (50, 55)]
    busy, gaps = H.union_busy([], 0, 5)
    assert busy == 0 and gaps == [(0, 5)]


def _trace():
    kernels = [("void boda::gemm_wgmma<0, 2, 256, false, false>(CUtensorMap_st)", 0, 400),
               ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128", 400, 600),
               ("void at::native::vectorized_elementwise_kernel<4>", 700, 800),
               ("cudnn::bn_fw_tr_1C11_kernel_NCHW", 800, 900),
               ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 900, 950),
               ("void boda::eltwise_ring<8>(...)", 950, 1000)]
    return H.Trace(kernels, [("pb.window", 0, 1000), ("pb.wait", 600, 700)], (0, 1000), 2)


def test_kernel_classes():
    rules = H.kernel_rules()
    got = [H.kernel_class(n, rules) for n, _, _ in _trace().kernels]
    assert got == ["hand_conv", "library", "pytorch", "pytorch", "nccl", "hand_other"]


def test_idle_breakdown_and_classes():
    tr = _trace()
    reading = {"kind": "serve", "trace": tr}
    assert tr.window_s == pytest.approx(1e-3)
    assert R.idle(reading, "serve") == pytest.approx(10.0)     # 600..700 idle of 1000
    assert R.idle(reading, "train") is None                    # another cell's metric
    b = tr.breakdown()
    assert b["idle_gaps"] == [["pb.wait", pytest.approx(1e-4)]]
    assert b["device_ops"][0][1] == pytest.approx(4e-4) and len(b["device_ops"]) == 6
    assert R.class_ms(reading, "serve", "pytorch") == pytest.approx(0.2 / 2)


def test_conv_roofline_and_mfu():
    L = [dict(name="c", kind="conv", n=32, h=56, w=56, c=64, oc=64, k=3, stride=1, pad=1,
              dil=1, oh=56, ow=56, first=False)]
    tr = _trace()   # conv-class (hand_conv + library) 0.6 ms over 2 units
    reading = {"kind": "serve", "trace": tr, "layers": L, "training": False,
               "images_per_unit": 32, "rate_img_s": 1000.0}
    bound_ms = W.roofline_s(L, False) * 1e3
    assert R.conv_roofline(reading, "serve") == pytest.approx(100 * bound_ms / 0.3)
    flops_img = 2 * 56 * 56 * 64 * 9 * 64
    assert R.mfu(reading, "serve") == pytest.approx(100 * flops_img * 1000 / W.BF16_OPS)
    reading["training"] = True
    assert W.model_flops(L, True) == 3 * W.model_flops(L, False)
    L[0]["first"] = True   # the input's conv needs no input gradient
    assert W.roofline_s(L, True) == pytest.approx(
        W.bound_s(L[0], "fwd") + W.bound_s(L[0], "wgrad"))


def test_readers_find_nothing_without_a_trace():
    reading = {"kind": "detect", "layers": [], "training": False, "images_per_unit": 4}
    assert R.conv_roofline(reading, "detect") is None
    assert R.idle(reading, "detect") is None
    assert R.head_ms(reading) is None


def test_rate_is_all_work_over_the_whole_window():
    """Every batch started in the window is finished and counted, and the
    window's time runs until the last has finished: the rate times the
    requested seconds never exceeds the work done."""
    ov = {"batch": 2, "pool": 2, "image_size": 64, "warm_batches": 1, "check_max": 2}
    res = run_cell("resnet50.serve_b32", 2**31 + 11, 0.4, False, dev=torch.device("cpu"),
                   overrides=ov)
    rate = res["metrics"]["serve_img_per_s"]["value"]
    assert res["attempted"] >= 1
    assert rate * 0.4 <= res["attempted"] * 2 + 1e-9
