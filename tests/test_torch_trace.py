"""net_trace and train_trace on the CPU, and the per-op profiler ranges.

The attribution (modes/net_trace.py:attribute) on a hand-made trace with
the card's events (kernels joined to their launches by correlation id or
external id, a backward kernel on autograd's thread, a '/' op name inside
an outer range); both modes through the CLI with ``device=cpu``, where every
run op has a row and the rows sum to the trace's top-level host time; and
the ranges themselves: none entered outside a profiler, and forwards and a
training step bit-equal with and without one.
"""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu_torch import cli
from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
from boda_tpu_torch.modes.net_trace import attribute, load_trace

CPU = "--device=cpu"


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _ev(cat, name, tid, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def test_attribute_card_events():
    """Kernels go to the innermost range open at their launch: through the
    runtime call's correlation id, else the kernel's external id; a '/' op
    name inside an outer range whole; a backward kernel on another thread
    through its node's sequence number; no launch found -> (other)."""
    evs = [
        _ev("user_annotation", "conv1/7x7_s2", 1, 0.0, 100.0),
        _ev("cpu_op", "aten::convolution", 1, 20.0, 10.0, **{"Sequence number": 5,
                                                              "Fwd thread id": 0}),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 40.0, 5.0, correlation=1),
        _ev("user_annotation", "block", 1, 150.0, 200.0),
        _ev("user_annotation", "inception_3a/3x3", 1, 200.0, 100.0),
        _ev("cpu_op", "aten::mm", 1, 210.0, 20.0, **{"External id": 7}),
        _ev("user_annotation", "__update__", 1, 600.0, 50.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1, 610.0, 5.0, correlation=3),
        _ev("cpu_op", "autograd::engine::evaluate_function: ConvolutionBackward0", 2,
            500.0, 50.0, **{"Sequence number": 5, "Fwd thread id": 1}),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 2, 510.0, 5.0, correlation=2),
        _ev("kernel", "gemm_wgmma<1, 2, 128>", 7, 1000.0, 50.0, correlation=1),
        _ev("kernel", "gemm_wgmma<0, 2, 128>", 7, 1100.0, 30.0, correlation=99,
            **{"External id": 7}),
        _ev("kernel", "atb_bf16", 7, 1200.0, 40.0, correlation=2),
        _ev("kernel", "vectorized_elementwise", 7, 1300.0, 10.0, correlation=3),
        _ev("kernel", "lost", 7, 1400.0, 10.0, correlation=100),
    ]
    ops = {"conv1/7x7_s2", "inception_3a/3x3", "inception_3a"}
    um = {}
    per, n, on_dev = attribute(evs, ops, unmapped=um)
    assert on_dev and n == 4
    assert per == {"conv1/7x7_s2": 90.0, "inception_3a/3x3": 30.0, "__update__": 10.0,
                   "(other)": 10.0}
    assert um == {"lost": 10.0}
    per, n, _ = attribute(evs, ops, train=True)
    assert per == {"conv1/7x7_s2 [fwd]": 50.0, "conv1/7x7_s2 [bwd]": 40.0,
                   "inception_3a/3x3 [fwd]": 30.0, "__update__": 10.0, "(other)": 10.0}


def _top_level_total(fn):
    """The host time of a trace's top-level ATen ops, summed by a sweep of
    its own: an op inside another op of its thread counts no time."""
    ops = sorted((e for e in load_trace(fn) if e.get("cat") == "cpu_op"),
                 key=lambda e: (e["tid"], e["ts"], -e["dur"]))
    tot, stack = 0.0, []
    for e in ops:
        while stack and (stack[-1]["tid"] != e["tid"] or
                         stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]):
            stack.pop()
        if not stack:
            tot += e["dur"]
        stack.append(e)
    return tot


def _rows(out, marker, per_what):
    """{row name: us} of a mode's table after the line holding ``marker``."""
    rows, on = {}, False
    for ln in out.splitlines():
        if marker in ln:
            on = True
            continue
        if on and f" us/{per_what}" in ln and ln.startswith("  "):
            name, rest = ln[2:30].strip(), ln[30:].split()
            rows[name] = float(rest[0])
        elif on and not ln.startswith("  "):
            break
    return rows


@pytest.mark.parametrize("net", ["mini_resnet", "googlenet_conv"])
def test_net_trace_on_cpu(net, tmp_path):
    """Every op the forward runs has a row (a fused chain under its head
    conv), googlenet's '/' names whole, and the rows sum to the trace's
    top-level host time."""
    img, in_sz = (2, 0) if net == "mini_resnet" else (1, 96)
    conv_fwd = "(mode=cuda,device=cpu)"
    rc, out = _run(["net_trace", f"--model={net}", f"--img={img}", f"--in-sz={in_sz}",
                    "--n-iters=2", "--per-op=1", "--top-k=0", f"--conv-fwd={conv_fwd}",
                    f"--boda-output-dir={tmp_path}"])
    assert rc == 0, out
    assert "host time, no card" in out.splitlines()[0]
    rows = _rows(out, "per-op host time over 2 forwards", "fwd")
    pipe, _ = load_net(net, img=img, in_sz=in_sz)
    eng = make("conv_fwd", "cuda", device="cpu")
    eng.init(pipe)
    # an inference Dropout passes its input on and runs no ATen op
    idle = {c for ch in eng._chains.values() for c in ch} | \
        {o for o, op in pipe.ops.items() if op.type == "Dropout"}
    assert set(pipe.ops) - idle <= set(rows), sorted(set(pipe.ops) - idle - set(rows))
    assert set(rows) - {"(other)"} <= set(pipe.ops)
    if net == "googlenet_conv":
        assert "inception_3a/3x3" in rows and "inception_3a" not in rows
    fn = os.path.join(tmp_path, "trace", f"{pipe.name}.pt.trace.json")
    assert sum(rows.values()) * 2 == pytest.approx(_top_level_total(fn), rel=1e-3)


@pytest.mark.parametrize("policy", ["gen", "lib"])
def test_train_trace_on_cpu(policy, tmp_path):
    """Each conv has a [fwd] and a [bwd] row, the update and the loss their
    rows, and the rollup sums to the trace's top-level host time."""
    rc, out = _run(["train_trace", "--model=mini_resnet", "--img=2", "--n-iters=2",
                    "--compute-tn=", f"--kernel-policy={policy}", CPU, "--top-k=0",
                    f"--boda-output-dir={tmp_path}"])
    assert rc == 0, out
    assert "host time, no card" in out.splitlines()[0]
    pipe, _ = load_net("mini_resnet", img=2)
    fn = os.path.join(tmp_path, "trace", "mini_resnet_train.pt.trace.json")
    per, _, on_dev = attribute(load_trace(fn), pipe.ops, train=True)
    assert not on_dev
    convs = [o for o, op in pipe.ops.items() if op.type == "Convolution"]
    for c in convs:
        assert per.get(f"{c} [fwd]", 0) > 0 and per.get(f"{c} [bwd]", 0) > 0, c
    assert per["__update__"] > 0 and per["__loss__ [fwd]"] > 0 and per["__loss__ [bwd]"] > 0
    assert sum(per.values()) == pytest.approx(_top_level_total(fn), rel=1e-3)
    fb = [ln.split() for ln in out.splitlines() if " bwd/fwd " in ln]
    assert {r[0] for r in fb} >= set(convs)


def _count_ranges(monkeypatch):
    """Spy on every profiler range entered: the count of entries."""
    seen = []
    rf = torch.autograd.profiler.record_function
    enter = rf.__enter__

    def spy(self):
        seen.append(self.name)
        return enter(self)
    monkeypatch.setattr(rf, "__enter__", spy)
    return seen


def _step_setup():
    from boda_tpu_torch.parallel.train import find_logits_node, make_train_step
    pipe, in_dims = load_net("mini_resnet", img=2)
    step = make_train_step(pipe, find_logits_node(pipe), lr=0.05, clip_norm=1.0, momentum=0.9,
                           bn_momentum=0.1, kernel_policy="gen")
    w = {k: torch.from_numpy(np.asarray(v.data, np.float32)) for k, v in pipe.weights.items()}
    x = torch.from_numpy(gen_data_inputs(in_dims)["data"].data)
    return step, w, x, torch.arange(2) % 16


def test_no_range_outside_a_trace(monkeypatch):
    """No profiler range is entered by a forward or a training step unless a
    profiler records; inside one, every op opens its range."""
    seen = _count_ranges(monkeypatch)
    pipe, in_dims = load_net("mini_resnet", img=2)
    eng = make("conv_fwd", "cuda", device="cpu")
    eng.init(pipe)
    ins = gen_data_inputs(in_dims)
    step, w, x, lab = _step_setup()
    eng.run_fwd(ins, ["prob"])
    step(w, {"data": x}, lab, None)
    assert seen == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.run_fwd(ins, ["prob"])
        step(w, {"data": x}, lab, None)
    assert "conv1" in seen and "s3b1_c2" in seen and "__loss__" in seen and \
        "__update__" in seen


def test_profiler_changes_no_result():
    """A forward and a training step give the same bits with and without a
    profiler recording."""
    pipe, in_dims = load_net("mini_resnet", img=2)
    eng = make("conv_fwd", "cuda", device="cpu")
    eng.init(pipe)
    ins = gen_data_inputs(in_dims)
    outs = ["prob", "s2b0_c1", "relu1"]
    step, w, x, lab = _step_setup()
    plain = (eng.run_fwd(ins, outs), step(w, {"data": x}, lab, None))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = (eng.run_fwd(ins, outs), step(w, {"data": x}, lab, None))
    for n in outs:
        assert np.array_equal(plain[0][n].data, traced[0][n].data), n
    (l0, w0, m0), (l1, w1, m1) = plain[1], traced[1]
    assert torch.equal(l0, l1)
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
