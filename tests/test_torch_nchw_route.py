"""The ``pallas`` engine's NCHW route (ops/cnn_variants.py on K1 and K3)
against boda_tpu's ``PallasFwd`` with ``layout=nchw`` and
``kernel_policy=gen`` on the CPU: boda_tpu's Pallas kernels in interpret
mode, the port's kernel wrappers on their plain versions (the tensors lie
on the CPU). The same seeded inputs and weights, every node with
``comp_vars`` (f32 1e-5, no element over; gradient graphs 1e-3), and the
routing decisions and their info-log lines equal to boda_tpu's (as sets:
boda_tpu logs a chain head again for a fused lowering that its NCHW build
never runs). Also boda_tpu's own routing function on hand-built convs, the
Fields that the route refuses or ignores as boda_tpu does (act_int8, int8),
and ``batch_split`` on both layouts."""

import numpy as np
import pytest

from boda_tpu.config import ConfigError as JConfigError
from boda_tpu.config import make as jmake
from boda_tpu.graph.lowering import LowerCtx as JCtx
from boda_tpu.ops.cnn_variants import lower_op_pallas as j_route
from boda_tpu.ops.tune import OpTune as JTune
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu_torch.config import ConfigError
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.lowering import LowerCtx as TCtx
from boda_tpu_torch.graph.pipe import ConvOp as TOp
from boda_tpu_torch.graph.pipe import ConvPipe as TPipe
from boda_tpu_torch.ops import cnn_variants
from boda_tpu_torch.ops.kernels import conv as kconv
from boda_tpu_torch.ops.kernels import sgemm as ksgemm
from boda_tpu_torch.ops.tune import OpTune as TTune
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu.graph.pipe import ConvOp as JOp
from boda_tpu.graph.pipe import ConvPipe as JPipe
from boda_tpu.utils.dims import Dims as JDims
from test_torch_xla_engine import (NETS_, build_pair, gate, nodes_of, run_both,
                                   seeded_inputs)

NCHW_GEN = {"layout": "nchw", "kernel_policy": "gen"}


def route_lines(eng) -> set:
    return set(eng.get_info_log().splitlines())


@pytest.mark.parametrize("name", sorted(NETS_))
def test_nchw_route_matches_boda_tpu(name, monkeypatch):
    """Every node, and the routing lines; the K1 and K3 wrappers are
    called once per routed op."""
    calls = {"K1": 0, "K3": 0}
    for mod, fname, k in ((cnn_variants, "matmul", "K1"), (cnn_variants, "conv2d_nhwc", "K3")):
        real = getattr(mod, fname)

        def counted(*a, real=real, k=k, **kw):
            calls[k] += 1
            return real(*a, **kw)
        monkeypatch.setattr(mod, fname, counted)
    jp, jd, tp, td = build_pair(name)
    nodes = nodes_of(jp)
    je, jr, te, tr = run_both(jp, jd, tp, td, "pallas", seeded_inputs(jd), nodes, NCHW_GEN)
    gate(jr, tr, nodes)
    lines = route_lines(te)
    assert lines == route_lines(je)
    k1 = sum(": ipmatmul " in ln or ": k1conv " in ln for ln in lines)
    k3 = sum(": pallas_conv " in ln for ln in lines)
    assert calls == {"K1": k1, "K3": k3} and k1 + k3 > 0
    assert set(te._weight_preps) == {tp.ops[ln.split(":")[0]].bots[1] for ln in lines
                                     if ": ipmatmul " in ln or ": k1conv " in ln
                                     or ": pallas_conv " in ln}


def test_nchw_gradient_graphs_match_boda_tpu():
    """add_bck_ops under the NCHW route: the forward on K1/K3, each Bck the
    autograd of the logical rule on the filters turned back to OIHW, the
    filter gradients out in the logical layout."""
    for name in ("mini_resnet", "tinynet"):
        jp, jd, tp, td = build_pair(name, bck=True)
        nodes = nodes_of(jp)
        _, jr, te, tr = run_both(jp, jd, tp, td, "pallas", seeded_inputs(jd), nodes, NCHW_GEN)
        gate(jr, tr, nodes, 1e-3, exact_count=False)
        assert te._weight_preps


def _conv_pipe(Pipe, Op, Dims, NDA, case):
    """One conv (or fc) in a pipe: (in_chan, hw, out_chan, k, stride, pad,
    groups, dilation) or 'ip'."""
    p = Pipe("one")
    if case == "ip":
        p.weights["w"] = NDA(Dims.of(out_chan=10, in_feats=48), np.ones((10, 48), np.float32))
        p.weights["b"] = NDA(Dims.of(out_chan=10), np.zeros(10, np.float32))
        p.add_op(Op("op", "InnerProduct", {}, ["x", "w", "b"], ["y"]))
        p.calc_dims({"x": Dims.of(img=2, chan=3, y=4, x=4)})
        return p
    c, hw, oc, k, s, pad, g, dil = case
    p.weights["w"] = NDA(Dims.of(out_chan=oc, in_chan=c // g, y=k, x=k),
                         np.ones((oc, c // g, k, k), np.float32))
    p.weights["b"] = NDA(Dims.of(out_chan=oc), np.zeros(oc, np.float32))
    params = {"kern_sz": (k, k), "stride": (s, s), "pad": (pad, pad), "groups": g}
    if dil != 1:
        params["dilation"] = (dil, dil)
    p.add_op(Op("op", "Convolution", params, ["x", "w", "b"], ["y"]))
    p.calc_dims({"x": Dims.of(img=2, chan=c, y=hw, x=hw)})
    return p


def test_routing_decisions_match_boda_tpu():
    """boda_tpu's lower_op_pallas and the port's on the same ops and tunes:
    the same route and line, but for a dilated conv, which boda_tpu sends
    to its undilated Pallas conv and the port to the logical rule; the
    engine's act_int8 refusal, int8 as boda_tpu's (no effect), and layout's
    values."""
    cases = {"ip": "ipmatmul", (64, 8, 32, 1, 1, 0, 1, 1): "k1conv",
             (64, 8, 32, 1, 2, 0, 1, 1): "k1conv", (64, 8, 32, 3, 1, 1, 1, 1): "pallas_conv",
             (64, 8, 64, 3, 2, 1, 1, 1): "strided conv -> xla",
             (64, 8, 64, 3, 1, 1, 2, 1): "grouped conv -> xla",
             (96, 28, 64, 3, 1, 1, 1, 1): "doesn't fit pallas blocking -> xla",
             (256, 7, 256, 3, 1, 1, 1, 1): "pallas_conv", (3, 9, 16, 3, 1, 0, 1, 1): "xla"}
    for case, want in cases.items():
        for tune in ("", "use_xla"):
            jlog, tlog = [], []
            jp = _conv_pipe(JPipe, JOp, JDims, JNDA, case)
            tp = _conv_pipe(TPipe, TOp, TDims, TNDA, case)
            jt, tt = JTune(use_xla=bool(tune)), TTune(use_xla=bool(tune))
            jr = j_route(jp, jp.ops["op"], JCtx(), jt, jlog)
            tr = cnn_variants.lower_op_pallas(tp, tp.ops["op"], TCtx(), tt, tlog)
            assert (jr is None) == (tr is None) and jlog == tlog, (case, jlog, tlog)
            assert tune or want in (jlog[0] if jlog else "xla"), (case, jlog)
    dil = (64, 8, 32, 3, 1, 2, 1, 2)
    jlog, tlog = [], []
    jp, tp = _conv_pipe(JPipe, JOp, JDims, JNDA, dil), _conv_pipe(TPipe, TOp, TDims, TNDA, dil)
    assert j_route(jp, jp.ops["op"], JCtx(), JTune(), jlog) is not None
    assert cnn_variants.lower_op_pallas(tp, tp.ops["op"], TCtx(), TTune(), tlog) is None
    assert jlog[0].startswith("op: pallas_conv") and tlog == ["op: dilated conv -> xla"]
    # the engine: act_int8 refuses nchw as boda_tpu's; int8 computes as int8=0
    pipe, dims = build_pair("mini_resnet")[2:]
    for mk, err, extra in ((jmake, JConfigError, {}), (tmake, ConfigError, {"platform": "cpu"})):
        e = mk("conv_fwd", "pallas", layout="nchw", act_int8=["*"], **extra)
        with pytest.raises(err, match="act_int8 requires the NHWC engine layout"):
            e.init(build_pair("mini_resnet")[0 if mk is jmake else 2])
    ins = {"data": TNDA(dims["data"], seeded_inputs(dims)["data"])}
    outs = []
    for int8 in (False, True):
        e = tmake("conv_fwd", "pallas", platform="cpu", int8=int8, **NCHW_GEN)
        e.init(pipe)
        outs.append(e.run_fwd(ins, ["prob"])["prob"].data)
    assert np.array_equal(outs[0], outs[1])
    with pytest.raises(ConfigError, match="layout 'nchwc'"):
        tmake("conv_fwd", "pallas", platform="cpu", layout="nchwc")


def test_batch_split_on_both_layouts():
    """Regions run in k img chunks: bit-equal to no split under NHWC, gen
    and lib; under NCHW within 1e-5, since the CPU's library conv and
    matmul (the logical rules', and the plain versions' under gen) may
    block a smaller batch otherwise. A region with a requested output
    inside does not apply. The errors are boda_tpu's, word for word."""
    from boda_tpu.models.zoo import build_model as jbuild
    from boda_tpu_torch.models.zoo import build_model as tbuild
    tp, td = tbuild("mini_resnet", img=4)
    ins = {"data": TNDA(td["data"], seeded_inputs(td)["data"])}
    specs = ["data:s1b0_relu:2", "s1b0_relu:s2b1_relu:4", "s3b1_relu:fc:2"]
    for layout in ("nhwc", "nchw"):
        for policy in ("gen", "lib"):
            kw = dict(platform="cpu", layout=layout, kernel_policy=policy)
            ref = tmake("conv_fwd", "pallas", **kw)
            ref.init(tp)
            want = ref.run_fwd(ins, ["s2b1_relu", "prob"])
            e = tmake("conv_fwd", "pallas", batch_split=specs, **kw)
            e.init(tp)
            got = e.run_fwd(ins, ["s2b1_relu", "prob"])
            assert e._bs_applied == [("data", "s1b0_relu"), ("s1b0_relu", "s2b1_relu"),
                                     ("s3b1_relu", "fc")]
            for n in want:
                if layout == "nchw":
                    gate(want, got, [n])
                else:
                    assert np.array_equal(want[n].data, got[n].data), (layout, policy, n)
            e.run_fwd(ins, ["s1b1_relu", "prob"])  # inside the first region
            assert e._bs_applied == [("data", "s1b0_relu"), ("s3b1_relu", "fc")]
    jp, jd = jbuild("mini_resnet", img=4)
    for spec in ("data:fc", "data:s2b1_c1:2", "s1b0_r1:fc:2", "data:fc:3"):
        msgs = []
        for mk, pipe, dims, nda, extra in ((jmake, jp, jd, JNDA, {}),
                                           (tmake, tp, td, TNDA, {"platform": "cpu"})):
            e = mk("conv_fwd", "pallas", batch_split=[spec], **extra)
            e.init(pipe)
            with pytest.raises(Exception) as ei:
                e.run_fwd({"data": nda(dims["data"], ins["data"].data)}, ["prob"])
            msgs.append((type(ei.value).__name__, str(ei.value)))
        assert msgs[0] == msgs[1], msgs
    # the kernel wrappers' counters do not tick on the CPU
    assert ksgemm.matmul.launches == 0 and kconv.conv2d_nhwc.launches == 0
