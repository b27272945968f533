"""Static and dynamic int8 against boda_tpu, on the CPU: the golden
run_cnet_int8 (testdata/test_cmds.xml:62); every node of mini_resnet and
the trained shapesnet under int8, dynamic and static (boda_tpu's net_calib
sidecar), against boda_tpu's ``pallas`` engine; the int32 accumulators of a
3x3 conv, a strided 1x1 and the fc equal to boda_tpu's; the routes (a
per-op int8=0, the s2d-folded stem, grouped and dilated convs stay float);
the library GEMM's padding and the quantizers; net_calib against boda_tpu's;
and test_lmdb's int8 accuracy gate.

Gates: f32 every node comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|): the
two engines quantize the same values with the same divide, round and clip
and sum the int8 products exactly, so they differ only where the f32
epilogue (XLA may fuse its multiply-add) or an f32 op before a quantizer
rounds one ulp apart; no value on a rounding boundary moved a quant step on
these inputs. bf16 prob within 5e-2 and top-1 equal (a bf16 rounding moves
an activation across a quant boundary, which moves a downstream node by a
quant step: intermediate nodes differ by up to ~0.13 of their max, prob by
less than 5e-2)."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu.cli import main as jmain
from boda_tpu.config import make as jmake
from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
from boda_tpu.graph import lowering_nhwc as jlow
from boda_tpu.graph.lowering import LowerCtx as JLowerCtx
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.ops.kernels.gen_data import gen_data_pattern as jgen
from boda_tpu.ops.tune import OpTune as JOpTune
from boda_tpu.prof import calib as jcalib
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu_torch import cli
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt as tfrom
from boda_tpu_torch.graph import lowering_nhwc as tlow
from boda_tpu_torch.graph.lowering import LowerCtx as TLowerCtx
from boda_tpu_torch.models.zoo import NetBuilder, build_model as tbuild
from boda_tpu_torch.ops import int8 as q8
from boda_tpu_torch.ops.tune import OpTune as TOpTune
from boda_tpu_torch.prof import calib as tcalib
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu_torch.utils.lexp import parse_lexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
NETS = os.path.join(TD, "nets")
BF16_TOL = 5e-2


@pytest.fixture(scope="module")
def calibs(tmp_path_factory):
    """boda_tpu's net_calib sidecars: mini_resnet on synthetic batches (as
    tests/test_int8.py makes it), shapesnet on its train records."""
    d = tmp_path_factory.mktemp("calib")
    out = {"mini_resnet": str(d / "mini.calib.json"), "shapesnet": str(d / "shapes.calib.json")}
    assert jmain(["net_calib", "--model=mini_resnet", "--img=4", "--batches=3",
                  f"--out-fn={out['mini_resnet']}"]) == 0
    assert jmain(["net_calib", f"--ptt-fn={NETS}/shapesnet.prototxt",
                  f"--weights-fn={NETS}/shapesnet.caffemodel",
                  f"--lmdb-fn={TD}/lmdb/shapes_train.rec", "--img=8",
                  f"--out-fn={out['shapesnet']}"]) == 0
    return out


def _pipes(net):
    if net == "mini_resnet":
        return jbuild(net, img=4), tbuild(net, img=4)
    ptt, cm = f"{NETS}/{net}.prototxt", f"{NETS}/{net}.caffemodel"
    return jfrom(ptt, cm), tfrom(ptt, cm)


def _nodes(pipe):
    return [n for n, node in pipe.nodes.items()
            if node.dims is not None and n not in pipe.weights and node.top_for]


def test_run_cnet_int8_golden():
    """run_cnet_int8 on the port: the `out prob` line as the golden's, the
    set of int8 lowering lines as the golden's, the dynamic info line word
    for word; the stderr notice names no TPU number."""
    with open(os.path.join(TD, "good_tr", "run_cnet_int8", "test_out.txt")) as f:
        golden = f.read().splitlines()
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        assert cli.main(["run_cnet", "--model=mini_resnet", "--img=2",
                         "--conv-fwd=(mode=cuda,int8=1,device=cpu)"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0] == golden[0]
    assert golden[1] in lines
    q8_lines = {ln for ln in lines if "nhwc-int8_conv" in ln or "nhwc-ip int8" in ln}
    assert q8_lines == set(golden[2:])
    assert "DYNAMIC" in err.getvalue() and "v5e" not in err.getvalue()


def test_int8_matches_boda_tpu(calibs):
    """Every node, int8 dynamic and static, f32 and bf16, the port on the
    CPU against boda_tpu's engine on the same pipe, weights and input; the
    static scales saturate values past a shrunk calibration as boda_tpu's."""
    for net in ("mini_resnet", "shapesnet"):
        _int8_case(calibs, net)


def _int8_case(calibs, net):
    shrunk = calibs[net].replace(".json", ".shrunk.json")
    rec = json.load(open(calibs[net]))
    rec["amax"] = {k: v * 0.25 for k, v in rec["amax"].items()}
    json.dump(rec, open(shrunk, "w"))
    for kw in ({"int8": "1"}, {"int8": "1", "calib_fn": calibs[net]},
               {"int8": "1", "calib_fn": shrunk}):
        for ctn in ("", "bfloat16"):
            (jp, jd), (tp, td) = _pipes(net)
            d = jd["data"]
            x = np.array(jgen(d.shape, d.tn))
            nodes = _nodes(jp)
            je = jmake("conv_fwd", "pallas", kernel_policy="gen", compute_tn=ctn, **kw)
            je.init(jp)
            jr = je.run_fwd({"data": JNDA(d, x)}, nodes)
            with redirect_stderr(io.StringIO()):
                te = tmake("conv_fwd", "cuda", device="cpu", compute_tn=ctn, **kw)
                te.init(tp)
            tr = te.run_fwd({"data": TNDA(td["data"], x)}, nodes)
            assert te.get_info_log().count("nhwc-int8_conv") > 0
            assert ("static_amax" in te.get_info_log()) == ("calib_fn" in kw)
            for n in nodes if not ctn else ["prob"]:
                a, b = jr[n].data, tr[n].data
                if ctn:
                    err = float(np.abs(a - b).max())
                    assert err <= BF16_TOL, (kw, n, err)
                    assert np.array_equal(a.reshape(len(a), -1).argmax(1),
                                          b.reshape(len(b), -1).argmax(1)), (kw, n)
                else:
                    r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
                    assert r.ok() and r.num_diff == 0, (kw, n, str(r))
            assert np.isfinite(tr["prob"].data).all()


def test_int32_accumulators_equal_boda_tpu(monkeypatch):
    """mini_resnet's first conv (3x3), its first strided 1x1 and its fc,
    each op's int8 lowering called alone in both packages on the same
    inputs: the int32 accumulators are equal, element for element."""
    (jp, _), (tp, _) = jbuild("mini_resnet", img=2), tbuild("mini_resnet", img=2)
    rng = np.random.RandomState(4)
    jacc, tacc = [], []
    for name in ("conv1", "s2b0_sc", "fc"):
        jop, top = jp.ops[name], tp.ops[name]
        xd = jp.must_dims(jop.bots[0])
        x = (rng.randn(xd["img"], xd["y"], xd["x"], xd["chan"]) if "y" in xd.names
             else rng.randn(*xd.shape)).astype(np.float32) * 3
        w, b = jp.weights[jop.bots[1]].data, jp.weights[jop.bots[2]].data
        jfn, jpre = jlow.lower_op_nhwc(jp, jop, JLowerCtx(), JOpTune(int8=True), [])
        tfn, tpre = tlow.lower_op_nhwc(tp, top, TLowerCtx(), TOpTune(int8=True), [])
        jw = jpre[jop.bots[1]][0](np.asarray(w)) if jop.bots[1] in jpre else np.asarray(w)
        tw = tpre[top.bots[1]].prep(torch.from_numpy(w))
        import jax.numpy as jnp
        from jax import lax
        orig_conv, orig_dot = lax.conv_general_dilated, jnp.dot

        def rec_conv(*a, **k):
            out = orig_conv(*a, **k)
            jacc.append(np.asarray(out))
            return out

        def rec_dot(*a, **k):
            out = orig_dot(*a, **k)
            if k.get("preferred_element_type") == jnp.int32:
                jacc.append(np.asarray(out))
            return out
        orig_mm = q8.int8_mm
        monkeypatch.setattr(jlow.lax, "conv_general_dilated", rec_conv)
        monkeypatch.setattr(jlow.jnp, "dot", rec_dot)
        monkeypatch.setattr(q8, "int8_mm", lambda *a: tacc.append(orig_mm(*a).numpy()) or
                            torch.from_numpy(tacc[-1]))
        jfn(jnp.asarray(x), jw, jnp.asarray(b))
        tfn(torch.from_numpy(x), tw, torch.from_numpy(b))
        monkeypatch.undo()
    assert len(jacc) == len(tacc) == 3
    for name, a, b in zip(("conv1", "s2b0_sc", "fc"), jacc, tacc):
        assert a.dtype == b.dtype == np.int32, name
        assert np.array_equal(a.reshape(-1, a.shape[-1]), b), name
        assert np.abs(a).max() > 1000, name  # the sums are not trivial


def test_int8_routes(calibs):
    """A per-op int8=0 keeps that conv float; with input_s2d the folded stem
    stays on its stem_s2d rule while the rest goes int8; with fuse_block the
    bottlenecks stay on their kernel; grouped and dilated convs stay float;
    int8 is in the fingerprint and the capture key; the int8 knob parses
    and keeps boda_tpu's key."""
    pipe, dims = tbuild("mini_resnet", img=2)
    e = tmake("conv_fwd", "cuda", device="cpu", int8="1", calib_fn=calibs["mini_resnet"],
              per_op_tune={"conv1": parse_lexp("(int8=0)")})
    e.init(pipe)
    log = e.get_info_log()
    assert "conv1: nhwc-int8_conv" not in log and "s1b0_c1: nhwc-int8_conv" in log
    plain = tmake("conv_fwd", "cuda", device="cpu")
    plain.init(pipe)
    assert e.fusion_fingerprint() != plain.fusion_fingerprint()
    assert e._graph_key({}, ["prob"]) != plain._graph_key({}, ["prob"])
    # the s2d-folded stem under engine-wide int8 (tests/test_int8.py:103)
    rp, rd = tbuild("resnet50", img=1, in_sz=64)
    e = tmake("conv_fwd", "cuda", device="cpu", int8="1", input_s2d=True)
    with redirect_stderr(io.StringIO()):
        e.init(rp)
    log = e.get_info_log()
    assert "conv1: nhwc-stem_s2d" in log and "conv1: nhwc-int8_conv" not in log
    assert "res2a_branch2a: nhwc-int8_conv" in log and "fc1000: nhwc-ip int8" in log
    x = np.random.RandomState(7).randn(*rd["data"].shape).astype(np.float32)
    xf = e.host_input_s2d("data", np.ascontiguousarray(x.transpose(0, 2, 3, 1)))
    got = e.run_fwd({"data": TNDA(TDims.of(img=1, y=xf.shape[1], x=xf.shape[2],
                                           chan=xf.shape[3]), xf)}, ["fc1000"])["fc1000"].data
    plain_fc = tmake("conv_fwd", "cuda", device="cpu")
    plain_fc.init(rp)
    ref = plain_fc.run_fwd({"data": TNDA(rd["data"], x)}, ["fc1000"])["fc1000"].data
    assert got.argmax() == ref.argmax()
    assert np.abs(got - ref).max() <= 0.1 * np.abs(ref).max()
    # fuse_block under int8, as boda_tpu: the identity bottlenecks stay on
    # the (float) bottleneck kernel, the other convs and the fc go int8
    e = tmake("conv_fwd", "cuda", device="cpu", int8="1", fuse_block=True)
    with redirect_stderr(io.StringIO()):
        e.init(rp)
    log = e.get_info_log()
    assert log.count("block-fused bottleneck") == 12 and "res2a_branch2a: nhwc-int8_conv" in log
    got = e.run_fwd({"data": TNDA(rd["data"], x)}, ["fc1000"])["fc1000"].data
    assert got.argmax() == ref.argmax()
    # grouped and dilated convs are not the int8 rule's
    b = NetBuilder("gd")
    t = b.conv("g", b.input("data"), 8, 3, pad=1, groups=2, in_chans=4)
    b.conv("dl", t, 8, 3, pad=2, dilation=2, in_chans=8)
    gp = b.done({"data": TDims.of(img=1, chan=4, y=9, x=9)})
    e = tmake("conv_fwd", "cuda", device="cpu", int8="1")
    with redirect_stderr(io.StringIO()):
        e.init(gp)
    assert "nhwc-int8_conv" not in e.get_info_log()
    assert TOpTune.parse("(int8=1)").key() == JOpTune.parse("(int8=1)").key()


def test_int8_mm_and_quantizers():
    """The library GEMM's zero padding at the shapes cuBLASLt refuses (17
    rows and fewer, K = 147, N % 8 != 0) against the exact product; the
    quantizers' divide, round half to even and clip, and the weight scales,
    against numpy; the weights quantized once per tensor; the patch matrix
    against F.unfold."""
    rng = np.random.RandomState(0)
    for m, k, n in ((2, 64, 16), (16, 147, 64), (40, 147, 5), (17, 24, 1001)):
        a = rng.randint(-127, 128, (m, k)).astype(np.int8)
        b = rng.randint(-127, 128, (k, n)).astype(np.int8)
        got = q8.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64))
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 300.0, -300.0, 127.4])
    xq, _ = q8.quant_act(x, q8.const(1.0, "cpu"), q8.const(127.0, "cpu"))
    assert xq.tolist() == [0, 2, 2, 0, -2, 127, -127, 127]
    xq, xs = q8.quant_act(x, None, q8.const(127.0, "cpu"))
    assert float(xs) == np.float32(np.float32(300.0) / np.float32(127.0))
    assert xq.tolist() == np.round(x.numpy() / np.float32(xs)).astype(np.int8).tolist()
    w = torch.from_numpy(rng.randn(3, 3, 5, 7).astype(np.float32))
    cache = q8.weight_cache()
    wq, ws = q8.quant_weight(w, (0, 1, 2), cache)
    wn = w.numpy()
    ws_n = np.maximum(np.abs(wn).max(axis=(0, 1, 2)), np.float32(1e-12)) / np.float32(127)
    assert np.array_equal(ws.numpy(), ws_n)
    assert wq.shape == (48, 8) and np.array_equal(
        wq[:45, :7].numpy(), np.round(wn / ws_n).astype(np.int8).reshape(45, 7))
    assert not wq[45:].any() and not wq[:, 7:].any()
    assert q8.quant_weight(w, (0, 1, 2), cache)[0] is wq  # once per tensor
    assert q8.quant_weight(w, (0, 1, 2))[0] is not wq
    xq = torch.from_numpy(rng.randint(-127, 128, (2, 6, 5, 3)).astype(np.int8))
    cols, (n_, oh, ow) = q8.patches(xq, (3, 2), (2, 1), (1, 0))
    ref = torch.nn.functional.unfold(xq.permute(0, 3, 1, 2).float(), (3, 2), padding=(1, 0),
                                     stride=(2, 1))  # (n, c*kh*kw, L)
    ref = ref.reshape(2, 3, 3, 2, -1).permute(0, 4, 2, 3, 1).reshape(-1, 18)
    assert (n_, oh, ow) == (2, 3, 4) and torch.equal(cols.float(), ref)


def test_net_calib_matches_boda_tpu(tmp_path, calibs):
    """net_calib on the port (CPU engine, f32) writes boda_tpu's node set
    with amax within 1e-5 rel, on shapesnet's train records and on
    mini_resnet's synthetic batches; the sidecars of testdata/calib read as
    boda_tpu reads them, and every node of resnet50's is in the port's
    resnet50 pipe; write_calib writes boda_tpu's bytes."""
    for name, args in (("shapes", [f"--ptt-fn={NETS}/shapesnet.prototxt",
                                   f"--weights-fn={NETS}/shapesnet.caffemodel",
                                   f"--lmdb-fn={TD}/lmdb/shapes_train.rec", "--img=8"]),
                       ("mini", ["--model=mini_resnet", "--img=4", "--batches=3"])):
        fns = {p: str(tmp_path / f"{name}.{p}.json") for p in ("j", "t")}
        assert jmain(["net_calib", "--compute-tn=", f"--out-fn={fns['j']}"] + args) == 0
        with redirect_stdout(io.StringIO()):
            assert cli.main(["net_calib", "--compute-tn=", "--device=cpu",
                             f"--out-fn={fns['t']}"] + args) == 0
        ja, ta = jcalib.read_calib(fns["j"]), tcalib.read_calib(fns["t"])
        assert sorted(ja) == sorted(ta) and len(ta) > 3, name
        for k, v in ja.items():
            assert abs(ta[k] - v) <= 1e-5 * max(abs(v), 1e-30), (name, k, v, ta[k])
    for fn in sorted(os.listdir(os.path.join(TD, "calib"))):
        p = os.path.join(TD, "calib", fn)
        assert tcalib.read_calib(p) == jcalib.read_calib(p)
    pipe, _ = tbuild("resnet50", img=1)
    amax = tcalib.read_calib(os.path.join(TD, "calib", "resnet50-bf16.calib.json"))
    assert len(amax) > 50 and not sorted(n for n in amax if n not in pipe.nodes)
    for mod, fn in ((tcalib, "t.json"), (jcalib, "j.json")):
        mod.write_calib(str(tmp_path / fn), "n", {"b": 2.0, "a": 1.5}, batches=3,
                        compute_tn="bfloat16")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()


_HYGIENE = """
import sys
from boda_tpu_torch import cli
assert cli.main(["net_calib", "--model=mini_resnet", "--img=4", "--device=cpu",
                 "--lmdb-fn=testdata/lmdb/cifar_mini.rec", "--out-fn=%(calib)s"]) == 0
for eng in ("(mode=cuda,device=cpu)", "(mode=cuda,device=cpu,int8=1,calib_fn=%(calib)s)",
            "(mode=cuda,device=cpu,int8=1)"):
    assert cli.main(["test_lmdb", "--rec-fn=testdata/lmdb/cifar_mini.rec",
                     "--model=mini_resnet", "--img=4", "--conv-fwd=" + eng]) == 0
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "boda_tpu")]
print("BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_int8_lmdb_accuracy_gate(tmp_path):
    """test_lmdb's top-1/top-5 equal between f32 and int8, dynamic
    (tests/test_int8.py:55's gate) and static (net_calib on the same
    records), on cifar_mini, run as a user runs it, in a process that
    imports no JAX."""
    code = _HYGIENE % {"calib": str(tmp_path / "mini.calib.json")}
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    tops = [ln for ln in r.stdout.splitlines() if ln.startswith("test_lmdb:")]
    assert len(tops) == 3 and len(set(tops)) == 1, tops
    assert "BAD []" in r.stdout
