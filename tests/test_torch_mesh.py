"""The port's meshes (boda_tpu_torch/parallel/mesh.py) and its engine under a
mesh against boda_tpu's, on the CPU.

boda_tpu's side runs on the 8 virtual CPU devices of tests/conftest.py; the
port's ``make_mesh(..., kind="cpu")`` reads the same XLA_FLAGS count, and
its engine (``device=cpu``, the kernels' plain versions) places every shard
on the CPU. Gates: the split axis of every weight and input equal to
boda_tpu's PartitionSpec entries; every node of the (dp=8), (dp=2,tp=4) lib
and fused (dp=2) forwards against boda_tpu's pallas engine on the same mesh
at comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|), f32; each dp slice's
rows bit-equal to the no-mesh engine's forward of that slice.
"""

import numpy as np
import pytest

import boda_tpu.graph  # noqa: F401
from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import NetBuilder as JNetBuilder
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.parallel import mesh as jmesh
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu.utils.lexp import parse_lexp as jparse
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.pipe import PipeError
from boda_tpu_torch.models.zoo import NetBuilder as TNetBuilder
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.parallel import mesh as tmesh
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu_torch.utils.lexp import parse_lexp as tparse
from test_torch_engine_fused import _TUNE
from test_torch_engine_fused import _net as fused_net


def _raises(fn, *a, **kw) -> str:
    with pytest.raises(ValueError) as e:
        fn(*a, **kw)
    return f"{type(e.value).__name__}: {e.value}"


def test_make_mesh_and_errors():
    m = tmesh.make_mesh({"dp": 2, "tp": 4}, kind="cpu")
    assert m.shape == {"dp": 2, "tp": 4} and m.devices.shape == (2, 4)
    assert m.size("sp") == 1 and str(m.device(dp=1, tp=3)) == "cpu"
    assert len(tmesh.local_devices("cpu")) == 8  # tests/conftest.py's XLA_FLAGS
    for axes in ({"dp": 8, "tp": 4}, {"dp": 2, "tp": 0}, {"dp": 4, "tp": 4}):
        t = _raises(tmesh.make_mesh, axes, kind="cpu")
        assert t == _raises(jmesh.make_mesh, axes), axes
    assert _raises(tmesh.make_mesh, {"dp": 8, "tp": 4}, kind="cpu") == \
        "MeshError: mesh needs 32 devices, have 8"
    assert issubclass(tmesh.MeshError, ValueError)
    # an explicit device list may repeat a device: an n-way mesh on one
    one = tmesh.make_mesh({"dp": 4}, devices=["cpu"] * 4)
    assert [str(d) for d in one.devices] == ["cpu"] * 4


@pytest.mark.parametrize("model", ["mini_resnet", "resnet50"])
def test_split_axes_match_boda_tpu(model):
    jp, jd = jbuild(model, img=8, num_cls=64, in_sz=32)
    tp, td = tbuild(model, img=8, num_cls=64, in_sz=32)
    for axes, sp in (({"dp": 2, "tp": 4}, None), ({"dp": 2, "sp": 4}, "sp"),
                     ({"tp": 8}, None)):
        jm, tm = jmesh.make_mesh(axes), tmesh.make_mesh(axes, kind="cpu")
        jw, tw = jmesh.weight_shardings(jp, jm), tmesh.weight_shardings(tp, tm)
        assert set(jw) == set(tw)
        for k in jw:
            want = tuple(jw[k].spec) + (None,) * (len(tw[k]) - len(jw[k].spec))
            assert tw[k] == want, (axes, k)
        assert any("tp" in s for s in tw.values()) == ("tp" in axes)
        ji = jmesh.input_shardings(jd, jm, sp_axis=sp)
        ti = tmesh.input_shardings(td, tm, sp_axis=sp)
        for k in ji:
            want = tuple(ji[k].spec) + (None,) * (len(ti[k]) - len(ji[k].spec))
            assert ti[k] == want, (axes, k)


def _gate(ref, got, nodes, what):
    bad = []
    for n in nodes:
        a, b = np.asarray(ref[n].data, np.float32), got[n].data
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * max(1e-30, float(np.abs(a).max())))
        if not r.ok():
            bad.append((n, str(r)))
    assert not bad, f"{what}: {bad[:3]}"


def _mini(img=8):
    """boda_tpu's and the port's mini_resnet; the port's alone at another
    batch, for a slice."""
    tp, td = tbuild("mini_resnet", img=img, num_cls=16, in_sz=16)
    if img != 8:
        return tp
    return jbuild("mini_resnet", img=img, num_cls=16, in_sz=16)[0], tp, td["data"]


def _fused(img=2):
    """test_torch_engine_fused's net, boda_tpu's weights in both."""
    jp = fused_net(JNetBuilder, JDims)
    dims = type("Dims", (), {"of": staticmethod(lambda **kw: TDims.of(**{**kw, "img": img}))})
    tp = fused_net(TNetBuilder, dims)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    if img != 2:
        return tp
    return jp, tp, tp.nodes["data"].dims


CASES = {
    "dp8": (_mini, "(dp=8)", {}),
    "dp2_tp4_lib": (_mini, "(dp=2,tp=4)", {"kernel_policy": "lib"}),
    "fused_dp2": (_fused, "(dp=2)", {"kernel_policy": "gen", "fuse_block": "1",
                                     "tune": _TUNE}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_engine_mesh_matches_boda_tpu(case):
    """Every node, and the fused prob alone, against boda_tpu's pallas
    engine on the same mesh; under dp, each slice's rows bit-equal to the
    no-mesh engine's forward of that slice."""
    build, mesh, kw = CASES[case]
    jp, tp, d = build()
    x = np.random.RandomState(3).randn(*d.shape).astype(np.float32)
    jkw = {k: (jparse(v) if k == "tune" else v) for k, v in kw.items()}
    tkw = {k: (tparse(v) if k == "tune" else v) for k, v in kw.items()}
    je = jmake("conv_fwd", "pallas", mesh=jparse(mesh), **jkw)
    je.init(jp)
    te = tmake("conv_fwd", "cuda", device="cpu", mesh=tparse(mesh), **tkw)
    te.init(tp)
    nodes = [n for n, nd in tp.nodes.items() if nd.dims is not None and nd.top_for
             and n not in tp.weights and n != "data"]
    assert te._blocks if case.startswith("fused") else not te._blocks
    for outs in (["prob"], nodes):
        ref = je.run_fwd({"data": JNDA(jp.nodes["data"].dims, x)}, outs)
        got = te.run_fwd({"data": TNDA(d, x)}, outs)
        _gate(ref, got, outs, f"{case} {len(outs)} outputs")
    dp = te._mesh.size("dp")
    if te._mesh.size("tp") == 1:
        n = d["img"] // dp
        one = tmake("conv_fwd", "cuda", device="cpu", **tkw)
        one.init(build(n))
        rows = te.run_fwd({"data": TNDA(d, x)}, ["prob"])["prob"].data
        for i in range(dp):
            sl = {"data": TNDA(d.with_size("img", n), x[i * n:(i + 1) * n])}
            assert np.array_equal(rows[i * n:(i + 1) * n], one.run_fwd(sl, ["prob"])["prob"].data)
    else:
        assert len(te._weights_dev["__tp__"].parts) > 0


def test_tp_rules(tmp_path):
    """gen with tp raises "dp only" (boda_tpu's rule); tp forces the library
    over a wisdom file's hand-kernel tunes, with boda_tpu's log line, and
    matches the no-mesh library forward; the block fusion is off under tp."""
    from boda_tpu_torch.ops.sig_of import collect_net_sigs
    from boda_tpu_torch.prof.wisdom import OpRun, OpWisdom, write_wisdom
    jp, tp, d = _mini()
    x = TNDA(d, np.random.RandomState(0).randn(*d.shape).astype(np.float32))
    gen = tmake("conv_fwd", "cuda", device="cpu", kernel_policy="gen", mesh=tparse("(dp=2,tp=4)"))
    gen.init(tp)
    with pytest.raises(PipeError, match="dp only"):
        gen.run_fwd({"data": x}, ["prob"])
    jgen = jmake("conv_fwd", "pallas", kernel_policy="gen", mesh=jparse("(dp=2,tp=4)"))
    jgen.init(jp)
    with pytest.raises(Exception, match="dp only"):
        jgen.run_fwd({"data": JNDA(jp.nodes["data"].dims, x.data)}, ["prob"])
    wis = []
    for s in collect_net_sigs(tp):
        w = OpWisdom(s)
        w.runs.append(OpRun("(bm=64,bn=128,bk=128)", "interp:cpu", 1e-4))
        wis.append(w)
    write_wisdom(str(tmp_path / "w.wis"), wis)
    eng = tmake("conv_fwd", "cuda", device="cpu", kernel_policy="lib",
                wisdom_fn=str(tmp_path / "w.wis"), mesh=tparse("(dp=2,tp=4)"))
    eng.init(tp)
    got = eng.run_fwd({"data": x}, ["prob"])
    assert "tp>1 forces use_xla (gen tune deferred)" in eng.get_info_log()
    base = tmake("conv_fwd", "cuda", device="cpu", kernel_policy="lib")
    base.init(tp)
    _gate(base.run_fwd({"data": x}, ["prob"]), got, ["prob"], "tp over wisdom")
    jf, tf, _ = _fused()
    fused = tmake("conv_fwd", "cuda", device="cpu", kernel_policy="lib", fuse_block="1",
                  mesh=tparse("(tp=2)"))
    fused.init(tf)
    assert fused._blocks == {}
    unsharded = tmake("conv_fwd", "cuda", device="cpu", kernel_policy="lib", fuse_block="1")
    unsharded.init(tf)
    assert unsharded._blocks
