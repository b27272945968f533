"""Op rules and per-op tunes of the port's engine on the CPU: Eltwise
variants, padded ceil-mode avg pooling and the NCHW-flatten fc against
boda_tpu's xla engine, and per_op_tune against kernel_policy."""

import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims
from boda_tpu_torch.utils.lexp import parse_lexp


def _check(jr, tr, nodes):
    for n in nodes:
        a, b = jr[n].data, tr[n].data
        assert a.shape == b.shape, n
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
        assert r.num_diff == 0, f"node {n}: {r}"


def _dispatch(info_log: str) -> dict[str, set]:
    out: dict[str, set] = {}
    for line in info_log.splitlines():
        name, _, rest = line.partition(": ")
        kind = rest.split(" ")[0]
        if kind.startswith("nhwc-"):
            out.setdefault(kind[5:], set()).add(name)
    return out


def _eltwise_net(builder_cls, kind, coeffs):
    b = builder_cls("eltwise_net")
    t = b.input("data")
    t = b.conv("c0", t, 8, 3, pad=1, in_chans=3, relu=True)
    u = b.conv("c1", t, 8, 1, in_chans=8)
    v = b.conv("c2", t, 8, 3, pad=1, in_chans=8)
    e = b.eltwise("e", [u, v], op=kind)
    if coeffs:
        b.pipe.ops["e"].params["coeffs"] = coeffs
    t = b.pool("p", e, kern=3, stride=2, pad=1, avg=True)
    b.softmax("prob", b.fc("fc", t, 5, in_feats=8 * 5 * 5))
    dcls = TDims if builder_cls.__module__.startswith("boda_tpu_torch") else JDims
    d = {"data": dcls.of(img=2, chan=3, y=9, x=9)}
    return b.done(d), d


@pytest.mark.parametrize("kind,coeffs", [("sum", [0.5, -2.0]), ("prod", None),
                                         ("max", None)])
def test_eltwise_kinds_and_avg_pool_match(kind, coeffs):
    """Eltwise sum-with-coeffs/prod/max (never fused: only plain sums are),
    a padded ceil-mode avg pool and an fc over an NCHW flatten, against
    boda_tpu's xla engine (the op rules' semantics, not its kernels)."""
    from boda_tpu.models.zoo import NetBuilder as JB
    from boda_tpu_torch.models.zoo import NetBuilder as TB
    jp, jd = _eltwise_net(JB, kind, coeffs)
    tp, td = _eltwise_net(TB, kind, coeffs)
    x = np.random.RandomState(3).randn(2, 3, 9, 9).astype(np.float32)
    nodes = ["e", "p", "fc", "prob"]
    je = jmake("conv_fwd", "xla")
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(jd["data"], x)}, nodes)
    te = tmake("conv_fwd", "cuda", device="cpu")
    te.init(tp)
    tr = te.run_fwd({"data": TNDA(td["data"], x)}, nodes)
    _check(jr, tr, nodes)


def test_per_op_tune_overrides_policy():
    """An explicit per-op tune wins over the engine policy, both ways."""
    pipe, in_dims = tbuild("mini_resnet", img=2)
    ins = gen_data_inputs(in_dims)
    res = {}
    for tag, kw in (("gen", {}),
                    ("one_lib", dict(per_op_tune={"s1b0_c1": parse_lexp("(use_xla=1)")})),
                    ("lib_but_fc", dict(kernel_policy="lib",
                                        per_op_tune={"fc": parse_lexp("(use_k1conv=1)")}))):
        te = tmake("conv_fwd", "cuda", device="cpu", **kw)
        te.init(pipe)
        res[tag] = te.run_fwd(ins, ["prob", "fc"])
        kinds = _dispatch(te.get_info_log())
        if tag == "one_lib":
            assert kinds["lib_conv"] == {"s1b0_c1"}
        if tag == "lib_but_fc":
            assert "k1conv" not in kinds and "direct_conv" not in kinds
            assert kinds["ip"] == {"fc"} and te.op_tune("fc").use_xla is False
            assert te.op_tune("conv1").use_xla is True
            assert "gemm" in te.get_info_log().split("fc: nhwc-ip ")[1]
    for tag in ("one_lib", "lib_but_fc"):
        _check(res["gen"], res[tag], ["prob", "fc"])
