"""The port's sgemm and conv generators against boda_tpu's at the same tune,
on the same seeded inputs (CPU).

boda_tpu runs on its ``tpu`` backend, whose Pallas kernels run in interpret
mode on the CPU; the port on ``be=cuda,device=cpu``, whose wrappers run the
kernels' plain versions. Tolerance: 1e-5 of an element or of max|ref| (f32,
summation order only).
"""

import numpy as np
import pytest

import boda_tpu.modes_all  # noqa: F401
import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu.config import make as jmake
from boda_tpu.ops.op_base import Op as JOp
from boda_tpu.ops.registry import Codegen as JCodegen
from boda_tpu.ops.tune import OpTune as JOpTune
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu_torch.config import make
from boda_tpu_torch.ops.op_base import Op
from boda_tpu_torch.ops.registry import Codegen
from boda_tpu_torch.ops.tune import OpTune
from boda_tpu_torch.utils.digest import comp_vars
from boda_tpu_torch.utils.dims import NDA

TOL = 1e-5


def _run_both(sig: str, tune: str, ins: dict[str, np.ndarray]):
    """Run the op signature at the tune in both packages; (boda_tpu's outs,
    the port's outs, the port's FuncInfo)."""
    res = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            be, op = jmake("be", "tpu"), JOp.parse(sig)
            cg, t, nda = JCodegen(be), JOpTune.parse(tune), JNDA
        else:
            be, op = make("be", "cuda", device="cpu"), Op.parse(sig)
            cg, t, nda = Codegen(be), OpTune.parse(tune), NDA
        fi = cg.gen_func(op, t)
        for n, a in ins.items():
            be.create_var_from_nda(n, nda(op.dims(n), a))
        for n in fi.out_names:
            be.create_var_with_dims(n, op.dims(n))
        cg.compile()
        cg.run_func(fi, {n: n for n, _ in fi.args})
        res.append({n: np.asarray(be.copy_var_to_nda(n).data, np.float32)
                    for n in fi.out_names})
    return res[0], res[1], fi


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (130, 70, 258), (64, 512, 128)])
def test_sgemm_gen_vs_jax(M, K, N):
    rng = np.random.RandomState(1)
    ins = {"a": rng.randn(M, K).astype(np.float32), "b": rng.randn(K, N).astype(np.float32)}
    sig = f"(type=sgemm,a=(M={M},K={K}),b=(K={K},N={N}),c=(M={M},N={N}))"
    for tune, route in (("(bm=64,bn=128,bk=128)", "cuda:matmul"),
                        ("(use_xla=1)", "lib:torch.matmul")):
        ref, got, fi = _run_both(sig, tune, ins)
        assert fi.info.startswith(route)
        r = comp_vars(ref["c"], got["c"], mrd_toler=TOL,
                      atol=TOL * float(np.abs(ref["c"]).max()))
        assert r.ok(), (tune, str(r))


# (n, c, hw, oc, k, stride, pad, relu, tune, the port's route)
_CONV = [
    (2, 8, 12, 16, 3, 1, 1, 1, "()", "cuda:conv2d_nhwc"),
    (2, 8, 13, 16, 3, 2, 1, 0, "()", "cuda:conv2d s=(2, 2)"),
    (1, 3, 17, 8, 7, 2, 3, 1, "(use_s2d=1)", "cuda:s2d_conv"),
    (2, 16, 9, 24, 1, 2, 0, 0, "(use_xla=1)", "lib:F.conv2d"),
]


@pytest.mark.parametrize("n,c,hw,oc,k,s,p,relu,tune,route", _CONV)
def test_conv_gen_vs_jax(n, c, hw, oc, k, s, p, relu, tune, route):
    rng = np.random.RandomState(n + c + hw + k)
    o = (hw + 2 * p - k) // s + 1
    sig = (f"(type=conv,pad={p},relu={relu},stride={s},biases=(out_chan={oc}),"
           f"filts=(out_chan={oc},in_chan={c},y={k},x={k}),in=(img={n},chan={c},y={hw},x={hw}),"
           f"out=(img={n},chan={oc},y={o},x={o}))")
    ins = {"in": rng.randn(n, c, hw, hw).astype(np.float32),
           "filts": (rng.randn(oc, c, k, k) / np.sqrt(c * k * k)).astype(np.float32),
           "biases": (rng.randn(oc) * 0.1).astype(np.float32)}
    ref, got, fi = _run_both(sig, tune, ins)
    assert fi.info.startswith(route), fi.info
    assert got["out"].shape == (n, oc, o, o)
    r = comp_vars(ref["out"], got["out"], mrd_toler=TOL,
                  atol=TOL * float(np.abs(ref["out"]).max()))
    assert r.ok(), str(r)
