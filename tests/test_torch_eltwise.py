"""K9's plain version and the rtc ``eltwise`` op against boda_tpu's, on the
CPU: every func at n = 777 (not a multiple of any vector width), float32 and
bfloat16, with NaN, +-0 and +-inf among the inputs.

boda_tpu runs ``pallas_elementwise`` in interpret mode (``be=tpu`` on the
CPU) and its plain jnp version (``be=interp``); the port its plain version
through ``be=cuda,device=cpu`` and ``be=interp``. Tolerance: none. Every
value is the same; NaN sits at the same places (its sign bit is not
compared: a bf16 NaN converted from f32 is canonical in torch on the CPU).
"""

import numpy as np
import pytest

import boda_tpu.modes_all  # noqa: F401
import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu.config import make as jmake
from boda_tpu.ops.op_base import Op as JOp
from boda_tpu.ops.registry import Codegen as JCodegen
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu_torch.config import make
from boda_tpu_torch.ops.kernels.elementwise import FUNC_CODES, eltwise
from boda_tpu_torch.ops.op_base import Op
from boda_tpu_torch.ops.registry import Codegen
from boda_tpu_torch.utils.dims import NDA

N = 777
_SPECIAL = [np.nan, -0.0, 0.0, np.inf, -np.inf, -1.5, 0.0, -0.0]


def _inputs(func):
    rng = np.random.RandomState(len(func))
    a = rng.randn(N).astype(np.float32)
    b = rng.randn(N).astype(np.float32)
    a[:8] = _SPECIAL
    b[:8] = _SPECIAL[::-1]  # max(-0, +0), max(+0, -0), NaN on either side
    b[20:30] = a[20:30]     # ties
    return {"a": a, "b": b} if func in ("mul", "add", "sub", "max") else {"a": a}


def _run(be, cg, nda, op, ins):
    fi = cg.gen_func(op)
    for n, x in ins.items():
        be.create_var_from_nda(n, nda(op.dims(n), x))
    be.create_var_with_dims("out", op.dims("out"))
    cg.compile()
    cg.run_func(fi, {n: n for n, _ in fi.args})
    return np.asarray(be.copy_var_to_nda("out").data, np.float32), fi


def _same(ref, got):
    nan = np.isnan(ref)
    return np.array_equal(nan, np.isnan(got)) and \
        np.array_equal(ref[~nan], got[~nan]) and \
        np.array_equal(np.signbit(ref[~nan]), np.signbit(got[~nan]))


@pytest.mark.parametrize("func", list(FUNC_CODES))
def test_eltwise_vs_jax(func):
    ins = _inputs(func)
    before = eltwise.launches
    for tn in ("float32", "bfloat16"):
        d = f"(n={N}" + (",__tn__=bfloat16)" if tn == "bfloat16" else ")")
        sig = f"(type=eltwise,func={func},a={d}" + (f",b={d}" if "b" in ins else "") + \
            f",out={d})"
        refs = {}
        for name in ("tpu", "interp"):
            be = jmake("be", name)
            refs[name], fi = _run(be, JCodegen(be), JNDA, JOp.parse(sig), ins)
            assert fi.info.startswith("pallas" if name == "tpu" else "ref")
        assert _same(refs["tpu"], refs["interp"]), (func, tn)
        for be, route in ((make("be", "cuda", device="cpu"), "cuda:eltwise"),
                          (make("be", "interp"), "ref:plain")):
            got, fi = _run(be, Codegen(be), NDA, Op.parse(sig), ins)
            assert fi.info.startswith(route)
            assert _same(refs["tpu"], got), (func, tn, route)
    assert eltwise.launches == before  # a CPU tensor runs the plain version
