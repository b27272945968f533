"""Three Fields of boda_tpu that name XLA things, on the port: the engine's
``platform`` (boda_tpu: ``FwdEngine.device()``, executor.py:136) and
``compiler_options`` (executor.py:70), and the rtc backend's ``donate``
(rtc/backends.py:71). On the CPU: the platforms that map to a torch
device, the refusals, and a donated call equal to an undonated one."""

import numpy as np
import pytest
import torch

from boda_tpu_torch.config import ConfigError, make
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.rtc.compute import Call, FuncInfo
from boda_tpu_torch.utils.dims import NDA, Dims
from boda_tpu_torch.utils.lexp import parse_lexp


@pytest.mark.parametrize("mode", ["xla", "pallas", "cuda"])
def test_platform_picks_the_device(mode):
    """'' keeps the engine's device, cpu runs on the CPU, gpu and cuda on
    the card (which raises here at first use, as device=cuda does); a TPU
    or any other platform, and a platform that contradicts an explicit
    device, raise naming it."""
    pipe, in_dims = build_model("mini_resnet", img=1)
    ins = gen_data_inputs(in_dims)
    want = make("conv_fwd", mode, device="cpu")
    want.init(pipe)
    ref = want.run_fwd(ins, ["prob"])["prob"].data
    for kw in ({"platform": "cpu"}, {"platform": "cpu", "device": "cpu"},
               {"platform": "", "device": "cpu"}):
        e = make("conv_fwd", mode, **kw)
        assert e.device == "cpu" and e.dev() == torch.device("cpu")
        e.init(pipe)
        assert np.array_equal(e.run_fwd(ins, ["prob"])["prob"].data, ref)
    for plat in ("gpu", "cuda", ""):
        e = make("conv_fwd", mode, platform=plat)
        assert e.device == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA card"):
                e.dev()
    for plat in ("tpu", "METAL"):
        with pytest.raises(ConfigError, match=f"platform '{plat}' has no counterpart"):
            make("conv_fwd", mode, platform=plat)
    with pytest.raises(ConfigError, match="platform 'cpu' contradicts device 'cuda'"):
        make("conv_fwd", mode, platform="cpu", device="cuda")
    with pytest.raises(ConfigError, match="platform 'gpu' contradicts device 'cpu'"):
        make("conv_fwd", mode, platform="gpu", device="cpu")


def test_compiler_options_refuse_any_flag():
    """() is accepted; any flag, from a lexp or a dict, raises naming it as
    an XLA flag; the CLI refuses it the same way."""
    from boda_tpu_torch import cli
    make("conv_fwd", "xla", platform="cpu", compiler_options={})
    for co in ({"xla_tpu_scoped_vmem_limit_kib": "65536"},
               {k: v for k, v in parse_lexp("(xla_tpu_scoped_vmem_limit_kib=65536)").kids}):
        with pytest.raises(ConfigError, match=r"compiler_options \['xla_tpu_scoped_vmem_"
                                              r"limit_kib'\]: XLA compiler flags"):
            make("conv_fwd", "pallas", platform="cpu", compiler_options=co)
    assert cli.main(["run_cnet", "--model=mini_resnet", "--img=1",
                     "--conv-fwd=(mode=xla,platform=cpu,compiler_options=())"]) == 0
    assert cli.main(["run_cnet", "--model=mini_resnet", "--img=1",
                     "--conv-fwd=(mode=xla,platform=cpu,compiler_options=(a=1))"]) == 1


def test_rtc_donate_writes_into_the_input():
    """A call whose output var is its input var: under donate=1 the result
    lands in the input's buffer (same storage), equal to donate=0's new
    tensor; an output var that is no input of the call is bound as it is."""
    dims = Dims.of(n=64, tn="float32")
    x = np.random.RandomState(0).randn(64).astype(np.float32)
    fi = FuncInfo("neg_add", [("a", "in"), ("b", "in"), ("o", "out"), ("p", "out")],
                  lambda a, b: (a * -1.0 + b, a + b))
    res = {}
    for donate in (0, 1):
        be = make("be", "cuda", device="cpu", donate=donate)
        be.add_func(fi)
        be.compile()
        be.create_var_from_nda("x", NDA(dims, x))
        be.create_var_from_nda("y", NDA(dims, x * 2))
        be.create_var_with_dims("z", dims)
        ptrs = {v: be.get_var_raw(v).data_ptr() for v in ("x", "z")}
        be.run(Call("neg_add", {"a": "x", "b": "y", "o": "x", "p": "z"}))
        same = {v: be.get_var_raw(v).data_ptr() == ptrs[v] for v in ptrs}
        assert same == {"x": bool(donate), "z": False}
        res[donate] = (be.copy_var_to_nda("x").data, be.copy_var_to_nda("z").data)
    assert np.array_equal(res[0][0], res[1][0]) and np.array_equal(res[0][1], res[1][1])
    assert np.array_equal(res[1][0], x)  # -x + 2x
