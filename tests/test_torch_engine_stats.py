"""The engine's ``per_layer_stats`` and ``quantize`` Fields, ``per_layer_times``
and run_cnet's ``write_sigs_fn``, against boda_tpu's, on the CPU, f32.

The net is mini_resnet (b1, 16x16); weights are carried from boda_tpu's pipe
and the input is numpy from a seed. The port runs its ``cuda`` engine with
``device=cpu`` (the kernels' plain versions).
"""

import re

import numpy as np
import pytest

import boda_tpu.modes_all  # noqa: F401  (registers boda_tpu's modes)
from boda_tpu.cli import main as jmain
from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.lexp import parse_lexp as jparse
from boda_tpu_torch import cli
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.lexp import parse_lexp as tparse

_KW = dict(img=1, num_cls=8, in_sz=16)
_STAT_LINE = re.compile(r"var_stats (\S+): min=\S+ max=\S+ avg=\S+ sum_sq=\S+ cnt=(\d+)")
# conv1 is the head of the chain conv1 -> bn1 -> relu1; fc feeds prob
_QUANT = "(conv1=(max_val=2,keep_bits=2),fc=(max_val=8,keep_bits=6))"


@pytest.fixture(scope="module")
def net():
    jp, jd = jbuild("mini_resnet", **_KW)
    tp, td = tbuild("mini_resnet", **_KW)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    x = np.random.RandomState(0).randn(*jd["data"].shape).astype(np.float32)
    return dict(jp=jp, tp=tp, jin={"data": JNDA(jd["data"], x)},
                tin={"data": TNDA(td["data"], x)})


def _port(net, **kw):
    te = tmake("conv_fwd", "cuda", device="cpu", **kw)
    te.init(net["tp"])
    return te


@pytest.mark.parametrize("policy", ["lib", "gen"])
def test_per_layer_stats_match_boda_tpu(net, policy):
    """The same var_stats lines (node, cnt) as boda_tpu's engine with the same
    Fields; min, max and sum_sq within 1e-5 relative, the sum within 1e-5 of
    sqrt(cnt * sum_sq), which bounds sum|x| (the sum cancels, and the two
    add in other orders)."""
    je = jmake("conv_fwd", "pallas", kernel_policy=policy, per_layer_stats=True)
    je.init(net["jp"])
    je.run_fwd(net["jin"], ["prob"])
    te = _port(net, kernel_policy=policy, per_layer_stats=True)
    te.run_fwd(net["tin"], ["prob"])
    jl = _STAT_LINE.findall(je.get_info_log())
    tl = _STAT_LINE.findall(te.get_info_log())
    assert len(tl) > 10 and tl == jl
    assert sorted(te._last_stats) == sorted(je._last_stats)
    for n, (mn, mx, sm, sq) in je._last_stats.items():
        got = te._last_stats[n]
        cnt = net["tp"].must_dims(n).num_elems()
        scale = max(abs(mn), abs(mx))
        assert abs(got[0] - mn) <= 1e-5 * scale and abs(got[1] - mx) <= 1e-5 * scale, n
        assert abs(got[2] - sm) <= 1e-5 * np.sqrt(cnt * sq), n
        assert abs(got[3] - sq) <= 1e-5 * sq, n


def test_quantize_matches_boda_tpu_xla(net):
    """quantize against boda_tpu's xla engine with the same lexp
    (tests/test_aux.py:29-52): every quantized value equal, or one quantum
    apart where the unquantized values straddle a step (they differ in the
    last f32 bits): at most 1% of the elements. With no such element the
    downstream prob agrees at 1e-5."""
    q = jparse(_QUANT)
    je = jmake("conv_fwd", "xla", quantize={k: v for k, v in q.kids})
    je.init(net["jp"])
    jr = je.run_fwd(net["jin"], ["conv1", "fc", "prob"])
    te = _port(net, kernel_policy="lib", quantize=dict(tparse(_QUANT).kids))
    tr = te.run_fwd(net["tin"], ["conv1", "fc", "prob"])
    for node, quantum in (("conv1", 2 / 4), ("fc", 8 / 64)):
        a, b = jr[node].data, tr[node].data
        assert a.min() >= 0 and a.max() <= 2 ** 3 and len(np.unique(b)) > 1
        d = np.abs(a - b)
        off = int((d > 0).sum())
        assert np.all((d == 0) | np.isclose(d, quantum, rtol=1e-6)), node
        assert off <= 0.01 * a.size, (node, off, a.size)
        if node == "fc" and off == 0:
            np.testing.assert_allclose(tr["prob"].data, jr["prob"].data, rtol=1e-5,
                                       atol=1e-7)


def test_quantized_chain_intermediate_is_not_fused(net):
    """A quantized node inside a fusion chain keeps the chain unfused, as a
    requested output does: the forward that asks for prob alone quantizes
    conv1 exactly as the one that asks for conv1 too, and differs from the
    unquantized forward."""
    q = dict(tparse("(conv1=(max_val=2,keep_bits=2))").kids)
    te = _port(net, quantize=q)
    assert "conv1" in te._chains  # the fusable chain conv1 -> bn1 -> relu1
    alone = te.run_fwd(net["tin"], ["prob"])["prob"].data
    both = te.run_fwd(net["tin"], ["conv1", "prob"])["prob"].data
    plain = _port(net).run_fwd(net["tin"], ["prob"])["prob"].data
    assert np.array_equal(alone, both) and not np.allclose(alone, plain, rtol=1e-3)
    with pytest.raises(Exception, match="quantize: no node"):
        _port(net, quantize=dict(tparse("(nosuch=(max_val=2))").kids))


def test_per_layer_times_raises_on_the_cpu(net):
    """per_layer_times (and time_fwd) time the card: a CPU engine raises
    rather than report a host time as a device one."""
    te = _port(net)
    with pytest.raises(RuntimeError, match="per_layer_times times the card"):
        te.per_layer_times(net["tin"])
    with pytest.raises(RuntimeError, match="time_fwd times the card"):
        te.time_fwd(net["tin"], ["prob"])


def test_run_cnet_write_sigs_match_boda_tpu(tmp_path, capsys):
    """run_cnet --write-sigs-fn writes the same op-signature keys as
    boda_tpu's, and a second run adds none."""
    args = ["run_cnet", "--model=mini_resnet", "--img=2", "--write-sigs-fn=sigs.txt"]
    assert jmain(args + [f"--boda-output-dir={tmp_path / 'j'}"]) == 0
    targs = args + [f"--boda-output-dir={tmp_path / 't'}",
                    "--conv-fwd=(mode=cuda,device=cpu)"]
    assert cli.main(targs) == 0
    assert cli.main(targs) == 0
    out = capsys.readouterr().out
    assert "write_sigs: +0 sigs" in out
    jl = (tmp_path / "j" / "sigs.txt").read_text().splitlines()
    tl = (tmp_path / "t" / "sigs.txt").read_text().splitlines()
    assert len(tl) > 5 and tl == jl
