"""The port's test_compute and comp_ndas modes on the CPU, their digest
streams against boda_tpu's, and the engine's precision on the library ops.

The cross-package digest checks run on bconv_strides' forward graph. On a
gradient graph a digest check between two packages fails whatever the
code: ``mrd_comp`` (both packages) compares sums and samples by relative
difference with no absolute floor, and the loss gradient's sum cancels
(sum over classes of prob - onehot is 0), so f32 roundoff of ~1e-8 reads
as a relative difference near 1. The gradient graph is held node by node
with comp_vars instead (tests/test_torch_engine_bck.py).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from boda_tpu.cli import main as jmain
from boda_tpu.utils.digest import DigestStream as JDigestStream
from boda_tpu_torch.cli import main as tmain
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.utils.digest import DigestStream as TDigestStream

_CPU_ENGINES = ("--engines=(lib=(mode=cuda,kernel_policy=lib,device=cpu),"
                "gen=(mode=cuda,kernel_policy=gen,device=cpu))")
_NET = ["--model=mini_resnet", "--img=1", "--in-sz=8", "--n-wins=1",
        "--add-bck-ops=1"]
_DIG_NET = ["--model=bconv_strides", "--img=2", "--n-wins=2"]


@pytest.fixture(scope="module")
def jstream(tmp_path_factory):
    """A digest stream boda_tpu's test_compute wrote (its xla engine) for
    bconv_strides: the same zoo weights, the same gen_data inputs."""
    d = tmp_path_factory.mktemp("jdig")
    rc = jmain(["test_compute", *_DIG_NET, "--engines=(oracle=(mode=xla))",
                "--write-digests-fn=j.digests", f"--boda-output-dir={d}"])
    assert rc == 0
    return d / "j.digests"


def test_test_compute_bck_cli_on_cpu(tmp_path, capsys):
    rc = tmain(["test_compute", *_NET, "--mrd-toler=1e-3", _CPU_ENGINES,
                f"--boda-output-dir={tmp_path}"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "test_compute mini_resnet engines=['lib', 'gen'] wins=1" in out
    assert ": PASS" in out


def test_boda_tpu_digest_stream_passes_the_port(jstream, tmp_path, capsys):
    """The port's gen engine checked against boda_tpu's stored known-good
    stream at 1e-4; the port's own stream then loads in boda_tpu and
    matches entry for entry."""
    rc = tmain(["test_compute", *_DIG_NET, "--mrd-toler=1e-4",
                "--engines=(gen=(mode=cuda,kernel_policy=gen,device=cpu))",
                f"--kg-digests-fn={jstream}", "--write-digests-fn=t.digests",
                f"--boda-output-dir={tmp_path}"])
    out = capsys.readouterr().out
    assert rc == 0, out
    kg = TDigestStream.load(str(jstream)).as_dict()
    mine = JDigestStream.load(str(tmp_path / "t.digests")).as_dict()
    assert set(kg) == set(mine) and len(kg) == 18
    for k, d in kg.items():
        assert d.mrd_comp(mine[k]) <= 1e-4, k


def test_comp_ndas_on_boda_tpu_stream(jstream, tmp_path, capsys):
    rc = tmain(["test_compute", *_DIG_NET, "--mrd-toler=1e-4",
                "--engines=(lib=(mode=cuda,kernel_policy=lib,device=cpu))",
                "--write-digests-fn=t.digests", f"--boda-output-dir={tmp_path}"])
    assert rc == 0
    rc = tmain(["comp_ndas", f"--a-fn={jstream}", f"--b-fn={tmp_path}/t.digests",
                "--mrd-toler=1e-4"])
    out = capsys.readouterr().out
    assert rc == 0 and "PASS" in out, out
    # a stream differing in one entry fails
    s = TDigestStream.load(str(tmp_path / "t.digests"))
    s.entries = s.entries[1:]
    s.save(str(tmp_path / "short.digests"))
    assert tmain(["comp_ndas", f"--a-fn={jstream}",
                  f"--b-fn={tmp_path}/short.digests"]) == 1


def test_engine_precision_reaches_the_lib_conv(monkeypatch):
    """The engine's precision is in force inside each library conv (TF32
    off at 'highest', on at 'high') and the previous settings are back
    afterwards."""
    seen = []
    conv2d = F.conv2d

    def spy(*a, **kw):
        seen.append((torch.backends.cudnn.conv.fp32_precision,
                     torch.backends.cuda.matmul.fp32_precision))
        return conv2d(*a, **kw)
    monkeypatch.setattr(F, "conv2d", spy)
    cv, mm = torch.backends.cudnn.conv, torch.backends.cuda.matmul
    before = (cv.fp32_precision, mm.fp32_precision)
    pipe, in_dims = tbuild("mini_resnet", img=1, in_sz=8)
    for prec, want in (("highest", "ieee"), ("high", "tf32")):
        seen.clear()
        eng = tmake("conv_fwd", "cuda", device="cpu", kernel_policy="lib",
                    precision=prec)
        eng.init(pipe)
        out = eng.run_fwd(gen_data_inputs(in_dims), ["prob"])
        assert np.all(np.isfinite(out["prob"].data))
        assert seen and set(seen) == {(want, want)}, (prec, seen)
        assert (cv.fp32_precision, mm.fp32_precision) == before
