"""The port's cnn_prof, cnn_op_info and conv_ana against boda_tpu's goldens
(testdata/good_tr, the commands of testdata/test_cmds.xml:92-95), byte for
byte on the CPU; cnn_prof's untimed table of resnet50 against boda_tpu's CLI;
and both timed modes on the kernels' plain versions (``be=cuda,device=cpu``),
every row timed."""

import io
import json
import os
from contextlib import redirect_stdout

import pytest

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOOD = os.path.join(REPO, "testdata", "good_tr")
OPS = "%(boda_test_dir)/ops"
BE_CPU = "--be=(be=cuda,device=cpu)"

_CMDS = {
    "cnn_prof_mini": (["cnn_prof", "--model=mini_resnet", "--img=2"], None),
    "cnn_op_info_sgemm": (["cnn_op_info", f"--ops-fn={OPS}/sgemm-ops-tiny.txt",
                           "--op-info-tab-fn=info.tex"], "info.tex"),
    "cnn_op_info_r50": (["cnn_op_info", f"--ops-fn={OPS}/resnet50-ops-img8.txt",
                         "--op-info-tab-fn=info.tex", "--json-out=1"], "info.tex"),
    "conv_ana_mini": (["conv_ana", "--model=mini_resnet"], None),
}


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _golden(name, fn="test_out.txt"):
    with open(os.path.join(GOOD, name, fn)) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(_CMDS))
def test_golden_output(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv, written = _CMDS[name]
    rc, out = _run(cli.main, argv)
    assert rc == 0 and out == _golden(name), out
    if written:
        assert (tmp_path / written).read_text() == _golden(name, written)


def test_cnn_prof_resnet50_matches_boda_tpu():
    """cnn_prof's untimed table of resnet50 at b1, line for line as
    boda_tpu's CLI prints it."""
    from boda_tpu import cli as jcli
    argv = ["cnn_prof", "--model=resnet50", "--img=1"]
    rc, out = _run(cli.main, argv)
    jrc, jout = _run(jcli.main, argv)
    assert rc == jrc == 0
    jout = jout.split("TIMERS:")[0]  # boda_tpu's CLI ends with its timers, if any ran
    assert out == jout and out.count("\n") == 55


def test_timed_modes_on_cpu(tmp_path):
    """--time=1 on the plain versions: every conv/fc row and every corpus op
    timed, the comparison tune beside it; no %-peak on the CPU (its peak is
    unknown)."""
    rc, out = _run(cli.main, ["cnn_prof", "--model=mini_resnet", "--img=1", "--time=1",
                              BE_CPU, "--json-out=1"])
    assert rc == 0
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert len(recs) == 16 and all(r["us"] > 0 and "pct_peak" not in r for r in recs)
    rc, out = _run(cli.main, ["cnn_op_info", f"--ops-fn={REPO}/testdata/ops/sgemm-ops-tiny.txt",
                              "--time=1", BE_CPU, "--tune-comp=(use_xla=1)", "--n-iters=2",
                              f"--op-eff-tab-fn={tmp_path}/eff.tex"])
    assert rc == 0
    lines = [ln for ln in out.splitlines() if "AI" in ln]
    assert len(lines) == 3 and all("us" in ln and "comp:" in ln for ln in lines), out
    assert len((tmp_path / "eff.tex").read_text().splitlines()) == 3
