"""The port's rtc and prof modes against boda_tpu's golden outputs
(testdata/good_tr, the commands of testdata/test_cmds.xml:12,23,96,97,100).

Each command runs in process in a scratch directory; its stdout must be the
golden test_out.txt, apart from the platform tag where the backend differs
(``be=cuda,device=cpu`` reports ``cuda:cpu`` where boda_tpu's interp
reports ``interp:cpu``). Files the command writes are held against the
golden copy where there is one, else against boda_tpu's own output.
"""

import io
import os
from contextlib import redirect_stdout

import pytest

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOOD = os.path.join(REPO, "testdata", "good_tr")
R50 = "%(boda_test_dir)/wisdom/resnet50"

_CMDS = {
    "rtc_test_interp": ["rtc_test", "--be=(be=interp)", "--n=1000"],
    "gen_prof_ops_mini": ["gen_prof_ops", "--model=mini_resnet", "--img=2"],
    "wis_ana_r50": ["wis_ana", f"--wisdom-fn={R50}-bf16-v5e.wis"],
    "wis_merge_r50": ["wis_merge", f"--srcs=(a={R50}-v5e.wis,b={R50}-bf16-v5e.wis)",
                      "--out-fn=merged.wis"],
}


def _run(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _golden(name, fn="test_out.txt"):
    with open(os.path.join(GOOD, name, fn)) as f:
        return f.read()


@pytest.mark.parametrize("name", sorted(_CMDS))
def test_golden_output(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rc, out = _run(_CMDS[name])
    assert rc == 0 and out == _golden(name), out
    if name == "rtc_test_interp":  # the card's backend, on the CPU
        rc, out = _run(["rtc_test", "--be=(be=cuda,device=cpu)", "--n=1000"])
        assert rc == 0 and out.replace("cuda:cpu", "interp:cpu") == _golden(name)
    elif name == "gen_prof_ops_mini":
        assert (tmp_path / "prof-ops.txt").read_text() == _golden(name, "prof-ops.txt")
    elif name == "wis_merge_r50":  # the same merged records as boda_tpu's
        from boda_tpu import cli as jcli
        os.mkdir("jax")
        monkeypatch.chdir(tmp_path / "jax")
        with redirect_stdout(io.StringIO()):
            assert jcli.main(_CMDS[name]) == 0
        body = [(tmp_path / d / "merged.wis").read_text().splitlines()[2:]
                for d in (".", "jax")]
        assert body[0] == body[1] and len(body[0]) > 100


def test_ops_prof_without_ops_fn_is_an_error(capsys):
    """testdata/test_cmds.xml:12: the required corpus, boda_tpu's exact text."""
    assert cli.main(["ops_prof"]) == 1
    assert capsys.readouterr().err == (
        "error: ops_prof.ops_fn: missing required value (type=filename; help: "
        "op-signature corpus (one lexp/line))\n")
