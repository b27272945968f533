"""The corpus items that name boda_tpu's ``xla`` and ``pallas`` engines,
through the port's CLI on the CPU (``platform=cpu`` added to each engine,
since the port's engines default to the card): run_cnet_int8 against its
golden directory, test_all.xml's xla/pallas suite, and gen_src_tinynet,
which stays in ``NOT_RUN`` because its golden is XLA's HLO text: its
``out prob`` line is held here, and its gen_src line names the port's plan
file."""

import os
import re
import xml.etree.ElementTree as ET

import pytest

from boda_tpu_torch import cli
from boda_tpu_torch.config import default_cfg_init
from boda_tpu_torch.modes import test_cmds as tc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
default_cfg_init(REPO)


@pytest.fixture(autouse=True)
def _cwd(monkeypatch):
    monkeypatch.chdir(REPO)


def on_cpu(cli_str: str) -> str:
    """The cli_str with every engine of mode xla or pallas on the CPU."""
    return re.sub(r"\(mode=(xla|pallas)", r"(mode=\1,platform=cpu", cli_str)


def corpus_entry(name: str):
    return next(li for li in ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")
                if li.get("test_name") == name)


def test_run_cnet_int8_golden(tmp_path, capsys):
    """(mode=pallas,int8=1): the pallas engine's NHWC layout, int8 ahead of
    boda_tpu's default lib policy; the golden directory byte-equal."""
    assert "run_cnet_int8" not in tc.NOT_RUN
    cli_str = on_cpu(corpus_entry("run_cnet_int8").get("cli_str"))
    assert "(mode=pallas,platform=cpu,int8=1)" in cli_str
    xml = tmp_path / "cmds.xml"
    xml.write_text(f'<t><li test_name="run_cnet_int8" cli_str="{cli_str}"/></t>')
    rc = cli.main(["test_cmds", f"--xml-fn={xml}", f"--boda-output-dir={tmp_path}",
                   "--verbose=1"])
    out = capsys.readouterr().out
    assert rc == 0 and "PASS run_cnet_int8" in out, out


def test_test_all_engine_suite(tmp_path, capsys):
    """test_all.xml's suite of the xla oracle against the pallas engine
    under gen in bf16 (mrd 3e-2) runs and passes; it is no longer skipped."""
    suites = [li.get("cli_str") for li in
              ET.parse(os.path.join(TD, "test_all.xml")).getroot().iter("li")
              if "mode=xla" in li.get("cli_str")]
    assert len(suites) == 1 and suites[0] not in tc.NOT_RUN_SUITES
    xml = tmp_path / "all.xml"
    xml.write_text(f'<t><li cli_str="{on_cpu(suites[0])}"/></t>')
    rc = cli.main(["test_all", f"--xml-fn={xml}", f"--boda-output-dir={tmp_path}"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "engines=['oracle', 'bf16'] wins=1 nodes=51: PASS" in out
    assert out.rstrip().endswith("test_all: PASS")


def test_gen_src_tinynet_keeps_its_reason(tmp_path, capsys):
    """gen_src_tinynet's golden gs/ holds StableHLO and optimized HLO, which
    no PyTorch engine writes: the entry skips with that reason. Run on the
    xla engine, its forward prints the golden's out prob line, and gen_src
    writes the port's plan of the same forward."""
    assert tc.NOT_RUN["gen_src_tinynet"][0] == "hlo"
    good = os.path.join(TD, "good_tr", "gen_src_tinynet")
    rc = cli.main(["test_cmds", "--filt=^gen_src_tinynet$", f"--boda-output-dir={tmp_path}"])
    out = capsys.readouterr().out
    assert rc == 0 and "SKIP gen_src_tinynet: its golden (testdata/good_tr/" \
        "gen_src_tinynet/gs) holds XLA's StableHLO and optimized HLO text" in out
    argv = tc._split_cli(on_cpu(corpus_entry("gen_src_tinynet").get("cli_str")
                                .replace("%(boda_test_dir)", TD)))
    rc = cli.main(argv + [f"--boda-output-dir={tmp_path}"])
    lines = capsys.readouterr().out.splitlines()
    want = open(os.path.join(good, "test_out.txt")).read().splitlines()
    assert rc == 0 and lines[0] == want[0], (lines, want)
    plan = os.listdir(tmp_path / "gs")
    assert len(plan) == 1 and plan[0].startswith("tinynet_") and plan[0].endswith(".plan.txt")
    assert lines[1] == f"gen_src: wrote {plan[0]}"
    text = (tmp_path / "gs" / plan[0]).read_text()
    assert "# engine: device=cpu mode=xla" in text and "Convolution" in text
