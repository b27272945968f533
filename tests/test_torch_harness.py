"""The port's golden-dir harness (boda_tpu_torch/modes/test_cmds.py):
tests/test_harness.py's filter and fail-detection, expected-error, ``needs``
and ``diff_file`` cases on the port's test_cmds; the device-free goldens of
the repo corpus passing; and the table of corpus entries the port does not
run yet held to the reasons it may give."""

import os
import re
import shutil
import xml.etree.ElementTree as ET

import pytest

from boda_tpu.modes.test_cmds import diff_file as ref_diff_file
from boda_tpu_torch import cli
from boda_tpu_torch.config import default_cfg_init, registered_tids
from boda_tpu_torch.modes import test_cmds as tc
from boda_tpu_torch.modes.test_cmds import diff_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
default_cfg_init(REPO)


def test_filter_and_fail_detection(tmp_path, capsys):
    good_copy = tmp_path / "good"
    shutil.copytree(os.path.join(TD, "good_tr"), good_copy)
    argv = ["test_cmds", f"--good-dir={good_copy}", "--filt=noop"]
    assert cli.main(argv + [f"--boda-output-dir={tmp_path}/o1"]) == 0
    with open(good_copy / "noop" / "test_out.txt", "a") as f:
        f.write("CORRUPTED\n")
    assert cli.main(argv + [f"--boda-output-dir={tmp_path}/o2"]) == 1
    out = capsys.readouterr().out
    assert "FAIL noop" in out and "CORRUPTED" in out
    # --update-failing re-archives and it passes again
    assert cli.main(argv + [f"--boda-output-dir={tmp_path}/o3", "--update-failing=1"]) == 0
    assert cli.main(argv + [f"--boda-output-dir={tmp_path}/o4"]) == 0


def test_expected_error_and_needs(tmp_path, capsys):
    xml = tmp_path / "cmds.xml"
    xml.write_text('<t><li test_name="x" cli_str="noop" err="this error never happens"/></t>')
    assert cli.main(["test_cmds", f"--xml-fn={xml}", f"--boda-output-dir={tmp_path}"]) == 1
    xml.write_text('<t><li test_name="y" cli_str="noop --oops=1" '
                   'err="unused config key(s) (typo?): oops"/></t>')
    assert cli.main(["test_cmds", f"--xml-fn={xml}", f"--boda-output-dir={tmp_path}"]) == 0
    capsys.readouterr()
    # needs= gates on a runtime feature: the reference's nets directory is
    # not configured here, so the entry skips
    xml.write_text('<t><li test_name="z" cli_str="noop" needs="ref_nets"/></t>')
    assert cli.main(["test_cmds", f"--xml-fn={xml}", f"--boda-output-dir={tmp_path}"]) == 0
    assert "0/0 passed, 1 skipped" in capsys.readouterr().out


def test_diff_file_types(tmp_path):
    a, b = tmp_path / "a.txt", tmp_path / "b.txt"
    a.write_text("one\ntwo\n")
    b.write_text("one\ntwo\n")
    assert diff_file(str(a), str(b)) == ""
    b.write_text("one\nTWO\n")
    d = diff_file(str(a), str(b))
    assert "-two" in d and "+TWO" in d and d == ref_diff_file(str(a), str(b))
    x, y = tmp_path / "a.bin", tmp_path / "b.bin"
    x.write_bytes(b"\x00\x01")
    y.write_bytes(b"\x00\x02")
    assert "binary files differ" in diff_file(str(x), str(y))
    # digest streams compare within digest_mrd, as boda_tpu's
    from boda_tpu_torch.utils.digest import DigestStream
    g = os.path.join(TD, "good_tr", "test_compute_mini", "digests.boda")
    ds = DigestStream.load(g)
    for _, dg in ds.entries:
        dg.sum *= 1.0 + 5e-4
        dg.samples = dg.samples * (1.0 + 5e-4)
    n = tmp_path / "n.boda"
    ds.save(str(n))
    assert diff_file(g, str(n), digest_mrd=1e-3) == "" == ref_diff_file(g, str(n), 1e-3)
    assert "mrd" in diff_file(g, str(n)) and diff_file(g, str(n)) == ref_diff_file(g, str(n))


def test_device_free_goldens(tmp_path, capsys):
    """noop, blf_pack_basic, img_pyra_pack_t1 and the err_* entries of the
    repo corpus through the port's test_cmds; err_bad_mode and err_no_camera
    print SKIP lines naming why."""
    rc = cli.main(["test_cmds", f"--boda-output-dir={tmp_path}",
                   "--filt=^(noop|blf_pack_basic|img_pyra_pack_t1|err_.*)$"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "SKIP err_bad_mode: it pins boda_tpu's full mode list" in out
    assert "SKIP err_no_camera: mode 'capture_classify' is not registered in the port" in out
    n_err = sum(1 for li in ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")
                if li.get("test_name").startswith("err_"))
    assert f"test_cmds: {n_err + 1}/{n_err + 1} passed, 2 skipped (test_cmds.xml)" in out


def _roadmap_section3() -> str:
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    return text[text.index("### 3."):text.index("## Recent")]


def test_skip_table_holds_only_its_reasons():
    """Each entry of NOT_RUN names a corpus entry that the port cannot run
    for the reason it gives: a mode the port does not register, a conv_fwd
    type it does not have, boda_tpu's full mode list, or (named in ROADMAP
    §3) a golden that differs on the card. So the table shrinks as modes
    arrive, and every other corpus mode is registered."""
    entries = {li.get("test_name"): li for li in
               ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")}
    modes, engines = set(registered_tids("mode")), set(registered_tids("conv_fwd"))
    for name, (reason, what, item) in tc.NOT_RUN.items():
        assert name in entries, name
        assert reason in tc.REASONS and item.startswith("§"), name
        cli_str = entries[name].get("cli_str")
        if reason == "mode":
            assert cli_str.split()[0] == what and what not in modes, name
        elif reason == "engine":
            for e in what.split(", "):
                assert f"mode={e}" in cli_str and e not in engines, name
        elif reason == "mode_list":
            listed = re.search(r"valid values: (\[.*\])", entries[name].get("err")).group(1)
            assert listed != str(sorted(modes)), name
        else:
            assert name in _roadmap_section3(), f"{name}: a card finding not in ROADMAP §3"
    for name, li in entries.items():
        if name not in tc.NOT_RUN:
            assert tc._split_cli(li.get("cli_str"))[0] in modes, name
    suites = {li.get("cli_str") for li in
              ET.parse(os.path.join(TD, "test_all.xml")).getroot().iter("li")}
    for cli_str, (reason, what, _) in tc.NOT_RUN_SUITES.items():
        assert cli_str in suites and reason == "engine"
        assert all(f"mode={e}" in cli_str and e not in engines for e in what.split(", "))


def test_test_all_skips_and_native_gate(tmp_path, capsys, monkeypatch):
    """test_all prints a SKIP line for a suite in NOT_RUN_SUITES and runs the
    rest; without the native library, serve_bench_mini skips naming it."""
    suite = next(iter(tc.NOT_RUN_SUITES))
    xml = tmp_path / "all.xml"
    xml.write_text(f'<t><li cli_str="{suite}"/><li cli_str="noop --msg=ok"/></t>')
    assert cli.main(["test_all", f"--xml-fn={xml}", f"--boda-output-dir={tmp_path}"]) == 0
    out = capsys.readouterr().out
    assert f"SKIP {suite}: its conv_fwd type (xla, pallas) is not in the port" in out
    assert "=== noop --msg=ok" in out and out.rstrip().endswith("test_all: PASS")
    from boda_tpu_torch.utils import native
    monkeypatch.setattr(native, "why_unavailable", lambda: "no libjpeg here")
    rc = cli.main(["test_cmds", f"--boda-output-dir={tmp_path}", "--filt=^serve_bench_mini$"])
    out = capsys.readouterr().out
    assert rc == 0
    assert ("SKIP serve_bench_mini: serve_bench needs the native library "
            "(native/boda_native.cc), which did not build here: no libjpeg here") in out
    assert "test_cmds: 0/0 passed, 1 skipped" in out


@pytest.fixture(autouse=True)
def _cwd(monkeypatch):
    monkeypatch.chdir(REPO)


def test_test_compute_mini_golden_with_default_labels(tmp_path, capsys):
    """test_compute_mini pins boda_tpu's engine labels: the port's default
    engines carry them (oracle: the library path, pallas: gen), and its
    golden passes with those engines on the CPU."""
    from boda_tpu.modes.test_compute import TestCompute as RefTestCompute
    from boda_tpu_torch.config import class_fields
    from boda_tpu_torch.modes.test_compute import TestCompute
    from boda_tpu_torch.utils.lexp import parse_lexp

    def labels(cls):
        f = next(f for f in class_fields(cls) if f.name == "engines")
        return [k for k, _ in parse_lexp(f.default).kids]
    from boda_tpu.config import class_fields as ref_class_fields
    f = next(f for f in ref_class_fields(RefTestCompute) if f.name == "engines")
    assert labels(TestCompute) == [k for k, _ in parse_lexp(f.default).kids] == \
        ["oracle", "pallas"]
    out = tmp_path / "test_compute_mini"
    out.mkdir()
    rc = cli.main(["test_compute", "--model=mini_resnet", "--img=2", "--n-wins=1",
                   "--write-digests-fn=digests.boda", f"--boda-output-dir={out}",
                   "--engines=(oracle=(mode=cuda,kernel_policy=lib,device=cpu),"
                   "pallas=(mode=cuda,kernel_policy=gen,device=cpu))"])
    (out / "test_out.txt").write_text(capsys.readouterr().out)
    assert rc == 0
    d = tc.diff_dirs(os.path.join(TD, "good_tr", "test_compute_mini"), str(out), 1e-3)
    assert d == "", d
