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
    repo corpus through the port's test_cmds, err_no_camera's capture error
    among them; err_bad_mode, which pins boda_tpu's full mode list, runs and
    passes: the two packages register the same modes."""
    rc = cli.main(["test_cmds", f"--boda-output-dir={tmp_path}", "--verbose=1",
                   "--filt=^(noop|blf_pack_basic|img_pyra_pack_t1|err_.*)$"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "PASS err_bad_mode" in out and "SKIP" not in out
    n_err = sum(1 for li in ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")
                if li.get("test_name").startswith("err_"))
    assert f"test_cmds: {n_err + 3}/{n_err + 3} passed, 0 skipped (test_cmds.xml)" in out


def _roadmap_kept() -> str:
    """ROADMAP §3's list of what was found in the reference and kept."""
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    text = text[text.index("### 3."):text.index("## Recent")]
    start = text.index("**Found in the reference, kept as it is:**")
    return text[start:text.index("\n\n**", start)]


def test_skip_table_holds_only_its_reasons():
    """Each entry of NOT_RUN names a corpus entry that the port cannot run
    for the reason it gives: a conv_fwd type it does not have, a golden
    that differs from boda_tpu's own output (on a line of ROADMAP §3 "Found
    in the reference, kept as it is", naming the entry and its golden), or
    a golden of XLA's HLO text. So every other corpus mode is registered,
    and the mode list that err_bad_mode pins is boda_tpu's."""
    entries = {li.get("test_name"): li for li in
               ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")}
    modes, engines = set(registered_tids("mode")), set(registered_tids("conv_fwd"))
    for name, (reason, what, item) in tc.NOT_RUN.items():
        assert name in entries, name
        assert reason in tc.REASONS and item.startswith("§"), name
        cli_str = entries[name].get("cli_str")
        if reason == "engine":
            for e in what.split(", "):
                assert f"mode={e}" in cli_str and e not in engines, name
        elif reason == "hlo":
            hlo = sorted(os.listdir(os.path.join(REPO, what)))
            assert hlo and all(f.endswith((".stablehlo.txt", ".opt_hlo.txt")) for f in hlo)
            assert "gen_src_dir=" in cli_str, name
        else:
            assert os.path.exists(os.path.join(REPO, what)), name
            line = next((ln for ln in _roadmap_kept().split("\n- ") if name in ln), "")
            assert what in line.replace("\n  ", " "), f"{name}: its golden not in ROADMAP §3"
    listed = re.search(r"valid values: (\[.*\])", entries["err_bad_mode"].get("err")).group(1)
    assert listed == str(sorted(modes))
    for name, li in entries.items():  # err_bad_mode names no mode, by design
        if name not in tc.NOT_RUN and name != "err_bad_mode":
            assert tc._split_cli(li.get("cli_str"))[0] in modes, name
    suites = {li.get("cli_str") for li in
              ET.parse(os.path.join(TD, "test_all.xml")).getroot().iter("li")}
    for cli_str, (reason, what, _) in tc.NOT_RUN_SUITES.items():
        assert cli_str in suites and reason == "engine"
        assert all(f"mode={e}" in cli_str and e not in engines for e in what.split(", "))


def test_skip_table_holds_four_entries():
    """NOT_RUN held four entries until the dist modes were registered and
    err_bad_mode left it, and three until the xla and pallas engines were:
    run_cnet_int8 and test_all's engine suite left it. Now it holds
    dist_test_2x2, whose golden is stale, and gen_src_tinynet, whose golden
    is XLA's HLO text, and nothing else; NOT_RUN_SUITES is empty."""
    assert set(tc.NOT_RUN) == {"dist_test_2x2", "gen_src_tinynet"}
    assert tc.NOT_RUN["dist_test_2x2"][0] == "golden"
    assert tc.NOT_RUN["gen_src_tinynet"][0] == "hlo" and tc.NOT_RUN_SUITES == {}


def test_test_all_skips_and_native_gate(tmp_path, capsys, monkeypatch):
    """test_all prints a SKIP line for a suite in NOT_RUN_SUITES (a stand-in
    entry: the table is empty) and runs the rest; without the native
    library, serve_bench_mini skips naming it."""
    suite = "noop --msg=on-a-tpu"
    monkeypatch.setitem(tc.NOT_RUN_SUITES, suite, ("engine", "xla, pallas", "§1 item 11"))
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
    engines are boda_tpu's (oracle: the xla engine, pallas: the pallas
    engine under gen), and its golden passes with them on the CPU."""
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
    tf = next(f for f in class_fields(TestCompute) if f.name == "engines")
    assert str(parse_lexp(tf.default)) == str(parse_lexp(f.default))
    out = tmp_path / "test_compute_mini"
    out.mkdir()
    rc = cli.main(["test_compute", "--model=mini_resnet", "--img=2", "--n-wins=1",
                   "--write-digests-fn=digests.boda", f"--boda-output-dir={out}",
                   "--engines=(oracle=(mode=xla,platform=cpu),"
                   "pallas=(mode=pallas,kernel_policy=gen,platform=cpu))"])
    (out / "test_out.txt").write_text(capsys.readouterr().out)
    assert rc == 0
    d = tc.diff_dirs(os.path.join(TD, "good_tr", "test_compute_mini"), str(out), 1e-3)
    assert d == "", d
