"""test_cmds: golden-output-directory command tests.

Counterpart of ``boda_tpu/modes/test_cmds.py`` (ref ``test_cmds_t``,
src/test_nesi.cc:516), on the same XML files and known-good directories:
read an XML list of ``<li test_name=... cli_str=... [err=...] [needs=...]
[slow=...]/>`` entries; run each command with its own output dir; diff the
whole output dir against the archived known-good dir (per-filetype differs:
line diff for .txt, tolerance diff for digest streams, bytewise otherwise);
``--update-failing`` re-archives; ``err=`` asserts the exact error text;
``needs=`` gates on runtime features; ``--filt`` selects tests by name regex.

One addition: ``NOT_RUN`` lists each corpus entry the port does not run yet,
with its reason and the ROADMAP item that ports it; such an entry prints
``SKIP <name>: ...`` and counts as skipped. So does, decided at run time, an
entry whose mode needs the native library where that library did not build.
A mode's RuntimeError (a missing card, say) is that entry's failure, not
the end of the run.
"""

from __future__ import annotations

import contextlib
import difflib
import filecmp
import io
import os
import re
import shutil
import sys
import xml.etree.ElementTree as ET

from ..config import ConfigError, Field, Mode, register, run_mode
from ..utils.features import is_feature_enabled
from ..utils.lexp import LexpError, lexp_from_argv

# why an entry may be in NOT_RUN: its mode is not registered in the port; its
# cli_str names a conv_fwd type the port does not have; it pins boda_tpu's
# full mode list; or its golden differs on the card (named in ROADMAP §3)
REASONS = ("mode", "engine", "mode_list", "card")

# test_cmds.xml entry name -> (reason, what, ROADMAP item)
NOT_RUN = {
    "display_pil": ("mode", "display_pil", "§1 item 9: display_modes"),
    "err_no_camera": ("mode", "capture_classify", "§1 item 9: display_modes"),
    "cs_disp_pipeline": ("mode", "cs_disp", "§1 item 9: proc_pipe"),
    "render_pts_velo": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "hash_pair_check": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "velodyne_gen_scan": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "avi_mjpeg_scan": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "rosbag_scan_image": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "rosbag_scan": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "velo_scan_fixture": ("mode", "velo_scan", "§1 item 9: stream/ and stream_modes"),
    "stream_sync": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "stream_merge_flatten": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "stream_fold_sort": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "stream_seq_adj_angle": ("mode", "scan_data_stream", "§1 item 9: stream/ and stream_modes"),
    "dist_test_2x2": ("mode", "dist_test_master", "§1 item 10: multi-device"),
    "run_cnet_int8": ("engine", "pallas", "§1 item 11: boda_tpu's TPU engines are not ported"),
    "gen_src_tinynet": ("engine", "xla", "§1 item 3: gen_src_dir; §1 item 11"),
    "err_bad_mode": ("mode_list", "", "§1 items 9-10: the port's mode list grows to boda_tpu's"),
}

# test_all.xml suite cli_str -> (reason, what, ROADMAP item)
NOT_RUN_SUITES = {
    "test_compute --model=mini_resnet --img=2 --n-wins=1 --engines=(oracle=(mode=xla),"
    "bf16=(mode=pallas,compute_tn=bfloat16,precision=default,kernel_policy=gen)) "
    "--mrd-toler=3e-2": ("engine", "xla, pallas",
                         "§1 item 11: boda_tpu's TPU engines are not ported"),
}

# modes that need the native library (native/boda_native.cc)
NATIVE_MODES = ("serve_bench", "serve_stages")


def skip_text(reason: str, what: str, item: str) -> str:
    if reason == "mode":
        why = f"mode {what!r} is not registered in the port"
    elif reason == "engine":
        why = f"its conv_fwd type ({what}) is not in the port"
    elif reason == "mode_list":
        why = "it pins boda_tpu's full mode list"
    else:
        why = f"differs on the card: {what}"
    return f"{why} (ROADMAP {item})"


def diff_file(good_fn: str, new_fn: str, digest_mrd: float = 1e-5) -> str:
    """Return '' if same, else a human-readable diff (per-filetype)."""
    if good_fn.endswith(".txt") or good_fn.endswith(".log") or \
            good_fn.endswith(".wis"):
        with open(good_fn, errors="replace") as f:
            good = f.readlines()
        with open(new_fn, errors="replace") as f:
            new = f.readlines()
        if good == new:
            return ""
        return "".join(difflib.unified_diff(good, new, "good", "new", n=1))
    if good_fn.endswith(".boda"):  # digest streams: tolerance-compare
        from ..utils.digest import DigestStream
        g = DigestStream.load(good_fn).as_dict()
        n = DigestStream.load(new_fn).as_dict()
        if set(g) != set(n):
            return f"digest entries differ: {sorted(set(g) ^ set(n))}\n"
        # default 1e-5 (tight): shallow/per-layer digests pin real numerics;
        # deep whole-net entries opt in to a looser per-entry bound via the
        # XML digest_mrd= attribute
        bad = [f"{k}: mrd {g[k].mrd_comp(n[k]):.3g}\n"
               for k in g if g[k].mrd_comp(n[k]) > digest_mrd]
        return "".join(bad)
    if filecmp.cmp(good_fn, new_fn, shallow=False):
        return ""
    return f"binary files differ: {os.path.basename(good_fn)}\n"


def _walk_rel(d: str, skip_hidden: bool = False) -> list[str]:
    """All file paths under d, relative, sorted (subdirs included)."""
    out = []
    for root, _dirs, files in os.walk(d):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), d)
            if skip_hidden and any(p.startswith(".")
                                   for p in rel.split(os.sep)):
                continue
            out.append(rel)
    return sorted(out)


def diff_dirs(good_dir: str, new_dir: str, digest_mrd: float = 1e-5) -> str:
    out = []
    good_files = _walk_rel(good_dir) if os.path.isdir(good_dir) else []
    new_files = _walk_rel(new_dir, skip_hidden=True)
    if good_files != new_files:
        out.append(f"file sets differ: good={good_files} new={new_files}\n")
    for f in good_files:
        if f in new_files:
            d = diff_file(os.path.join(good_dir, f), os.path.join(new_dir, f),
                          digest_mrd=digest_mrd)
            if d:
                out.append(f"--- {f}:\n{d}")
    return "".join(out)


def _native_skip(cli_str: str) -> str:
    """'' or why an entry whose mode needs the native library skips here."""
    argv = _split_cli(cli_str or "")
    if not argv or argv[0] not in NATIVE_MODES:
        return ""
    from ..utils.native import why_unavailable
    why = why_unavailable()
    return why and (f"{argv[0]} needs the native library (native/boda_native.cc), "
                    f"which did not build here: {why}")


@register("mode", "test_cmds", help="golden-output-dir command regression tests")
class TestCmds(Mode):
    xml_fn = Field("filename", default="%(boda_test_dir)/test_cmds.xml",
                   help="XML test list")
    good_dir = Field("filename", default="%(boda_test_dir)/good_tr",
                     help="archived known-good output dirs")
    filt = Field(str, default="", help="regex: run only matching test names")
    update_failing = Field(bool, default="0", help="re-archive failing tests' outputs")
    run_slow = Field(bool, default="0", help="include slow=1 tests")
    verbose = Field(bool, default="0", help="print each test name")

    def main(self) -> None:
        root = ET.parse(self.xml_fn).getroot()
        n_run = n_pass = n_skip = 0
        failures: list[str] = []
        for li in root.iter("li"):
            name = li.get("test_name")
            if not name:
                raise ConfigError(f"{self.xml_fn}: <li> missing test_name")
            if self.filt and not re.search(self.filt, name):
                continue
            if li.get("slow") == "1" and not self.run_slow:
                n_skip += 1
                continue
            needs = li.get("needs", "")
            if needs and not all(is_feature_enabled(f) for f in needs.split(",")):
                n_skip += 1
                continue
            why = (skip_text(*NOT_RUN[name]) if name in NOT_RUN
                   else _native_skip(li.get("cli_str")))
            if why:
                print(f"SKIP {name}: {why}")
                n_skip += 1
                continue
            n_run += 1
            ok, msg = self._run_one(name, li)
            if ok:
                n_pass += 1
                if self.verbose:
                    print(f"PASS {name}")
            else:
                failures.append(f"FAIL {name}: {msg}")
                print(failures[-1])
        print(f"test_cmds: {n_pass}/{n_run} passed, {n_skip} skipped "
              f"({os.path.basename(self.xml_fn)})")
        if failures:
            sys.exit(1)

    def _run_one(self, name: str, li) -> tuple[bool, str]:
        from ..config import instantiate
        cli_str = li.get("cli_str")
        expect_err = li.get("err")
        out_dir = self.out_path(os.path.join("tr", name))
        if os.path.exists(out_dir):
            shutil.rmtree(out_dir)
        os.makedirs(out_dir)
        argv = _split_cli(cli_str)
        stdout = io.StringIO()
        err_msg = None
        try:
            l = lexp_from_argv(argv)
            l.add("boda_output_dir", out_dir)
            with contextlib.redirect_stdout(stdout):
                mode = instantiate("mode", l, check_unused_keys=True)
                run_mode(mode)
        except (ConfigError, LexpError, ValueError, RuntimeError) as e:
            err_msg = str(e)
        except SystemExit as e:
            if e.code:
                err_msg = f"exit code {e.code}"
        with open(os.path.join(out_dir, "test_out.txt"), "w") as f:
            f.write(stdout.getvalue())
        if expect_err is not None:
            if err_msg is None:
                return False, f"expected error {expect_err!r}, got none"
            if expect_err != err_msg:  # exact match (ref test_nesi.cc:546-560)
                return False, f"expected error {expect_err!r}, got {err_msg!r}"
            return True, ""
        if err_msg is not None:
            return False, f"unexpected error: {err_msg}"
        good = os.path.join(self.good_dir, name)
        if not os.path.isdir(good):
            if self.update_failing:
                shutil.copytree(out_dir, good)
                return True, ""
            return False, f"no known-good archive at {good} (use --update-failing=1)"
        d = diff_dirs(good, out_dir, digest_mrd=float(li.get("digest_mrd", "1e-5")))
        if d and self.update_failing:
            shutil.rmtree(good)
            shutil.copytree(out_dir, good)
            return True, ""
        return (not d), d


def _split_cli(s: str) -> list[str]:
    """Split a cli_str on spaces, honoring single quotes."""
    import shlex
    return shlex.split(s)


@register("mode", "test_all", help="run the full test-suite list")
class TestAll(Mode):
    xml_fn = Field("filename", default="%(boda_test_dir)/test_all.xml",
                   help="XML listing <li cli_str=.../> suite commands")
    run_slow = Field(bool, default="0", help="include slow suites")

    def main(self) -> None:
        from ..config import instantiate
        root = ET.parse(self.xml_fn).getroot()
        n_fail = 0
        for li in root.iter("li"):
            if li.get("slow") == "1" and not self.run_slow:
                continue
            cli_str = li.get("cli_str")
            if cli_str in NOT_RUN_SUITES:
                print(f"SKIP {cli_str}: {skip_text(*NOT_RUN_SUITES[cli_str])}")
                continue
            argv = _split_cli(cli_str)
            print(f"=== {cli_str}")
            try:
                l = lexp_from_argv(argv)
                if l.get_kid("boda_output_dir") is None:
                    l.add("boda_output_dir", self.boda_output_dir)
                mode = instantiate("mode", l, check_unused_keys=True)
                run_mode(mode)
            except SystemExit as e:
                if e.code:
                    n_fail += 1
            except (ConfigError, LexpError, ValueError, RuntimeError) as e:
                print(f"error: {e}")
                n_fail += 1
        print(f"test_all: {'PASS' if n_fail == 0 else f'{n_fail} suites FAILED'}")
        if n_fail:
            sys.exit(1)
