"""What the stream, display and plot tests run through both packages: a
command line in process through each package's run_mode, and what it
wrote."""

import contextlib
import importlib
import io
import os
import shlex
import xml.etree.ElementTree as ET

import numpy as np

import boda_tpu.modes_all  # noqa: F401
import boda_tpu_torch.modes_all  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
PKGS = ("boda_tpu", "boda_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def run_mode_in(pkg, argv, out_dir):
    """One command line in process through ``pkg``'s run_mode: (stdout, the
    error text or None)."""
    cfg, lexp = _mod(pkg, "config"), _mod(pkg, "utils.lexp")
    cfg.default_cfg_init(REPO)
    buf, err = io.StringIO(), None
    l = lexp.lexp_from_argv(list(argv))
    l.add("boda_output_dir", str(out_dir))
    try:
        with contextlib.redirect_stdout(buf):
            cfg.run_mode(cfg.instantiate("mode", l, check_unused_keys=True))
    except (cfg.ConfigError, lexp.LexpError, ValueError, RuntimeError) as e:
        err = str(e)
    return buf.getvalue(), err


def dir_contents(d):
    """Every file under d: a PNG's pixels, any other file's bytes."""
    from PIL import Image
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            fn = os.path.join(root, f)
            rel = os.path.relpath(fn, d)
            if f.endswith(".png"):
                with Image.open(fn) as im:
                    out[rel] = np.asarray(im.convert("RGBA"))
            else:
                with open(fn, "rb") as fh:
                    out[rel] = fh.read()
    return out


def assert_same_outputs(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def run_both(argvs, tmp_path):
    """The command lines in turn through each package, each package in its
    own output dir; returns {pkg: (stdouts, errors, files)}."""
    res = {}
    for pkg in PKGS:
        out_dir = tmp_path / pkg
        out_dir.mkdir(parents=True)
        outs, errs = zip(*(run_mode_in(pkg, argv, out_dir) for argv in argvs))
        res[pkg] = (outs, errs, dir_contents(out_dir))
    return res


def corpus_argv(name):
    """A corpus entry's command line and the error it pins (or None)."""
    for li in ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li"):
        if li.get("test_name") == name:
            return shlex.split(li.get("cli_str")), li.get("err")
    raise KeyError(name)
