"""The port's display, proc_pipe and plot modes (boda_tpu_torch/modes/
display_modes.py, proc_pipe.py, plot_modes.py) on the CPU: display_stream
and wis_plot pixel for pixel against boda_tpu's; cs_disp's worker processes
running this package and no JAX; the PIL gate of the corpus entries that
need it; roofline_plot's peaks the card's, with no TPU default; the plot
modes' error without matplotlib; the no-camera errors."""

import os

import pytest

from boda_tpu_torch import cli
from boda_tpu_torch.config import class_fields
from boda_tpu_torch.modes import plot_modes, proc_pipe
from boda_tpu_torch.modes import test_cmds as tc
from parity_modes import assert_same_outputs, run_both


@pytest.mark.parametrize("src", ["(stream=img-dir-src,dir=%(boda_test_dir)/images,glob=test)",
                                 "(stream=avi-mjpeg-src,fn=%(boda_test_dir)/streams/mini.avi)"])
def test_display_stream_matches_boda_tpu(src, tmp_path):
    """display_stream's frames, pixel for pixel, and its line."""
    res = run_both([["display_stream", f"--src={src}", "--max-frames=3"]], tmp_path)
    (jo, je, jf), (to, te, tf) = res["boda_tpu"], res["boda_tpu_torch"]
    assert je == te == (None,) and to == jo
    assert tf and all(k.endswith(".png") for k in tf)
    assert_same_outputs(jf, tf)


def test_cs_disp_workers_run_the_port(tmp_path, monkeypatch):
    """cs_disp spawns both workers as ``python -m boda_tpu_torch``, and they
    run with a ``jax`` and an ``ml_dtypes`` on their path that fail on
    import: neither imports either (nor boda_tpu, which imports JAX)."""
    poison = tmp_path / "poison"
    for m in ("jax", "ml_dtypes"):
        (poison / m).mkdir(parents=True)
        (poison / m / "__init__.py").write_text(f"raise ImportError('{m} is not here')\n")
    monkeypatch.setenv("PYTHONPATH", str(poison))
    cmds, real = [], proc_pipe.subprocess.Popen

    def popen(cmd, **kw):
        cmds.append(cmd)
        return real(cmd, **kw)
    monkeypatch.setattr(proc_pipe.subprocess, "Popen", popen)
    out = tmp_path / "out"
    rc = cli.main(["cs_disp", "--src=(stream=img-dir-src,dir=%(boda_test_dir)/images,glob=test)",
                   f"--boda-output-dir={out}"])
    assert rc == 0
    assert [c[1:4] for c in cmds] == [["-m", "boda_tpu_torch", "proc_ipc"],
                                      ["-m", "boda_tpu_torch", "display_ipc"]]
    assert sorted(os.listdir(out)) == ["frame_0000.png", "frame_0001.png"]


def test_pil_entries_skip_without_pil(tmp_path, monkeypatch, capsys):
    """Without PIL, the corpus entries that need it skip, naming it."""
    monkeypatch.setattr(tc, "is_feature_enabled", lambda f: f != "PIL")
    filt = "^(" + "|".join(tc.PIL_ENTRIES) + ")$"
    assert cli.main(["test_cmds", f"--filt={filt}", f"--boda-output-dir={tmp_path}"]) == 0
    out = capsys.readouterr().out
    for name in tc.PIL_ENTRIES:
        assert (f"SKIP {name}: {name} reads or writes images through PIL, which is not "
                "installed here") in out
    assert f"test_cmds: 0/0 passed, {len(tc.PIL_ENTRIES)} skipped" in out


def _png(tmp_path, argv):
    from PIL import Image
    out = tmp_path / str(len(list(tmp_path.iterdir())))
    assert cli.main(argv + [f"--boda-output-dir={out}"]) == 0
    (fn,) = os.listdir(out)
    with Image.open(out / fn) as im:
        return im.convert("RGBA").tobytes()


def test_roofline_plot_peaks_are_the_cards(tmp_path):
    """roofline_plot's peaks default to the card's (an H100 SXM's dense bf16
    rate and HBM3 bandwidth, named in the help), none of boda_tpu's
    defaults in the source; given the card's peaks, boda_tpu draws the
    port's default chart, pixel for pixel."""
    from boda_tpu import config as jcfg
    from boda_tpu.modes import plot_modes as jplot
    src = open(plot_modes.__file__).read()
    fields = [f for f in class_fields(plot_modes.RooflinePlot) if f.name.startswith("peak")]
    jfields = [f for f in jcfg.class_fields(jplot.RooflinePlot) if f.name.startswith("peak")]
    assert len(fields) == len(jfields) == 2
    assert all(f.default == "0" and "H100" in f.help for f in fields)
    assert not any(f.default in src for f in jfields)
    base = ["roofline_plot", "--model=mini_resnet", "--img=2"]
    card = ["--peak-flops=989e12", "--peak-bw=3.35e12"]
    mine = _png(tmp_path, base)
    assert mine == _png(tmp_path, base + card)
    res = run_both([base + card], tmp_path / "both")
    assert_same_outputs(res["boda_tpu"][2], res["boda_tpu_torch"][2])
    from PIL import Image
    with Image.open(tmp_path / "both" / "boda_tpu" / "roofline.png") as im:
        assert im.convert("RGBA").tobytes() == mine


def test_wis_plot_matches_boda_tpu(tmp_path):
    """wis_plot of one wisdom file (written by the port): the same chart."""
    from boda_tpu_torch.ops.op_base import Op
    from boda_tpu_torch.prof.wisdom import OpRun, OpWisdom, write_wisdom
    w = OpWisdom(Op.parse("(type=sgemm,a=(M=8,K=8),b=(K=8,N=8),c=(M=8,N=8))"))
    w.runs += [OpRun("()", "p", 1e-4), OpRun("(bm=8)", "p", 2e-4)]
    fn = tmp_path / "w.wis"
    write_wisdom(str(fn), [w])
    res = run_both([["wis_plot", f"--wisdom-fn={fn}"]], tmp_path)
    (jo, je, jf), (to, te, tf) = res["boda_tpu"], res["boda_tpu_torch"]
    assert je == te == (None,) and to == jo and list(tf) == ["wisdom.png"]
    assert_same_outputs(jf, tf)


def test_plot_modes_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib both plot modes fail with an error naming it."""
    monkeypatch.setattr(plot_modes, "is_feature_enabled", lambda f: f != "matplotlib")
    for argv in (["roofline_plot", "--model=mini_resnet"],
                 ["wis_plot", "--wisdom-fn=w.wis"]):
        assert cli.main(argv + [f"--boda-output-dir={tmp_path}"]) == 1
        err = capsys.readouterr().err
        assert "error: matplotlib feature not enabled in this build" in err, err
    assert not list(tmp_path.iterdir())


def test_camera_modes_fail_as_boda_tpu(tmp_path):
    """capture_classify and capture_feats: boda_tpu's no-camera error."""
    for mode in ("capture_classify", "capture_feats"):
        res = run_both([[mode]], tmp_path / mode)
        (_, je, _), (_, te, _) = res["boda_tpu"], res["boda_tpu_torch"]
        assert te == je and te[0].startswith(f"{mode}: no V4L2 camera")
