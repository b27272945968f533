"""The port's detection modes against boda_tpu's goldens and output, on the CPU.

The commands of testdata/test_cmds.xml:99-109 (detect_tinyssd,
err_detect_no_head, score_fixture, load_pil_voc and detect_ssd300_scored)
run in process through ``boda_tpu_torch.cli`` in a scratch directory, the
detection ones on ``--conv-fwd=(mode=cuda,device=cpu)``, the kernels' plain
versions: stdout must be the golden test_out.txt, and a written dets.txt
the golden copy (ssd300's within the bounds of boda_tpu's own cross-engine
test, tests/test_detect.py:52-55: the same image and class per row, score
within 1e-3, boxes within 0.15 px). ``score_files``, and the errors of
``score_files`` and ``load_pil``, against boda_tpu's CLI on the same files.
ssd300 at b1 in f32 against boda_tpu's ``(mode=xla)``: every node at
comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|), and detection_out at
tests/test_detect.py:95-98's bounds.
"""

import io
import os
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu import cli as jcli
from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.timers import GLOBAL_TIMER_LOG
from boda_tpu_torch import cli
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.utils.carry import weights_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOOD = os.path.join(REPO, "testdata", "good_tr")
CPU = "--conv-fwd=(mode=cuda,device=cpu)"
T = "%(boda_test_dir)"

_CMDS = {
    "detect_tinyssd": ["cnet_detect", f"--ptt-fn={T}/nets/tinyssd.prototxt",
                       "--conf-thresh=0.3", CPU],
    "err_detect_no_head": ["cnet_detect", "--model=mini_resnet", CPU],
    "score_fixture": ["score", f"--dets-fn={T}/score/dets.txt", f"--gt-fn={T}/score/gt.txt"],
    "load_pil_voc": ["load_pil", f"--ann-dir={T}/voc/ann", f"--img-list-fn={T}/voc/list.txt"],
}


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _jrun(argv):
    """boda_tpu's CLI, as _run; its timer table (printed at exit when an
    earlier test in the process left timings) reset first."""
    GLOBAL_TIMER_LOG.reset()
    return _run(jcli.main, argv)


def _golden(name, fn="test_out.txt"):
    with open(os.path.join(GOOD, name, fn)) as f:
        return f.read()


def _dets(text):
    return [(p[0], p[1], float(p[2]), [float(v) for v in p[3:]])
            for p in (ln.split() for ln in text.splitlines() if not ln.startswith("#"))]


@pytest.mark.parametrize("name", sorted(_CMDS))
def test_golden_output(name, tmp_path, monkeypatch):
    """The golden's stdout; dets.txt the golden's copy; err_detect_no_head's
    error the harness's text (testdata/test_cmds.xml:101); load_pil's four
    invalid lists (testdata/voc/list_inv*.txt) boda_tpu's errors."""
    monkeypatch.chdir(tmp_path)
    rc, out, err = _run(cli.main, _CMDS[name])
    if name == "err_detect_no_head":
        assert rc == 1 and out == ""
        assert err == "error: net has no DetectionOutput op; use --out-node-name=\n"
        return
    assert rc == 0 and out == _golden(name), (out, err)
    if name == "detect_tinyssd":
        assert (tmp_path / "dets.txt").read_text() == _golden(name, "dets.txt")
    if name == "load_pil_voc":
        for i in range(1, 5):
            argv = ["load_pil", f"--ann-dir={T}/voc/ann", f"--img-list-fn={T}/voc/list_inv{i}.txt"]
            got, want = _run(cli.main, argv), _jrun(argv)
            assert got == want and got[0] == 1 and got[2].startswith("error: "), i


def test_score_files_matches_boda_tpu(tmp_path, monkeypatch):
    """Per-class results files cut from testdata/score/dets.txt, scored for
    car, person and bus (no gt: an AP=0 row): the same stdout and summary
    file as boda_tpu's, in f32 and with the 11-point metric; a line of the
    wrong width gives boda_tpu's error."""
    monkeypatch.chdir(tmp_path)
    rows = _dets(open(os.path.join(REPO, "testdata", "score", "dets.txt")).read())
    for cls in ("car", "person", "bus"):
        with open(f"res_{cls}.txt", "w") as f:
            f.write("# img_id score x0 y0 x1 y1\n")
            f.writelines(f"{r[0]} {r[2]} {' '.join(str(v) for v in r[3])}\n"
                         for r in rows if r[1] == cls)
    gt = os.path.join(REPO, "testdata", "score", "gt.txt")
    for extra in ([], ["--use-07-metric=1"]):
        argv = ["score_files", "--res-fn=res_%s.txt", "--classes=(a=car,b=person,c=bus)",
                f"--gt-fn={gt}"] + extra
        got = _run(cli.main, argv + ["--summary-fn=t.txt"])
        want = _jrun(argv + ["--summary-fn=j.txt"])
        assert got == want and got[0] == 0 and "class bus" in got[1], (got, want)
        assert open("t.txt").read() == open("j.txt").read() == got[1]
    with open("res_bus.txt", "a") as f:
        f.write("img1 0.5 1 2 3\n")
    argv = ["score_files", "--res-fn=res_%s.txt", "--classes=(a=car,b=bus)", f"--gt-fn={gt}"]
    got, want = _run(cli.main, argv), _jrun(argv)
    assert got == want and got[0] == 1 and "want 6 fields" in got[2]


def test_ssd300_matches_boda_tpu():
    """ssd300 b1 300x300 f32 (8,732 priors, top_k 400, keep_top_k 200): the
    same ops and seeded weights as boda_tpu's zoo, bit for bit, which
    ``weights_from_numpy`` carries (conv4_3_norm's scale blob among them);
    on gen_data every node against boda_tpu's (mode=xla) engine, and
    detection_out at tests/test_detect.py:95-98's bounds."""
    jp, jd = jbuild("ssd300", img=1)
    tp, td = tbuild("ssd300", img=1)
    assert [(o.type, o.params, o.bots, o.tops) for o in jp.ops.values()] == \
        [(o.type, o.params, o.bots, o.tops) for o in tp.ops.values()]
    assert sorted(jp.weights) == sorted(tp.weights) and "conv4_3_norm__scales" in tp.weights
    for k, w in jp.weights.items():
        assert np.array_equal(w.data, tp.weights[k].data), k
    weights_from_numpy(tp, {k: w.data * 2 for k, w in jp.weights.items()})
    assert float(tp.weights["conv4_3_norm__scales"].data[0]) == 40.0
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    nodes = [n for n, node in jp.nodes.items()
             if node.dims is not None and n not in jp.weights and node.top_for]
    ins = gen_data_inputs(td)
    je = jmake("conv_fwd", "xla")
    je.init(jp)
    jr = je.run_fwd({"data": JNDA(jd["data"], ins["data"].data)}, nodes)
    te = tmake("conv_fwd", "cuda", device="cpu")
    te.init(tp)
    tr = te.run_fwd(ins, nodes)
    for n in nodes:
        if n == "detection_out":
            continue
        a, b = jr[n].data, tr[n].data
        r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
        assert a.shape == b.shape and r.ok(), f"node {n}: {r}"
    a, b = jr["detection_out"].data[0, 0], tr["detection_out"].data[0, 0]
    assert a.shape == b.shape == (200, 7) and np.isfinite(b).all()
    assert (b[:, 2] >= 0).all() and (b[:, 2] <= 1).all()
    assert np.array_equal(a[:, 1], b[:, 1])
    assert np.allclose(a[:, 2], b[:, 2], atol=1e-3)
    assert np.allclose(a[:, 3:], b[:, 3:], atol=1e-3)


def test_detect_ssd300_scored(tmp_path, monkeypatch):
    """testdata/test_cmds.xml:107: the golden's per-class AP lines and
    mAP=0.4896 exactly; dets.txt row by row within 1e-3 in score and 0.15 px
    in the boxes."""
    monkeypatch.chdir(tmp_path)
    rc, out, err = _run(cli.main, ["cnet_detect", "--model=ssd300", "--conf-thresh=0.05",
                                   f"--gt-fn={T}/score/ssd300_gt.txt", CPU])
    name = "detect_ssd300_scored"
    assert rc == 0 and out == _golden(name), (out, err)
    assert "mAP=0.4896 over 4 classes" in out
    got, want = _dets((tmp_path / "dets.txt").read_text()), _dets(_golden(name, "dets.txt"))
    assert len(got) == len(want) == 200
    for (ia, ca, sa, ba), (ib, cb, sb, bb) in zip(got, want):
        assert (ia, ca) == (ib, cb) and abs(sa - sb) < 1e-3
        assert np.allclose(ba, bb, atol=0.15)
