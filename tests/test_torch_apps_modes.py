"""The port's app modes on the CPU (boda_tpu_torch/modes/apps.py): the corpus
goldens cnet_predict_mini, conv_pyra_mini, test_dense_mini, test_upsamp_mini,
predict_dense_annos, img_pyra_pack_t1 and blf_pack_basic through the port's
CLI, each output dir byte-equal to testdata/good_tr's, with the engines on
the CPU (``--conv-fwd=(mode=cuda,device=cpu)``, test_upsamp's
``--device=cpu``); and ``cnet_predict --enable-upsamp-net=1`` against
boda_tpu's CLI on the same images."""

import json
import os
import xml.etree.ElementTree as ET

import pytest

from boda_tpu_torch import cli
from boda_tpu_torch.modes.test_cmds import _split_cli, diff_dirs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
CPU_ENGINE = "--conv-fwd=(mode=cuda,device=cpu)"
# golden -> the argument that puts its engines on the CPU ('' : no engine)
GOLDENS = {
    "cnet_predict_mini": (CPU_ENGINE,),
    "conv_pyra_mini": (CPU_ENGINE,),
    "test_dense_mini": (CPU_ENGINE,),
    "test_upsamp_mini": ("--device=cpu",),
    "predict_dense_annos": (CPU_ENGINE,),
    "pyramids": ("img_pyra_pack_t1", "blf_pack_basic"),  # device-free, one case
}


def _corpus_argv(name: str) -> list[str]:
    li = next(li for li in ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")
              if li.get("test_name") == name)
    return [a.replace("%(boda_test_dir)", TD) for a in _split_cli(li.get("cli_str"))]


def _run_golden(name: str, extra: list[str], tmp_path, capsys) -> str:
    out = tmp_path / name
    out.mkdir()
    rc = cli.main(_corpus_argv(name) + extra + [f"--boda-output-dir={out}"])
    (out / "test_out.txt").write_text(capsys.readouterr().out)
    assert rc == 0, name
    return diff_dirs(os.path.join(TD, "good_tr", name), str(out))


@pytest.mark.parametrize("case", list(GOLDENS))
def test_app_goldens(case, tmp_path, capsys):
    runs = ([(n, []) for n in GOLDENS[case]] if case == "pyramids"
            else [(case, list(GOLDENS[case]))])
    for name, extra in runs:
        d = _run_golden(name, extra, tmp_path, capsys)
        assert d == "", f"{name}:\n{d}"


def test_cnet_predict_upsamp_net_matches_boda_tpu(capsys):
    import boda_tpu.modes_all  # noqa: F401
    from boda_tpu.cli import main as jmain
    from boda_tpu.config import default_cfg_init
    default_cfg_init(REPO)
    fns = (f"--img-fns=(a={TD}/images/test1.png,b={TD}/images/test2.jpg)")
    argv = ["cnet_predict", "--model=mini_resnet", fns, "--enable-upsamp-net=1",
            "--top-n=16", "--scale=0.005"]
    assert jmain(argv + ["--conv-fwd=(mode=xla)"]) == 0
    # boda_tpu's xla engine also prints its timer table
    want = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert cli.main(argv + [CPU_ENGINE]) == 0
    got = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [g["img"] for g in got] == [w["img"] for w in want] == ["test1.png", "test2.jpg"]
    for g, w in zip(got, want):
        pg = {t["cls"]: t["p"] for t in g["top"]}
        pw = {t["cls"]: t["p"] for t in w["top"]}
        assert set(pg) == set(pw) == set(range(16))
        assert max(abs(pg[c] - pw[c]) for c in pg) <= 2e-5, (g, w)  # p printed to 5 places
        assert 0.2 < max(pg.values()) < 0.95  # not one-hot: the comparison sees the probs
