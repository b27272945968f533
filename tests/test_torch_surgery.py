"""The port's net surgery against boda_tpu's, on the CPU: fc_to_conv,
resize_conv and upsample_2x_net give the same pipe and weights in both
packages, pipe_to_prototxt the same text and write_caffemodel the same
bytes; the caffemodel reader the same blobs and ``dump_textproto`` the same
text; the surgery modes' goldens (testdata/good_tr, the commands of
testdata/test_cmds.xml:24-26,61) and the frontend's three error goldens
(test_cmds.xml:20-22), run in process as tests/test_torch_rtc_golden.py
runs its own."""

import io
import os
import xml.etree.ElementTree as ET
from contextlib import redirect_stdout

import numpy as np
import pytest

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu.frontend import caffemodel as jcm
from boda_tpu.frontend import surgery as jsur
from boda_tpu.frontend.pipe_builder import pipe_from_prototxt as jfrom
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu_torch import cli
from boda_tpu_torch.frontend import caffemodel as tcm
from boda_tpu_torch.frontend import surgery as tsur
from boda_tpu_torch.frontend.caffemodel import read_caffemodel
from boda_tpu_torch.frontend.pipe_builder import pipe_from_prototxt as tfrom
from boda_tpu_torch.models.zoo import build_model as tbuild

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
GOOD = os.path.join(TD, "good_tr")
_CMDS = {li.get("test_name"): li for li in
         ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")}


def _pipes(net):
    if net.endswith(".prototxt"):
        cm = net.replace(".prototxt", ".caffemodel")
        kw = {"weights_fn": os.path.join(TD, "nets", cm)} if net.startswith("shapes") else {}
        fn = os.path.join(TD, "nets", net)
        return jfrom(fn, **kw)[0], tfrom(fn, **kw)[0]
    return jbuild(net, img=1, in_sz=64)[0], tbuild(net, img=1, in_sz=64)[0]


def _same(jp, tp):
    assert list(jp.ops) == list(tp.ops)
    for k, a in jp.ops.items():
        b = tp.ops[k]
        assert (a.type, a.params, a.bots, a.tops) == (b.type, b.params, b.bots, b.tops), k
    for n, node in jp.nodes.items():
        da, db = node.dims, tp.nodes[n].dims
        assert (da is None) == (db is None) and (da is None or da.sizes == db.sizes), n
    assert sorted(jp.weights) == sorted(tp.weights)
    for k, w in jp.weights.items():
        assert np.array_equal(w.data, tp.weights[k].data), k


_SURGERY = {
    "fc_to_conv": lambda s, p: s.fc_to_conv(p),
    "resize_conv": lambda s, p: s.resize_conv(p, next(o for o in p.topo_op_order()
                                                      if p.ops[o].type == "Convolution"),
                                              (5, 5)),
    "upsample_2x_net": lambda s, p: s.upsample_2x_net(p),
}


@pytest.mark.parametrize("op", sorted(_SURGERY))
def test_surgery_identical(op):
    for net in ("tinynet.prototxt", "shapesnet2.prototxt", "googlenet_conv"):
        jp, tp = _pipes(net)
        assert _SURGERY[op](jsur, jp) == _SURGERY[op](tsur, tp), net
        _same(jp, tp)


# net -> whether the written pair reads back to the same pipe: both writers
# write no scale_param, so a Scale with a bias (shapesnet3's) reads back
# without it
_WRITERS = {"tinynet.prototxt": True, "shapesnet3.prototxt": False,
            "googlenet_conv": True, "squeezenet": True}


def test_writers_identical(tmp_path):
    for net in sorted(_WRITERS):
        _writers_identical(net, tmp_path)


def _writers_identical(net, tmp_path):
    """pipe_to_prototxt's text and write_caffemodel's bytes are boda_tpu's;
    the written pair reads back to the same pipe and weights."""
    jp, tp = _pipes(net)
    text = tsur.pipe_to_prototxt(tp)
    assert text == jsur.pipe_to_prototxt(jp)
    jsur.write_caffemodel(str(tmp_path / "j.caffemodel"), jp)
    tsur.write_caffemodel(str(tmp_path / "t.caffemodel"), tp)
    assert (tmp_path / "j.caffemodel").read_bytes() == (tmp_path / "t.caffemodel").read_bytes()
    if not _WRITERS[net]:
        assert "scale_param" not in text and "bias_term" not in text
        return
    (tmp_path / "t.prototxt").write_text(text)
    back, _ = tfrom(str(tmp_path / "t.prototxt"), str(tmp_path / "t.caffemodel"))
    assert [o.type for o in back.ops.values()] == [o.type for o in tp.ops.values()]
    for k, w in tp.weights.items():
        assert np.array_equal(back.weights[k].data, w.data), k
    assert sorted(read_caffemodel(str(tmp_path / "t.caffemodel"))) == sorted(
        {o.name for o in tp.ops.values() if any(b in tp.weights for b in o.bots)})


def _argv(name):
    return _CMDS[name].get("cli_str").replace("%(boda_test_dir)", TD).split()


def test_golden_output(tmp_path, monkeypatch):
    for name in ("cnet_bpt_dump_tiny", "cnet_copy_tinynet", "cnet_util_tinynet",
                 "fc_to_conv_tinynet"):
        os.mkdir(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli.main(_argv(name))
        assert rc == 0, name
        gdir = os.path.join(GOOD, name)
        for fn in sorted(os.listdir(gdir)):
            got = buf.getvalue() if fn == "test_out.txt" else (tmp_path / name / fn).read_text()
            with open(os.path.join(gdir, fn)) as f:
                assert got == f.read(), (name, fn)


def test_error_golden(capsys):
    for name in ("err_ptt_bad_syntax", "err_ptt_no_file", "err_weights_no_file"):
        with redirect_stdout(io.StringIO()):
            assert cli.main(_argv(name)) == 1, name
        assert capsys.readouterr().err == f"error: {_CMDS[name].get('err')}\n"


def test_caffemodel_reader_and_dump_identical():
    for cm in ("tinynet", "shapesnet", "shapesnet2", "shapesnet3"):
        fn = os.path.join(TD, "nets", f"{cm}.caffemodel")
        jb, tb = jcm.read_caffemodel(fn), tcm.read_caffemodel(fn)
        assert list(jb) == list(tb), cm
        for k in jb:
            assert [(b.shape, b.data.tobytes()) for b in jb[k]] == \
                [(b.shape, b.data.tobytes()) for b in tb[k]], (cm, k)
        with open(fn, "rb") as f:
            buf = f.read()
        for remove in (True, False):
            assert jcm.dump_textproto(buf, remove) == tcm.dump_textproto(buf, remove), cm
