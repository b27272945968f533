"""Real data in, against boda_tpu, on the CPU: every record file of
testdata/lmdb parses to boda_tpu's datums; the datum and block-stream
writers give boda_tpu's bytes, ND blocks (bf16 too) cross between the two
packages; the image and preprocessing helpers give boda_tpu's arrays; the
goldens lmdb_parse_fixture (rec_0.png's pixels), test_lmdb_mini,
test_lmdb_shapesnet_trained and test_lmdb_shapesnet2_trained
(testdata/test_cmds.xml:77-89) run in process on the port's engine
(``device=cpu``); and the optional modules: ``read_lmdb_records`` without
``lmdb`` and the image codecs without PIL raise boda_tpu's errors, a resize
to an image's own size needs no PIL, and ``test_lmdb --ckpt-fn`` names the
ROADMAP item that brings training."""

import glob
import io
import os
import sys
import xml.etree.ElementTree as ET
from contextlib import redirect_stdout

import numpy as np
import pytest

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu.apps import preproc as jpre
from boda_tpu.frontend import datum as jdatum
from boda_tpu.stream import data_stream as jds
from boda_tpu.utils import img_io as jimg
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch import cli
from boda_tpu_torch.apps import preproc as tpre
from boda_tpu_torch.config import ConfigError
from boda_tpu_torch.frontend import datum as tdatum
from boda_tpu_torch.stream import data_stream as tds
from boda_tpu_torch.utils import img_io as timg
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.dims import Dims as TDims

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
GOOD = os.path.join(TD, "good_tr")
RECS = sorted(glob.glob(os.path.join(TD, "lmdb", "*.rec")))
_CMDS = {li.get("test_name"): li for li in
         ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")}


def _datums(mod, fn):
    return [(k, d.chan, d.y, d.x, d.label, d.data.dtype, d.data.tobytes())
            for k, d in ((k, mod.parse_datum(v)) for k, v in mod.read_rec_records(fn))]


def test_record_files_parse_as_boda_tpu(tmp_path):
    """Every testdata/lmdb record file: the same keys and datums; the
    encoder, the RGB conversions and the record writer give the same bytes."""
    assert len(RECS) == 7
    for fn in RECS:
        jd, td = _datums(jdatum, fn), _datums(tdatum, fn)
        assert jd == td and len(td) > 0, fn
    recs = list(tdatum.read_rec_records(RECS[0]))
    d = tdatum.parse_datum(recs[0][1])
    jd = jdatum.parse_datum(recs[0][1])
    assert tdatum.encode_datum(d) == jdatum.encode_datum(jd) == recs[0][1]
    assert np.array_equal(d.to_rgb(), jd.to_rgb())
    rgb = np.random.RandomState(1).randint(0, 256, (5, 6, 3)).astype(np.uint8)
    a, b = tdatum.rgb_to_datum(rgb, 3), jdatum.rgb_to_datum(rgb, 3)
    assert tdatum.encode_datum(a) == jdatum.encode_datum(b)
    ta, ja = str(tmp_path / "t.rec"), str(tmp_path / "j.rec")
    tdatum.write_rec_records(ta, [(k.decode(), v) for k, v in recs])
    jdatum.write_rec_records(ja, [(k.decode(), v) for k, v in recs])
    assert open(ta, "rb").read() == open(ja, "rb").read()


def test_block_stream_nd_blocks_cross(tmp_path):
    """ND blocks written by one package read back in the other with the
    same dims and values: f32, int8 and bf16 (boda_tpu's ml_dtypes bf16
    bytes; the port widens them to f32 on the host); a file without the
    magic raises in both."""
    import ml_dtypes
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 4).astype(np.float32)
    q = rng.randint(-128, 128, (6,)).astype(np.int8)
    jb = [jds.DataBlock(ts=1, tag="f", nda=JNDA(JDims.of(a=2, b=3, c=4), x)),
          jds.DataBlock(ts=2, tag="q", nda=JNDA(JDims.of(n=6, tn="int8"), q)),
          jds.DataBlock(ts=3, tag="h", nda=JNDA(JDims.of(a=2, b=3, c=4, tn="bfloat16"),
                                                x.astype(ml_dtypes.bfloat16))),
          jds.DataBlock(ts=4, tag="raw", data=b"abc")]
    jfn, tfn = str(tmp_path / "j.blk"), str(tmp_path / "t.blk")
    jds.write_block_stream(jfn, jb)
    tb = list(tds.read_block_stream(jfn))
    assert [(b.ts, b.tag, b.frame_ix) for b in tb] == [(1, "f", 0), (2, "q", 1), (3, "h", 2),
                                                       (4, "raw", 3)]
    want = [x, q, x.astype(ml_dtypes.bfloat16).astype(np.float32)]
    for b, w in zip(tb[:3], want):
        assert np.array_equal(b.nda.data.reshape(w.shape), w), b.tag
    assert tb[2].nda.dims.tn == "bfloat16" and tb[3].data == b"abc"
    tds.write_block_stream(tfn, [
        tds.DataBlock(ts=b.ts, tag=b.tag, nda=TNDA(b.nda.dims, b.nda.data)
                      if b.nda is not None else None, data=b.data) for b in tb])
    assert open(tfn, "rb").read() == open(jfn, "rb").read()
    (tmp_path / "bad.blk").write_bytes(b"notablockfile")
    for mod, err in ((tds, ConfigError), (jds, Exception)):
        with pytest.raises(err, match="not a block stream file"):
            list(mod.read_block_stream(str(tmp_path / "bad.blk")))


def _argv(name):
    return _CMDS[name].get("cli_str").replace("%(boda_test_dir)", TD).split()


@pytest.mark.parametrize("name", ["lmdb_parse_fixture", "test_lmdb_mini",
                                  "test_lmdb_shapesnet_trained",
                                  "test_lmdb_shapesnet2_trained"])
def test_golden(tmp_path, name):
    """The golden's command on the port (test_lmdb on the CPU engine): its
    stdout equals test_out.txt, and rec_0.png has the golden's pixels."""
    argv = _argv(name) + [f"--boda-output-dir={tmp_path}"]
    if argv[0] == "test_lmdb":
        argv.append("--conv-fwd=(mode=cuda,device=cpu)")
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert cli.main(argv) == 0
    gdir = os.path.join(GOOD, name)
    with open(os.path.join(gdir, "test_out.txt")) as f:
        assert buf.getvalue() == f.read()
    for fn in sorted(os.listdir(gdir)):
        if fn.endswith(".png"):
            got, want = (timg.Img.load(p).data for p in (str(tmp_path / fn),
                                                         os.path.join(gdir, fn)))
            assert np.array_equal(got, want), fn


def test_images_and_optional_modules(monkeypatch, tmp_path):
    """Img and the preprocessing as boda_tpu's; without lmdb and without PIL
    the port raises what boda_tpu raises (PIL named), a resize to the image's
    own size is a copy with no PIL, and test_lmdb --ckpt-fn refuses a
    checkpoint holding a weight the net lacks with boda_tpu's error."""
    fn = os.path.join(TD, "images", "test1.png")
    ti, ji = timg.Img.load(fn), jimg.Img.load(fn)
    assert np.array_equal(ti.data, ji.data)
    assert np.array_equal(ti.resize(31, 17).data, ji.resize(31, 17).data)
    assert np.array_equal(ti.crop(2, 3, 9, 11).data, ji.crop(2, 3, 9, 11).data)
    tz, jz = timg.Img.from_rgb(np.full((20, 20, 3), 7)), jimg.Img.zeros(20, 20, 7)
    tz.paste(ti.crop(0, 0, 5, 6), 3, 4)
    jz.paste(ji.crop(0, 0, 5, 6), 3, 4)
    assert np.array_equal(tz.data, jz.data)
    assert np.array_equal(timg.Img.from_rgb(ti.rgb()).data, jimg.Img.from_rgb(ji.rgb()).data)
    batch = np.stack([ti.resize(24, 24).data, ti.crop(0, 0, 24, 24).data])
    assert np.array_equal(tpre.img_to_batch_np(batch), jpre.img_to_batch_np(batch))
    assert np.array_equal(tpre.center_crop(ti.data, 10, 12), jpre.center_crop(ji.data, 10, 12))
    assert tpre.IMAGENET_MEAN_BGR == jpre.IMAGENET_MEAN_BGR
    with pytest.raises(timg.ImgError, match="image file not found"):
        timg.Img.load(str(fn) + ".nosuch")
    # no lmdb module: the feature error, in both packages
    monkeypatch.setattr(tdatum, "is_feature_enabled", lambda name: False)
    monkeypatch.setattr(jdatum, "is_feature_enabled", lambda name: False)
    msgs = []
    for mod in (tdatum, jdatum):
        with pytest.raises(RuntimeError) as e:
            next(mod.read_lmdb_records(str(TD)))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "lmdb python module is not installed" in msgs[0]
    # no PIL: an import of it fails
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert np.array_equal(ti.resize(*ti.sz).data, ti.data)  # the own size: a copy
    for call in (lambda: timg.Img.load(fn), lambda: ti.resize(8, 8),
                 lambda: ti.save(os.devnull)):
        with pytest.raises(timg.ImgError, match="need PIL"):
            call()
    monkeypatch.delitem(sys.modules, "PIL")
    err = io.StringIO()
    monkeypatch.setattr(sys, "stderr", err)
    from boda_tpu_torch.parallel.checkpoint import save_checkpoint
    ck = str(tmp_path / "bogus.npz")
    save_checkpoint(ck, 1, {"bogus__filts": np.zeros(2, np.float32)})
    assert cli.main(["test_lmdb", f"--rec-fn={RECS[0]}", "--model=mini_resnet",
                     f"--ckpt-fn={ck}", "--conv-fwd=(mode=cuda,device=cpu)"]) == 1
    assert "error: ckpt weights not in net: ['bogus__filts']" in err.getvalue()
