"""The port's data streams (boda_tpu_torch/stream/, modes/stream_modes.py)
against boda_tpu's on the CPU, exactly: the 14 corpus entries of
testdata/test_cmds.xml of the stream, display and proc_pipe modes, through
both packages' run_mode (stdout and every file written); each data_stream
type that no corpus entry reaches, block for block; the error texts; and
the type census."""

import struct

import numpy as np
import pytest

from parity_modes import PKGS, REPO, _mod, assert_same_outputs, corpus_argv, run_both

# the corpus entries of the stream, display and proc_pipe modes
CORPUS = ("render_pts_velo", "hash_pair_check", "velodyne_gen_scan", "avi_mjpeg_scan",
          "rosbag_scan_image", "rosbag_scan", "velo_scan_fixture", "stream_sync",
          "stream_merge_flatten", "stream_fold_sort", "stream_seq_adj_angle",
          "display_pil", "err_no_camera", "cs_disp_pipeline")


@pytest.mark.parametrize("name", CORPUS)
def test_corpus_entry_matches_boda_tpu(name, tmp_path):
    """Each corpus entry of these modes: the same stdout (print-sink's text)
    and the same files (CSVs byte for byte, PNGs pixel for pixel) from both
    packages, and the entry's own error where it pins one."""
    argv, err = corpus_argv(name)
    res = run_both([argv], tmp_path)
    (jo, je, jf), (to, te, tf) = res["boda_tpu"], res["boda_tpu_torch"]
    assert je == te == (err,)
    assert to == jo and (err or to[0].strip())
    assert_same_outputs(jf, tf)


def _make(pkg, spec):
    cfg, lexp = _mod(pkg, "config"), _mod(pkg, "utils.lexp")
    cfg.default_cfg_init(REPO)
    return cfg.instantiate("data_stream", lexp.parse_lexp(spec))


def _drain(src):
    src.start()
    out = []
    while True:
        b = src.read()
        if b is None:
            return out
        out.append(b)


def assert_same_blocks(a, b):
    """Two block lists equal field for field, the nested sub-blocks too."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.ts, x.tag, x.frame_ix, x.data) == (y.ts, y.tag, y.frame_ix, y.data)
        assert (x.nda is None) == (y.nda is None)
        if x.nda is not None:
            assert str(x.nda.dims) == str(y.nda.dims)
            assert x.nda.data.dtype == y.nda.data.dtype
            assert np.array_equal(x.nda.data, y.nda.data)
        assert list(x.subs) == list(y.subs)
        assert_same_blocks(list(x.subs.values()), list(y.subs.values()))


def _framed_files(d):
    """A dumpvideo file ([u32 size][payload]..., an end marker) and a qt file
    ([u64 ts][u32 size][payload]...)."""
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in (5, 0, 17)]
    dv, qt = d / "v.dump", d / "v.qt"
    dv.write_bytes(b"".join(struct.pack("<I", len(f)) + f for f in frames)
                   + struct.pack("<I", 0xFFFFFFFF))
    qt.write_bytes(b"".join(struct.pack("<QI", 1000 * (i + 1), len(f)) + f
                            for i, f in enumerate(frames)))
    return dv, qt


# sources and transforms that no corpus entry reaches (img-dir-src is
# cs_disp's)
SOURCES = {
    "block-file-src": "(stream=block-file-src,fn=%(boda_test_dir)/lmdb/cifar_mini.rec)",
    "text-src": "(stream=text-src,fn=%(boda_test_dir)/streams/angles.csv)",
    "start-stop-skip": "(stream=start-stop-skip,src=(stream=gen-src,n=10),start_ix=2,"
                       "stop_ix=9,skip=1)",
    "crop, add-img, pass": "(stream=pass,src=(stream=add-img,src=(stream=crop,src=("
                           "stream=img-dir-src,dir=%(boda_test_dir)/images,glob=test),"
                           "y0=2,x0=3,y1=40,x1=50)))",
    "add-img (2-d)": "(stream=add-img,src=(stream=velo-cloud-gen,n=2))",
    "add-img-pts": "(stream=add-img-pts,src=(stream=velo-src,"
                   "fn=%(boda_test_dir)/streams/velo.dat),img_sz=64)",
    "velo-rev": "(stream=velo-rev,src=(stream=velodyne-gen,src=(stream=velo-cloud-gen,"
                "n=2,n_azi=240),azi_step=2.0),fov_center=90)",
    "dumpvideo-src": "(stream=dumpvideo-src,fn={dv})",
    "qt-src": "(stream=qt-src,fn={qt})",
    "ts-merge max_dt": "(stream=ts-merge,primary=(stream=gen-src,n=4,ts_step=100),"
                       "secondary=(s=(stream=gen-src,n=9,ts_step=45,ts0=7)),max_dt=20)",
    "sync max_dt": "(stream=sync,primary=(stream=gen-src,n=6,ts_step=100),"
                   "secondary=(s=(stream=gen-src,n=20,ts_step=37)),max_dt=10)",
    "sort-by-ts max_buf": "(stream=sort-by-ts,src=(stream=stamp,src=(stream=gen-src,n=7),"
                          "ts0=100,step=-10),max_buf=3)",
    "fold, drop": "(stream=fold,src=(stream=merge,streams=(a=(stream=gen-src,n=2),"
                  "b=(stream=gen-src,n=3))),fold_src=b)",
    "adj-angle negate": "(stream=adj-angle,src=(stream=csv-src,"
                        "fn=%(boda_test_dir)/streams/angles.csv,ts_col=-1),adj=-45,negate=1)",
}


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_source_matches_boda_tpu(case, tmp_path):
    """A source or transform that no corpus entry reaches: the same blocks
    from both packages (ts, tag, index, bytes, dims, data and subs)."""
    dv, qt = _framed_files(tmp_path)
    spec = SOURCES[case].replace("{dv}", str(dv)).replace("{qt}", str(qt))
    got = [_drain(_make(pkg, spec)) for pkg in PKGS]
    assert got[0]
    assert_same_blocks(*got)


# the sinks no corpus entry reaches, through scan_data_stream
SINKS = {
    "null-sink": "(stream=null-sink)",
    "block-file-sink": "(stream=block-file-sink,fn=b.blk)",
    "text-sink": "(stream=text-sink,fn=t.txt)",
    "csv-sink": "(stream=csv-sink,fn=c.csv)",
    "pcap-sink": "(stream=pcap-sink,fn=p.pcap,udp_dest_port=2400)",
    "mxnet-brick-sink": "(stream=mxnet-brick-sink,fn=m.rec,split_at=7)",
    "rosbag-sink": "(stream=rosbag-sink,fn=r.bag,topic=/t)",
    "rosbag-sink bz2": "(stream=rosbag-sink,fn=r.bag,compression=bz2)",
    "hash-check": "(stream=hash-check)",
}
SINK_SRC = {"rosbag-sink": "(stream=seq,streams=(a=(stream=img-dir-src,"
                           "dir=%(boda_test_dir)/images,glob=test1),b=(stream=velo-src,"
                           "fn=%(boda_test_dir)/streams/velo.dat),c=(stream=text-src,"
                           "fn=%(boda_test_dir)/streams/angles.csv)))",
            "hash-check": "(stream=hash-pair,src=(stream=text-src,"
                          "fn=%(boda_test_dir)/streams/angles.csv))"}


@pytest.mark.parametrize("case", sorted(SINKS))
def test_sink_matches_boda_tpu(case, tmp_path):
    """A sink that no corpus entry reaches: scan_data_stream through both
    packages writes the same bytes and prints the same lines."""
    src = SINK_SRC.get(case.split()[0], "(stream=hash-pair,src=(stream=gen-src,n=5,sz=6))")
    res = run_both([["scan_data_stream", f"--src={src}", f"--sink={SINKS[case]}"]], tmp_path)
    (jo, je, jf), (to, te, tf) = res["boda_tpu"], res["boda_tpu_torch"]
    assert je == te == (None,) and to == jo
    assert_same_outputs(jf, tf)
    assert case == "null-sink" or case == "hash-check" or tf


def test_img_add_text_matches_boda_tpu():
    """img-add-text on an RGBA and a grayscale block: the same pixels."""
    rng = np.random.default_rng(5)
    for arr, names in ((rng.integers(0, 256, (24, 40, 4), dtype=np.uint8), ("y", "x", "c")),
                       (rng.integers(0, 256, (20, 30, 1), dtype=np.uint8), ("y", "x", "c"))):
        got = []
        for pkg in PKGS:
            ds, dims = _mod(pkg, "stream.data_stream"), _mod(pkg, "utils.dims")
            t = _make(pkg, "(stream=img-add-text,text_x=2,text_y=3,text_str=hi,"
                           "prefix_with_tag=1)")
            blk = ds.DataBlock(ts=1, tag="f0", nda=dims.NDA.from_array(arr.copy(), names))
            got.append(t.proc(blk).nda.data)
        assert np.array_equal(*got) and not np.array_equal(got[0], arr)


# errors that the streams raise, with boda_tpu's text
ERRORS = ("(stream=ffmpeg-src,fn=x.mp4)",
          "(stream=fold,src=(stream=gen-src,n=2),fold_src=a)",
          "(stream=fold,src=(stream=merge,streams=(a=(stream=gen-src,n=1))),fold_src=b)",
          "(stream=flatten,src=(stream=merge,streams=(a=(stream=gen-src,n=1))))",
          "(stream=sync,primary=(stream=gen-src,n=2),secondary=(s=(stream=gen-src,n=0)))",
          "(stream=adj-angle,src=(stream=text-src,fn=%(boda_test_dir)/streams/angles.csv))",
          "(stream=velodyne-gen,src=(stream=gen-src,n=1))",
          "(stream=velo-rev,src=(stream=gen-src,n=1))",
          "(stream=avi-mjpeg-src,fn=%(boda_test_dir)/streams/mini.bag)",
          "(stream=rosbag-src,fn=%(boda_test_dir)/streams/mini.avi)")


def test_errors_match_boda_tpu():
    """Each error above: the same exception type name and text in both."""
    for spec in ERRORS:
        got = []
        for pkg in PKGS:
            try:
                _drain(_make(pkg, spec))
                got.append(None)
            except Exception as e:  # noqa: BLE001 - the type is compared
                got.append((type(e).__name__, str(e)))
        assert got[0] is not None and got[0] == got[1], spec


def test_every_type_and_mode_registered():
    """Every data_stream type of boda_tpu's is registered in the port under
    the same name and help, and the stream, display, proc_pipe and plot
    modes too."""
    from boda_tpu import config as jcfg
    from boda_tpu_torch import config as tcfg
    assert tcfg.registered_tids("data_stream") == jcfg.registered_tids("data_stream")
    for tid in jcfg.registered_tids("data_stream"):
        jf = [(f.name, f.default) for f in jcfg.class_fields(jcfg.get_class("data_stream", tid))]
        tf = [(f.name, f.default) for f in tcfg.class_fields(tcfg.get_class("data_stream", tid))]
        assert tf == jf, tid
    for m in ("stream_modes", "display_modes", "proc_pipe", "plot_modes"):
        names = [t for t in jcfg.registered_tids("mode")
                 if jcfg.get_class("mode", t).__module__ == f"boda_tpu.modes.{m}"]
        assert names and set(names) <= set(tcfg.registered_tids("mode")), m
        for t in names:
            assert tcfg.get_class("mode", t).__module__ == f"boda_tpu_torch.modes.{m}"
