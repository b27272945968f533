"""The stream formats across the two packages on the CPU: velodyne packets,
MJPEG-in-AVI, rosbag (none and bz2 chunks), pcap, mxnet-brick and the block
file, each written by one package and read back by both, both ways, and
each writer's bytes equal to the other's."""

import importlib
import os

import numpy as np
import pytest

import boda_tpu.modes_all  # noqa: F401
import boda_tpu_torch.modes_all  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("boda_tpu", "boda_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _stream(pkg, spec):
    cfg, lexp = _mod(pkg, "config"), _mod(pkg, "utils.lexp")
    cfg.default_cfg_init(REPO)
    return cfg.instantiate("data_stream", lexp.parse_lexp(spec))


def _packets(pkg, n=3):
    velo = _mod(pkg, "stream.velodyne")
    rng = np.random.default_rng(11)
    out = []
    for i in range(n):
        az = np.arange(12, dtype=np.float32) * 0.4 + 30 * i
        dist = np.round(rng.uniform(0, 60, (12, 32)) / 0.002) * 0.002
        dist[rng.random((12, 32)) < 0.1] = 0  # no return
        refl = rng.integers(0, 256, (12, 32))
        out.append(velo.encode_packet(az, dist, refl, ts_usec=1000 + 553 * i))
    return out


def _jpegs():
    import io

    from PIL import Image
    rng = np.random.default_rng(2)
    out = []
    for i in range(3):
        a = (rng.integers(0, 256, (24, 32, 3)) // 32 * 32).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, "JPEG", quality=90)
        out.append(buf.getvalue())
    return out


def _bag_msgs(pkg):
    rb = _mod(pkg, "stream.rosbag")
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (6, 9, 3), dtype=np.uint8)
    pts = rng.standard_normal((17, 4)).astype(np.float32)
    return [("/cam/image", "sensor_msgs/Image", 5 * 10 ** 9 + 7, rb.ser_image(img, ts=7)),
            ("/velo/points", "sensor_msgs/PointCloud2", 6 * 10 ** 9, rb.ser_pointcloud2(pts)),
            ("/raw", "boda/bytes", 6 * 10 ** 9 + 1, bytes(range(40))),
            ("/cam/image", "sensor_msgs/Image", 7 * 10 ** 9, rb.ser_image(img[::-1], ts=9))]


def _blocks(pkg):
    ds, dims = _mod(pkg, "stream.data_stream"), _mod(pkg, "utils.dims")
    rng = np.random.default_rng(6)
    bf = (rng.standard_normal((2, 5)).astype(np.float32).view(np.uint32)
          & 0xFFFF0000).view(np.float32)  # exact in bf16
    return [ds.DataBlock(ts=3, tag="raw", data=b"\x00\x01abc"),
            ds.DataBlock(ts=-4, tag="f32", nda=dims.NDA(dims.Dims.of(y=2, x=3),
                                                       np.arange(6, dtype=np.float32))),
            ds.DataBlock(ts=5, tag="u8", nda=dims.NDA.from_array(
                rng.integers(0, 256, (3, 4), dtype=np.uint8), ("y", "x"))),
            ds.DataBlock(ts=6, tag="bf16", nda=dims.NDA(
                dims.Dims.make(("a", "b"), (2, 5), "bfloat16"), bf))]


def _sink(pkg, spec, blocks):
    s = _stream(pkg, spec)
    s.start()
    for b in blocks:
        s.proc(b)
    s.finish()


def _data_blocks(pkg, payloads):
    ds = _mod(pkg, "stream.data_stream")
    return [ds.DataBlock(ts=10 ** 9 * i + 1000 * i, tag="p", data=p)
            for i, p in enumerate(payloads)]


def _drain(src):
    src.start()
    out = []
    while True:
        b = src.read()
        if b is None:
            return out
        out.append(b)


def write(fmt, pkg, fn):
    if fmt == "velodyne":
        with open(fn, "wb") as f:
            f.write(b"".join(_packets(pkg)))
    elif fmt == "avi":
        _mod(pkg, "stream.avi").write_avi_mjpeg(fn, _jpegs(), fps=12, sz=(32, 24))
    elif fmt.startswith("rosbag"):
        _mod(pkg, "stream.rosbag").write_bag(fn, _bag_msgs(pkg), compression=fmt.split()[1])
    elif fmt == "pcap":
        _sink(pkg, f"(stream=pcap-sink,fn={fn},udp_dest_port=2368)",
              _data_blocks(pkg, _packets(pkg)))
    elif fmt == "mxnet-brick":
        _sink(pkg, f"(stream=mxnet-brick-sink,fn={fn},split_at=100)",
              _data_blocks(pkg, [bytes((7 * i + n) % 256 for i in range(n))
                                 for n in (0, 3, 100, 257)]))
    else:
        _mod(pkg, "stream.data_stream").write_block_stream(fn, _blocks(pkg))


def read(fmt, pkg, fn):
    """What ``pkg`` reads from the file, as plain Python and numpy values."""
    if fmt == "velodyne":
        velo = _mod(pkg, "stream.velodyne")
        raw = open(fn, "rb").read()
        pk = [raw[i:i + velo.PACKET_BYTES] for i in range(0, len(raw), velo.PACKET_BYTES)]
        return [list(velo.decode_packet(p)) + [velo.packet_to_points_vlp16(p)] for p in pk]
    if fmt == "avi":
        img = _mod(pkg, "utils.img_io").Img
        return [(f.stream_ix, f.frame_ix, f.ts_us, f.jpeg, img.from_bytes(f.jpeg).data)
                for f in _mod(pkg, "stream.avi").read_avi_mjpeg(fn)]
    if fmt.startswith("rosbag"):
        rb = _mod(pkg, "stream.rosbag")
        out = []
        for m in rb.read_bag(fn):
            parsed = (rb.parse_image(m.raw) if m.conn.dtype == "sensor_msgs/Image" else
                      rb.parse_pointcloud2(m.raw)
                      if m.conn.dtype == "sensor_msgs/PointCloud2" else None)
            out.append((m.conn.topic, m.conn.dtype, m.ts, m.raw, parsed))
        return out
    spec = {"pcap": f"(stream=pcap-src,fn={fn})", "mxnet-brick": f"(stream=mxnet-brick-src,fn={fn})",
            "block-file": f"(stream=block-file-src,fn={fn})"}[fmt]
    return [(b.ts, b.tag, b.frame_ix, b.data,
             None if b.nda is None else (str(b.nda.dims), np.asarray(b.nda.data, np.float32)
                                         if b.nda.dims.tn == "bfloat16" else b.nda.data))
            for b in _drain(_stream(pkg, spec))]


def assert_same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert a == b


FORMATS = ("velodyne", "avi", "rosbag none", "rosbag bz2", "pcap", "mxnet-brick", "block-file")


@pytest.mark.parametrize("writer", PKGS)
@pytest.mark.parametrize("fmt", FORMATS)
def test_format_crosses_packages(fmt, writer, tmp_path):
    """A file ``writer`` writes reads back the same in both packages, and
    the other package's writer makes the same bytes."""
    other = PKGS[1 - PKGS.index(writer)]
    fn, fn2 = str(tmp_path / "a"), str(tmp_path / "b")
    write(fmt, writer, fn)
    write(fmt, other, fn2)
    assert open(fn, "rb").read() == open(fn2, "rb").read()
    mine = read(fmt, writer, fn)
    assert mine
    assert_same(read(fmt, other, fn), mine)
