"""Minimal pure-python rosbag v2.0 reader (+ fixture writer).

A copy of ``boda_tpu/stream/rosbag.py`` (pure Python and numpy; the port
imports nothing of boda_tpu), so a bag either package writes the other
reads. Parity target: ref src/data-stream-rosbag.cc — the reference links the ROS
C++ stack to read sensor_msgs Image / CompressedImage / PointCloud2 topics
out of .bag files (topic selection, primary-topic sync). This is a
dependency-free implementation of the bag container (record framing,
connection records, bz2/uncompressed chunks) plus deserializers for the two
message types the reference's pipelines actually consume; multi-topic time
sync composes from the existing ts-merge stream.

Bag format: http://wiki.ros.org/Bags/Format/2.0 — records are
<u32 header_len><header><u32 data_len><data>; header is a sequence of
<u32 len><name=value> fields; message bytes use little-endian ROS
serialization.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass

import numpy as np

MAGIC = b"#ROSBAG V2.0\n"

OP_MSG = 0x02
OP_BAG_HDR = 0x03
OP_INDEX = 0x04
OP_CHUNK = 0x05
OP_CHUNK_INFO = 0x06
OP_CONN = 0x07


class BagError(ValueError):
    pass


def _parse_header(b: bytes) -> dict[str, bytes]:
    out, off = {}, 0
    while off < len(b):
        (ln,) = struct.unpack_from("<I", b, off)
        off += 4
        fld = b[off:off + ln]
        off += ln
        eq = fld.index(b"=")
        out[fld[:eq].decode()] = fld[eq + 1:]
    return out


def _iter_records(buf: bytes, off: int = 0):
    n = len(buf)
    while off + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, off)
        hdr = _parse_header(buf[off + 4:off + 4 + hlen])
        off += 4 + hlen
        (dlen,) = struct.unpack_from("<I", buf, off)
        data = buf[off + 4:off + 4 + dlen]
        off += 4 + dlen
        yield hdr, data


@dataclass
class BagConn:
    cid: int
    topic: str
    dtype: str      # e.g. sensor_msgs/Image


@dataclass
class BagMsg:
    conn: BagConn
    ts: int         # nanoseconds
    raw: bytes


def read_bag(fn: str):
    """Yield BagMsg for every message record, in file order."""
    with open(fn, "rb") as f:
        buf = f.read()
    if not buf.startswith(MAGIC):
        raise BagError(f"{fn}: not a rosbag v2.0 file")
    conns: dict[int, BagConn] = {}

    def handle(records):
        for hdr, data in records:
            op = hdr["op"][0]
            if op == OP_CONN:
                (cid,) = struct.unpack("<I", hdr["conn"])
                ch = _parse_header(data)
                conns[cid] = BagConn(cid, hdr["topic"].decode(),
                                     ch.get("type", b"").decode())
            elif op == OP_MSG:
                (cid,) = struct.unpack("<I", hdr["conn"])
                sec, nsec = struct.unpack("<II", hdr["time"])
                if cid not in conns:
                    raise BagError(f"message for unknown connection {cid}")
                yield BagMsg(conns[cid], sec * 10 ** 9 + nsec, data)
            elif op == OP_CHUNK:
                comp = hdr.get("compression", b"none").decode()
                if comp == "bz2":
                    inner = bz2.decompress(data)
                elif comp == "none":
                    inner = data
                else:
                    raise BagError(f"unsupported chunk compression {comp!r}")
                yield from handle(_iter_records(inner))
            # OP_BAG_HDR / OP_INDEX / OP_CHUNK_INFO: seek metadata, unused

    yield from handle(_iter_records(buf, len(MAGIC)))


# -- ROS little-endian message deserialization ---------------------------------------


class _Rd:
    def __init__(self, b: bytes):
        self.b, self.off = b, 0

    def u8(self):
        v = self.b[self.off]
        self.off += 1
        return v

    def u32(self):
        (v,) = struct.unpack_from("<I", self.b, self.off)
        self.off += 4
        return v

    def s(self):
        n = self.u32()
        v = self.b[self.off:self.off + n].decode(errors="replace")
        self.off += n
        return v

    def raw(self, n):
        v = self.b[self.off:self.off + n]
        self.off += n
        return v

    def header(self):
        seq = self.u32()
        sec, nsec = self.u32(), self.u32()
        frame = self.s()
        return seq, sec * 10 ** 9 + nsec, frame


def parse_image(raw: bytes):
    """sensor_msgs/Image -> (y, x, chan) uint8 array (8-bit encodings)."""
    r = _Rd(raw)
    r.header()
    h, w = r.u32(), r.u32()
    enc = r.s()
    r.u8()          # is_bigendian
    step = r.u32()
    data = r.raw(r.u32())
    chans = {"mono8": 1, "rgb8": 3, "bgr8": 3, "rgba8": 4, "bgra8": 4}
    if enc not in chans:
        raise BagError(f"unsupported image encoding {enc!r}")
    c = chans[enc]
    img = np.frombuffer(data, np.uint8).reshape(h, step)[:, :w * c]
    img = img.reshape(h, w, c)
    if enc.startswith("bgr"):
        img = img[:, :, [2, 1, 0] + ([3] if c == 4 else [])]
    return img


_PF_DT = {1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
          5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64}


def parse_pointcloud2(raw: bytes):
    """sensor_msgs/PointCloud2 -> (n_pts, n_attrs) float32 (x,y,z first,
    remaining named fields in declared order)."""
    r = _Rd(raw)
    r.header()
    h, w = r.u32(), r.u32()
    fields = []
    for _ in range(r.u32()):
        name = r.s()
        off, dt, cnt = r.u32(), r.u8(), r.u32()
        fields.append((name, off, dt, cnt))
    r.u8()                       # is_bigendian
    pt_step = r.u32()
    r.u32()                      # row_step
    data = r.raw(r.u32())
    n = h * w
    rec = np.frombuffer(data, np.uint8).reshape(n, pt_step)
    order = {f[0]: i for i, f in enumerate(fields)}
    named = sorted(fields, key=lambda f: (f[0] not in ("x", "y", "z"),
                                          "xyz".find(f[0]) if f[0] in "xyz"
                                          else order[f[0]]))
    cols = []
    for name, off, dt, cnt in named:
        npdt = _PF_DT[dt]
        w_ = np.dtype(npdt).itemsize
        col = rec[:, off:off + w_].copy().view(npdt).reshape(n)
        cols.append(col.astype(np.float32))
    return np.stack(cols, axis=1)


# -- fixture writer ------------------------------------------------------------------


def _rec(hdr_fields: dict[str, bytes], data: bytes) -> bytes:
    hdr = b"".join(struct.pack("<I", len(k) + 1 + len(v)) + k.encode() + b"="
                   + v for k, v in hdr_fields.items())
    return struct.pack("<I", len(hdr)) + hdr + struct.pack("<I", len(data)) + data


def write_bag(fn: str, msgs, compression: str = "none") -> None:
    """Write a minimal v2.0 bag: one chunk holding connection + message
    records. msgs: list of (topic, dtype, ts_ns, raw_bytes)."""
    conns: dict[str, int] = {}
    inner = b""
    for topic, dtype, ts, raw in msgs:
        if topic not in conns:
            cid = conns[topic] = len(conns)
            ch = _rec({"topic": topic.encode(), "type": dtype.encode(),
                       "md5sum": b"*", "message_definition": b""}, b"")
            # connection record: header has op/conn/topic; data is the
            # connection header block
            chdr = {"op": bytes([OP_CONN]),
                    "conn": struct.pack("<I", cid),
                    "topic": topic.encode()}
            cdata = b"".join(
                struct.pack("<I", len(k) + 1 + len(v)) + k.encode() + b"=" + v
                for k, v in (("topic", topic.encode()),
                             ("type", dtype.encode()), ("md5sum", b"*"),
                             ("message_definition", b"")))
            inner += _rec(chdr, cdata)
            del ch
        sec, nsec = divmod(int(ts), 10 ** 9)
        inner += _rec({"op": bytes([OP_MSG]),
                       "conn": struct.pack("<I", conns[topic]),
                       "time": struct.pack("<II", sec, nsec)}, raw)
    payload = bz2.compress(inner) if compression == "bz2" else inner
    chunk = _rec({"op": bytes([OP_CHUNK]), "compression": compression.encode(),
                  "size": struct.pack("<I", len(inner))}, payload)
    bag_hdr = _rec({"op": bytes([OP_BAG_HDR]),
                    "index_pos": struct.pack("<Q", 0),
                    "conn_count": struct.pack("<I", len(conns)),
                    "chunk_count": struct.pack("<I", 1)},
                   b"\x20" * 4096)  # spec: bag header record padded
    with open(fn, "wb") as f:
        f.write(MAGIC + bag_hdr + chunk)


def ser_image(img: np.ndarray, enc: str = "rgb8", ts: int = 0,
              frame: str = "cam") -> bytes:
    h, w, c = img.shape
    r = struct.pack("<I", 0)
    sec, nsec = divmod(int(ts), 10 ** 9)
    r += struct.pack("<II", sec, nsec)
    r += struct.pack("<I", len(frame)) + frame.encode()
    r += struct.pack("<II", h, w)
    r += struct.pack("<I", len(enc)) + enc.encode()
    r += bytes([0]) + struct.pack("<I", w * c)
    raw = img.astype(np.uint8).tobytes()
    return r + struct.pack("<I", len(raw)) + raw


def ser_pointcloud2(pts: np.ndarray, names=("x", "y", "z", "intensity"),
                    ts: int = 0, frame: str = "velo") -> bytes:
    n, k = pts.shape
    assert k == len(names)
    r = struct.pack("<I", 0)
    sec, nsec = divmod(int(ts), 10 ** 9)
    r += struct.pack("<II", sec, nsec)
    r += struct.pack("<I", len(frame)) + frame.encode()
    r += struct.pack("<II", 1, n)
    r += struct.pack("<I", k)
    for i, nm in enumerate(names):
        r += struct.pack("<I", len(nm)) + nm.encode()
        r += struct.pack("<IBI", i * 4, 7, 1)  # offset, FLOAT32, count
    r += bytes([0]) + struct.pack("<II", k * 4, n * k * 4)
    raw = pts.astype(np.float32).tobytes()
    r += struct.pack("<I", len(raw)) + raw
    r += bytes([1])  # is_dense
    return r
