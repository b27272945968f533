"""Caffe Datum records: wire-format decode/encode and record-store access.

Counterpart of ``boda_tpu/frontend/datum.py``, copied (pure Python and
numpy). Datum proto fields: channels=1 height=2 width=3 data=4 (bytes, CHW
u8 in BGR order) label=5 float_data=6 (repeated float) encoded=7 (bool).

Record stores: a real LMDB through the ``lmdb`` Python module when it is
installed (optional: without it :func:`read_lmdb_records` raises), and the
block-stream container (stream/data_stream.py), the portable format of the
record files in testdata/lmdb.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..utils.features import is_feature_enabled
from .caffemodel import parse_wire


@dataclass
class Datum:
    chan: int
    y: int
    x: int
    label: int
    data: np.ndarray  # (chan, y, x) uint8 or float32

    def to_rgb(self) -> np.ndarray:
        """(y, x, 3) uint8 view: Caffe datum bytes are CHW in BGR order."""
        d = self.data
        if d.shape[0] == 3:
            bgr = d.transpose(1, 2, 0)
            return bgr[:, :, ::-1].astype(np.uint8)
        return np.repeat(d.transpose(1, 2, 0), 3, axis=2).astype(np.uint8)


def parse_datum(buf: bytes) -> Datum:
    f = parse_wire(memoryview(buf))
    chan = int(f.get(1, [0])[0])
    y = int(f.get(2, [0])[0])
    x = int(f.get(3, [0])[0])
    label = int(f.get(5, [0])[0])
    if 4 in f:
        raw = np.frombuffer(bytes(f[4][0]), np.uint8)
        data = raw.reshape(chan, y, x)
    elif 6 in f:
        chunks = []
        for v in f[6]:
            if isinstance(v, memoryview):
                chunks.append(np.frombuffer(v, dtype="<f4"))
            else:
                chunks.append(np.array(
                    [struct.unpack("<f", struct.pack("<i", v))[0]], np.float32))
        data = np.concatenate(chunks).reshape(chan, y, x)
    else:
        raise ValueError("datum has neither data nor float_data")
    return Datum(chan, y, x, label, data)


def encode_datum(d: Datum) -> bytes:
    """Wire-encode a Datum (fixture generation)."""
    def varint(v: int) -> bytes:
        out = b""
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b | 0x80])
            else:
                return out + bytes([b])

    def vfield(fno: int, v: int) -> bytes:
        return varint(fno << 3) + varint(v)

    def ld(fno: int, data: bytes) -> bytes:
        return varint((fno << 3) | 2) + varint(len(data)) + data

    out = vfield(1, d.chan) + vfield(2, d.y) + vfield(3, d.x)
    out += ld(4, np.ascontiguousarray(d.data, np.uint8).tobytes())
    out += vfield(5, d.label)
    return out


def rgb_to_datum(rgb: np.ndarray, label: int) -> Datum:
    """(y, x, 3) uint8 RGB -> Caffe-order (3, y, x) BGR datum."""
    bgr = rgb[:, :, ::-1]
    return Datum(3, rgb.shape[0], rgb.shape[1], label,
                 np.ascontiguousarray(bgr.transpose(2, 0, 1)))


# -- record stores -------------------------------------------------------------------

def read_lmdb_records(path: str, max_records: int = 0):
    """Yield (key, value) from a real LMDB (requires the lmdb module)."""
    if not is_feature_enabled("lmdb"):
        raise RuntimeError(
            "lmdb feature not enabled in this build (the lmdb python module "
            "is not installed); use a block-stream record file instead")
    import lmdb
    env = lmdb.open(path, readonly=True, lock=False)
    n = 0
    with env.begin() as txn:
        for k, v in txn.cursor():
            yield bytes(k), bytes(v)
            n += 1
            if max_records and n >= max_records:
                return


def read_rec_records(fn: str, max_records: int = 0):
    """Yield (key, value) datum records from a block-stream file."""
    from ..stream.data_stream import read_block_stream
    n = 0
    for blk in read_block_stream(fn):
        yield blk.tag.encode(), blk.data
        n += 1
        if max_records and n >= max_records:
            return


def write_rec_records(fn: str, records: list[tuple[str, bytes]]) -> None:
    from ..stream.data_stream import DataBlock, write_block_stream
    blocks = [DataBlock(ts=i, tag=k, data=v)
              for i, (k, v) in enumerate(records)]
    write_block_stream(fn, blocks)
