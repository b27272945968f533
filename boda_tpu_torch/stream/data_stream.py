"""The binary block-stream container: timestamped, tagged blocks of bytes or
ND-arrays in one file.

Counterpart of the block-file format of ``boda_tpu/stream/data_stream.py``
(``_MAGIC``, ``DataBlock``, ``write_block_stream``, ``read_block_stream``),
the format of the record files in testdata/lmdb. An ND block's dims carry
their type name; a ``bfloat16`` block's bytes are widened to float32 on the
host (numpy has no bfloat16), which is exact. The stream sources,
transforms and sinks are ROADMAP §1 item 9.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..config import ConfigError
from ..utils.dims import NDA, Dims, np_dtype

_MAGIC = b"bodablk1"


@dataclass
class DataBlock:
    """A timestamped, tagged block: raw bytes or an ND-array."""
    ts: int = 0                      # nanoseconds
    tag: str = ""
    data: Optional[bytes] = None     # raw payload
    nda: Optional[NDA] = None        # nd-array payload
    frame_ix: int = -1               # its place in the file, as read


def _nda_bytes(nda: NDA) -> bytes:
    """An NDA's payload in its dims' type: bf16 as the top half of each f32."""
    a = np.ascontiguousarray(nda.data)
    if nda.dims.tn == "bfloat16":
        u = a.astype(np.float32).view(np.uint32)
        # round to nearest even, as a cast to bf16 does (NaN kept quiet)
        r = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
        r = np.where(np.isnan(a), (u >> 16) | 0x40, r)
        return r.astype(np.uint16).tobytes()
    return a.tobytes()


def _nda_from_bytes(dims: Dims, raw: bytes) -> np.ndarray:
    if dims.tn == "bfloat16":
        u = np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
        return u.view(np.float32).copy()
    return np.frombuffer(raw, dtype=np_dtype(dims.tn)).copy()


def write_block_stream(fn: str, blocks: list[DataBlock]) -> None:
    with open(fn, "wb") as f:
        f.write(_MAGIC)
        for b in blocks:
            tag = b.tag.encode()
            f.write(struct.pack("<qI", b.ts, len(tag)) + tag)
            if b.nda is not None:
                dims_s = str(b.nda.dims).encode()
                raw = _nda_bytes(b.nda)
                f.write(b"N" + struct.pack("<I", len(dims_s)) + dims_s +
                        struct.pack("<Q", len(raw)) + raw)
            else:
                raw = b.data or b""
                f.write(b"B" + struct.pack("<Q", len(raw)) + raw)


def read_block_stream(fn: str):
    """Yield the file's blocks in order; an ND block's data comes flat, in
    its type's host dtype."""
    with open(fn, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ConfigError(f"{fn}: not a block stream file")
        ix = 0
        while True:
            hdr = f.read(12)
            if not hdr:
                return
            ts, taglen = struct.unpack("<qI", hdr)
            tag = f.read(taglen).decode()
            kind = f.read(1)
            if kind == b"N":
                (dl,) = struct.unpack("<I", f.read(4))
                dims = Dims.parse(f.read(dl).decode())
                (n,) = struct.unpack("<Q", f.read(8))
                blk = DataBlock(ts=ts, tag=tag, nda=NDA(dims, _nda_from_bytes(dims, f.read(n))),
                                frame_ix=ix)
            else:
                (n,) = struct.unpack("<Q", f.read(8))
                blk = DataBlock(ts=ts, tag=tag, data=f.read(n), frame_ix=ix)
            ix += 1
            yield blk
