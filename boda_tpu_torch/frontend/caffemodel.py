"""Binary .caffemodel weight reader: a minimal protobuf wire-format decoder.

Counterpart of ``boda_tpu/frontend/caffemodel.py``, copied: pure Python and
numpy.

Parity target: ``must_read_binary_proto`` + weight transfer (ref
src/caffepb.cc:474,:583-603). Instead of compiled proto classes, decodes the
protobuf wire format generically and interprets just the fields needed for
weights:

  NetParameter:  name=1(s)  layers=2(V1LayerParameter*)  layer=100(LayerParameter*)
  LayerParameter:   name=1(s) type=2(s) blobs=7(BlobProto*)
  V1LayerParameter: bottom=2 top=3 name=4(s) type=5(enum) blobs=6(BlobProto*)
  BlobProto: num=1 channels=2 height=3 width=4 data=5(packed float)
             double_data=9(packed double) shape=7(BlobShape{dim=1 packed int64})
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


class WireError(ValueError):
    pass


def _read_varint(buf: memoryview, i: int) -> tuple[int, int]:
    out = 0
    shift = 0
    while True:
        if i >= len(buf):
            raise WireError("truncated varint")
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7
        if shift > 70:
            raise WireError("varint too long")


def parse_wire(buf: memoryview) -> dict[int, list]:
    """Decode one message level: field number -> list of raw values
    (int for varint/fixed, memoryview for length-delimited)."""
    out: dict[int, list] = {}
    i = 0
    n = len(buf)
    while i < n:
        key, i = _read_varint(buf, i)
        fno, wt = key >> 3, key & 7
        if wt == 0:  # varint
            v, i = _read_varint(buf, i)
        elif wt == 1:  # fixed64
            v = struct.unpack_from("<q", buf, i)[0]
            i += 8
        elif wt == 2:  # length-delimited
            ln, i = _read_varint(buf, i)
            if i + ln > n:
                raise WireError(f"field {fno}: length {ln} overruns buffer")
            v = buf[i:i + ln]
            i += ln
        elif wt == 5:  # fixed32
            v = struct.unpack_from("<i", buf, i)[0]
            i += 4
        else:
            raise WireError(f"unsupported wire type {wt} for field {fno}")
        out.setdefault(fno, []).append(v)
    return out


def _packed_floats(vals: list) -> np.ndarray:
    """Repeated float field: packed (length-delimited) or unpacked (fixed32s)."""
    chunks = []
    for v in vals:
        if isinstance(v, memoryview):
            chunks.append(np.frombuffer(v, dtype="<f4"))
        else:
            chunks.append(np.array([struct.unpack("<f", struct.pack("<i", v))[0]],
                                   dtype=np.float32))
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def _packed_varints(vals: list) -> list[int]:
    out = []
    for v in vals:
        if isinstance(v, memoryview):
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                out.append(x)
        else:
            out.append(int(v))
    return out


@dataclass
class Blob:
    shape: tuple[int, ...]
    data: np.ndarray


def _parse_blob(buf: memoryview) -> Blob:
    f = parse_wire(buf)
    if 7 in f:  # BlobShape
        shp = parse_wire(f[7][0])
        shape = tuple(_packed_varints(shp.get(1, [])))
    else:  # legacy 4D
        dims = [int(f.get(k, [1])[0]) for k in (1, 2, 3, 4)]
        shape = tuple(dims)
    if 5 in f:
        data = _packed_floats(f[5])
    elif 9 in f:
        chunks = [np.frombuffer(v, dtype="<f8") for v in f[9]
                  if isinstance(v, memoryview)]
        data = np.concatenate(chunks).astype(np.float32)
    else:
        data = np.zeros(int(np.prod(shape)) if shape else 0, np.float32)
    n = int(np.prod(shape)) if shape else data.size
    if data.size != n:
        # legacy blobs sometimes carry fewer meaningful dims; trust the data
        shape = (data.size,) if data.size else shape
    return Blob(shape, data.reshape(shape) if data.size else data)


# V1LayerParameter type enum -> canonical string (subset we care about)
_V1_TYPES = {
    4: "Convolution", 5: "Data", 6: "Dropout", 14: "InnerProduct", 15: "LRN",
    17: "Pooling", 18: "ReLU", 19: "Sigmoid", 20: "Softmax", 21: "SoftmaxWithLoss",
    3: "Concat", 25: "Eltwise", 23: "TanH", 39: "Deconvolution", 0: "None",
    33: "Slice", 1: "Accuracy", 8: "HDF5Data", 30: "Threshold", 22: "Split",
}


def read_caffemodel(fn: str) -> dict[str, list[Blob]]:
    """Read a .caffemodel: layer name -> list of weight blobs."""
    import os
    if not os.path.exists(fn):  # clean error, not a traceback (ref ifs_open)
        raise ValueError(
            f"can't open caffemodel file {os.path.basename(fn)!r}: "
            f"no such file")
    with open(fn, "rb") as f:
        buf = memoryview(f.read())
    net = parse_wire(buf)
    out: dict[str, list[Blob]] = {}
    for field, name_f, blobs_f in ((100, 1, 7), (2, 4, 6)):  # new, then V1
        for lbuf in net.get(field, []):
            lf = parse_wire(lbuf)
            if name_f not in lf:
                continue
            name = bytes(lf[name_f][0]).decode("utf-8", errors="replace")
            blobs = [_parse_blob(b) for b in lf.get(blobs_f, [])]
            if blobs:
                out[name] = blobs
    return out


# -- textproto dump (cnet_bpt_dump mode; ref caffepb.cc:709) -------------------
#
# The reference reads the trained NetParameter with compiled proto classes,
# clears blob data, and TextFormat-prints it. Here the same generic wire
# decoder drives a schema-directed printer: known fields get their proto
# names, unknown fields print as f<N> so nothing is silently dropped.

_DUMP_SCHEMA: dict[str, dict[int, tuple[str, str]]] = {
    "NetParameter": {1: ("name", "str"), 2: ("layers", "msg:V1LayerParameter"),
                     100: ("layer", "msg:LayerParameter")},
    "LayerParameter": {1: ("name", "str"), 2: ("type", "str"),
                       3: ("bottom", "str"), 4: ("top", "str"),
                       5: ("phase", "int"), 7: ("blobs", "msg:BlobProto")},
    "V1LayerParameter": {2: ("bottom", "str"), 3: ("top", "str"),
                         4: ("name", "str"), 5: ("type", "enum_v1"),
                         6: ("blobs", "msg:BlobProto")},
    "BlobProto": {1: ("num", "int"), 2: ("channels", "int"),
                  3: ("height", "int"), 4: ("width", "int"),
                  5: ("data", "packed_f32"), 7: ("shape", "msg:BlobShape"),
                  9: ("double_data", "packed_f64")},
    "BlobShape": {1: ("dim", "packed_varint")},
}
_DATA_FIELDS = {("BlobProto", 5), ("BlobProto", 9)}


def _esc(b: bytes) -> str:
    out = []
    for ch in b:
        if ch in (0x22, 0x5C):  # " and backslash
            out.append("\\" + chr(ch))
        elif 0x20 <= ch < 0x7F:
            out.append(chr(ch))
        else:
            out.append(f"\\{ch:03o}")
    return "".join(out)


def _fmt_float(v: float) -> str:
    # shortest round-trip decimal for the float32 value
    return np.format_float_positional(np.float32(v), unique=True, trim="0")


def dump_textproto(buf: bytes, remove_data: bool = True) -> str:
    """TextFormat-style dump of a binary NetParameter."""
    lines: list[str] = []

    def emit(msg: str, f: dict[int, list], ind: str) -> None:
        for fno in sorted(f, key=lambda n: (n != 1, n)):  # name first
            name, kind = _DUMP_SCHEMA.get(msg, {}).get(fno, (f"f{fno}", ""))
            if remove_data and (msg, fno) in _DATA_FIELDS:
                continue
            for v in f[fno]:
                if kind.startswith("msg:"):
                    lines.append(f"{ind}{name} {{")
                    emit(kind[4:], parse_wire(v), ind + "  ")
                    lines.append(f"{ind}}}")
                elif kind == "str":
                    lines.append(f'{ind}{name}: "{_esc(bytes(v))}"')
                elif kind == "enum_v1":
                    tname = _V1_TYPES.get(int(v), str(int(v)))
                    lines.append(f"{ind}{name}: {tname}")
                elif kind == "packed_varint":
                    for x in _packed_varints([v]):
                        lines.append(f"{ind}{name}: {x}")
                elif kind == "packed_f32":
                    for x in _packed_floats([v]):
                        lines.append(f"{ind}{name}: {_fmt_float(x)}")
                elif kind == "packed_f64":
                    arr = np.frombuffer(v, "<f8") if isinstance(v, memoryview) \
                        else np.zeros(0)
                    for x in arr:
                        lines.append(f"{ind}{name}: {x!r}")
                elif isinstance(v, memoryview):  # unknown length-delimited
                    lines.append(f'{ind}{name}: "{_esc(bytes(v))}"')
                else:
                    lines.append(f"{ind}{name}: {int(v)}")

    emit("NetParameter", parse_wire(memoryview(buf)), "")
    return "\n".join(lines) + "\n"
