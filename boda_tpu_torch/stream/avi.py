"""MJPEG-in-AVI reader: a pure-python RIFF demuxer + JPEG frame decode.

A copy of ``boda_tpu/stream/avi.py`` (pure Python; the port imports nothing
of boda_tpu). Parity target: the reference's video ingestion is ffmpeg
(ref src/data-stream-ffmpeg.cc — libavformat demux +
libavcodec decode into image blocks). General codecs need ffmpeg and stay
feature-gated here, but MJPEG needs no codec library at all: each AVI
``##dc``/``##db`` chunk in the ``movi`` list IS a complete JPEG, so the
container walk is ~100 lines of struct and the decode is the same JPEG path
every image file already uses. This closes the video-container hole for the
one format that is honestly decodable in this build.

AVI structure (RIFF): ``RIFF('AVI ' LIST('hdrl' avih [LIST('strl' ...)]*)
LIST('movi' <##dc jpeg>*) [idx1])``; chunks are 2-byte aligned. The ``avih``
header's dwMicroSecPerFrame provides frame timestamps.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass


class AviError(ValueError):
    pass


@dataclass
class AviFrame:
    stream_ix: int
    frame_ix: int
    ts_us: int
    jpeg: bytes


def _read_chunk_header(buf: memoryview, i: int) -> tuple[bytes, int, int]:
    if i + 8 > len(buf):
        raise AviError(f"truncated chunk header at {i}")
    fourcc = bytes(buf[i:i + 4])
    (size,) = struct.unpack_from("<I", buf, i + 4)
    return fourcc, size, i + 8


def read_avi_mjpeg(fn: str):
    """Yield AviFrame for every MJPEG video chunk in an AVI file."""
    if not os.path.exists(fn):
        raise AviError(f"can't open avi file {os.path.basename(fn)!r}: "
                       f"no such file")
    with open(fn, "rb") as f:
        buf = memoryview(f.read())
    fourcc, size, i = _read_chunk_header(buf, 0)
    if fourcc != b"RIFF" or bytes(buf[i:i + 4]) != b"AVI ":
        raise AviError(f"{os.path.basename(fn)!r} is not a RIFF/AVI file "
                       f"(got {fourcc!r})")
    end = min(i + size, len(buf))
    i += 4
    us_per_frame = 33333  # fallback ~30fps if no avih
    frame_ix = 0
    while i < end:
        fourcc, size, i = _read_chunk_header(buf, i)
        body_end = i + size
        if fourcc == b"LIST":
            ltype = bytes(buf[i:i + 4])
            if ltype in (b"hdrl", b"movi"):
                # descend: hdrl for avih, movi for frames
                j = i + 4
                while j < body_end:
                    cc, sz, j = _read_chunk_header(buf, j)
                    if cc == b"avih" and sz >= 4:
                        (us_per_frame,) = struct.unpack_from("<I", buf, j)
                        us_per_frame = us_per_frame or 33333
                    elif cc[2:4] in (b"dc", b"db") and cc[:2].isdigit():
                        jpeg = bytes(buf[j:j + sz])
                        if jpeg[:2] == b"\xff\xd8":  # SOI: it's a JPEG
                            yield AviFrame(int(cc[:2]), frame_ix,
                                           frame_ix * us_per_frame, jpeg)
                            frame_ix += 1
                    j += sz + (sz & 1)  # chunks are 2-byte aligned
        i = body_end + (size & 1)


def write_avi_mjpeg(fn: str, jpegs: list[bytes], fps: int = 30,
                    sz: tuple[int, int] = (0, 0)) -> None:
    """Minimal MJPEG AVI muxer (fixture generation + avi sink)."""
    def chunk(cc: bytes, body: bytes) -> bytes:
        return cc + struct.pack("<I", len(body)) + body + \
            (b"\x00" if len(body) & 1 else b"")

    def lst(ltype: bytes, body: bytes) -> bytes:
        return chunk(b"LIST", ltype + body)

    w, h = sz
    avih = struct.pack("<14I", 10 ** 6 // fps, 0, 0, 0x10, len(jpegs),
                       0, 1, 0, w, h, 0, 0, 0, 0)
    strh = struct.pack("<4s4sI2H8IH2hH", b"vids", b"MJPG", 0, 0, 0, 0, 1,
                       fps, 0, len(jpegs), 0, 0xFFFFFFFF, 0, 0, 0, w, h)
    strf = struct.pack("<I2i2H2I2i2I", 40, w, h, 1, 24, 0x47504A4D,
                       w * h * 3, 0, 0, 0, 0)  # BITMAPINFOHEADER, 'MJPG'
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", j) for j in jpegs))
    body = b"AVI " + hdrl + movi
    with open(fn, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
