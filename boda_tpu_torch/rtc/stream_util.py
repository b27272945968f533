"""Byte-stream transports + binary message framing for remote execution.

A copy of ``boda_tpu/rtc/stream_util.py`` (pure Python; the port imports
nothing of boda_tpu): the same transports and the same bytes on the wire, so
a worker of either package can serve a master of the other. Parity target:
``stream_util.{H,cc}`` (ref src/stream_util.cc:22,:85 —
``fds:R:W`` inherited file descriptors, ``fns:A:B`` named fifos,
``tcp:host:port`` sockets) and the bwrite/bread binary serialization layer
(ref boda_base.H io section): framed messages of typed parts
(str/bytes/int/float), with tensors as (dims-lexp, raw bytes) pairs.
"""

from __future__ import annotations

import os
import socket
import struct
from typing import Union

Part = Union[str, bytes, int, float]

_T_STR, _T_BYTES, _T_INT, _T_FLOAT = b"S", b"B", b"I", b"F"


class StreamError(RuntimeError):
    pass


class ByteStream:
    """Framed message IO over a pair of read/write fds or a socket."""

    def __init__(self, rfile, wfile, name: str = ""):
        self.rfile = rfile
        self.wfile = wfile
        self.name = name

    # -- framing -------------------------------------------------------------
    def write_msg(self, *parts: Part) -> None:
        buf = [struct.pack("<I", len(parts))]
        for p in parts:
            if isinstance(p, bool):
                p = int(p)
            if isinstance(p, str):
                b = p.encode()
                buf.append(_T_STR + struct.pack("<Q", len(b)) + b)
            elif isinstance(p, (bytes, bytearray, memoryview)):
                b = bytes(p)
                buf.append(_T_BYTES + struct.pack("<Q", len(b)) + b)
            elif isinstance(p, int):
                buf.append(_T_INT + struct.pack("<q", p))
            elif isinstance(p, float):
                buf.append(_T_FLOAT + struct.pack("<d", p))
            else:
                raise StreamError(f"can't serialize {type(p)}")
        self.wfile.write(b"".join(buf))
        self.wfile.flush()

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.rfile.read(n - len(out))
            if not chunk:
                raise StreamError(f"stream {self.name}: EOF "
                                  f"(peer died or closed connection)")
            out += chunk
        return out

    def read_msg(self) -> list[Part]:
        (n,) = struct.unpack("<I", self._read_exact(4))
        parts: list[Part] = []
        for _ in range(n):
            t = self._read_exact(1)
            if t == _T_INT:
                parts.append(struct.unpack("<q", self._read_exact(8))[0])
            elif t == _T_FLOAT:
                parts.append(struct.unpack("<d", self._read_exact(8))[0])
            elif t in (_T_STR, _T_BYTES):
                (ln,) = struct.unpack("<Q", self._read_exact(8))
                b = self._read_exact(ln)
                parts.append(b.decode() if t == _T_STR else b)
            else:
                raise StreamError(f"bad part type {t!r}")
        return parts

    def close(self) -> None:
        for f in (self.rfile, self.wfile):
            try:
                f.close()
            except Exception:
                pass


def make_stream(addr: str, listen: bool = False) -> ByteStream:
    """Open a transport by address string (ref make_stream_t):
    ``fds:R:W`` | ``fns:A:B`` | ``tcp:host:port`` (listen=True accepts one
    connection instead of connecting)."""
    scheme, _, rest = addr.partition(":")
    if scheme == "fds":
        r, w = rest.split(":")
        return ByteStream(os.fdopen(int(r), "rb", buffering=0),
                          os.fdopen(int(w), "wb"), addr)
    if scheme == "fns":
        a, b = rest.split(":")
        # fifo open order matters: reader blocks until writer opens; use the
        # documented convention: client opens a-read/b-write, worker inverse
        if listen:
            rf = open(a, "rb", buffering=0)
            wf = open(b, "wb")
        else:
            wf = open(a, "wb")
            rf = open(b, "rb", buffering=0)
        return ByteStream(rf, wf, addr)
    if scheme == "tcp":
        host, port = rest.rsplit(":", 1)
        if listen:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host or "127.0.0.1", int(port)))
            srv.listen(1)
            conn, _ = srv.accept()
            srv.close()
        else:
            conn = socket.create_connection((host or "127.0.0.1", int(port)),
                                            timeout=60)
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return ByteStream(conn.makefile("rb", buffering=0),
                          conn.makefile("wb"), addr)
    raise StreamError(f"unknown stream scheme {scheme!r} in {addr!r}")
