"""Multi-process stream pipeline: headless cs_disp / proc_ipc / display_ipc.

Counterpart of ``boda_tpu/modes/proc_pipe.py`` on the port's
rtc/stream_util.py: the same frames and messages on the wire. The workers
are this package's own modes (``python -m boda_tpu_torch``), so a pipeline
needs nothing of boda_tpu. Parity targets: ref src/cap_app.cc:25 (``cs_disp`` — a master that spawns a
``proc_ipc`` processing worker and a ``display_ipc`` viewer worker over fds:
transports and pumps camera frames through both), cap_app.cc:127
(``proc_ipc`` — the per-row pixel luma-sort effect), cap_app.cc:198
(``display_ipc`` — the viewer process).

This environment has no camera and no SDL, so the composition is rebuilt
headless: the master reads frames from any ``data_stream`` source (e.g.
``img-dir-src``), ships them to the proc worker over the framed byte-stream
transport (rtc/stream_util.py — same fds:/fns:/tcp: schemes as the
reference), receives the processed frames, forwards them to the display
worker, and the display worker renders PNGs into its output dir (the
headless "window"). The reference's shared-memory images + 1-byte
done-tokens become explicit framed messages; the effect itself is the
*converged* state of the reference's randomized adjacent-swap loop (each
row's pixels sorted by luma, descending), computed deterministically.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np

from ..config import Field, Mode, register
from ..rtc.stream_util import ByteStream, make_stream

_QUIT = "quit"
_FRAME = "frame"


def _luma(rgba: np.ndarray) -> np.ndarray:
    """Integer BT.601 luma of an (..., 4) uint8 RGBA array (ref rgba2y)."""
    r = rgba[..., 0].astype(np.uint32)
    g = rgba[..., 1].astype(np.uint32)
    b = rgba[..., 2].astype(np.uint32)
    return (77 * r + 150 * g + 29 * b) >> 8


def row_luma_sort(rgba: np.ndarray) -> np.ndarray:
    """Sort each row's pixels by luma, brightest left (the fixed point of the
    reference's swap-if-darker-before-brighter loop, cap_app.cc:148-168)."""
    order = np.argsort(-_luma(rgba), axis=1, kind="stable")
    return np.take_along_axis(rgba, order[..., None], axis=1)


def write_frame(bs: ByteStream, frame_ix: int, tag: str,
                rgba: np.ndarray) -> None:
    h, w, c = rgba.shape
    bs.write_msg(_FRAME, frame_ix, tag, h, w, c,
                 np.ascontiguousarray(rgba).tobytes())


def read_frame(bs: ByteStream):
    """-> (frame_ix, tag, rgba) or None on quit."""
    msg = bs.read_msg()
    if msg[0] == _QUIT:
        return None
    cmd, frame_ix, tag, h, w, c, raw = msg
    assert cmd == _FRAME, msg
    rgba = np.frombuffer(raw, np.uint8).reshape(h, w, c)
    return frame_ix, tag, rgba


def spawn_worker(mode: str, *extra_args: str):
    """Fork a worker child of this package connected by a socketpair (ref
    create_boda_worker, cap_app.cc:111: fds: over an inherited socket)."""
    ours, theirs = socket.socketpair()
    fd = theirs.fileno()
    cmd = [sys.executable, "-m", "boda_tpu_torch", mode,
           f"--boda_parent_addr=fds:{fd}:{fd}", *extra_args]
    # the child imports this package from wherever the master runs
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
    proc = subprocess.Popen(cmd, pass_fds=(fd,), close_fds=True, env=env)
    theirs.close()
    return ByteStream(ours.makefile("rb", buffering=0),
                      ours.makefile("wb"), f"{mode}:child"), proc


@register("mode", "proc_ipc", help="frame-processing worker (row luma sort)")
class ProcIpc(Mode):
    boda_parent_addr = Field(str, req=True,
                             help="parent transport: fds:R:W | fns:A:B | tcp:host:port")

    def main(self) -> None:
        bs = make_stream(self.boda_parent_addr)
        n = 0
        while True:
            f = read_frame(bs)
            if f is None:
                break
            frame_ix, tag, rgba = f
            write_frame(bs, frame_ix, tag, row_luma_sort(rgba))
            n += 1
        bs.write_msg("done", n)
        bs.close()


@register("mode", "display_ipc", help="frame-viewer worker (renders PNGs)")
class DisplayIpc(Mode):
    boda_parent_addr = Field(str, req=True,
                             help="parent transport: fds:R:W | fns:A:B | tcp:host:port")

    def main(self) -> None:
        from ..utils.img_io import Img
        bs = make_stream(self.boda_parent_addr)
        n = 0
        while True:
            f = read_frame(bs)
            if f is None:
                break
            frame_ix, tag, rgba = f
            fn = f"frame_{frame_ix:04d}.png"
            Img(rgba).save(self.out_path(fn))
            bs.write_msg("wrote", fn)
            n += 1
        bs.write_msg("done", n)
        bs.close()


@register("mode", "cs_disp",
          help="multi-process pipeline: src -> proc_ipc -> display_ipc")
class CsDisp(Mode):
    src = Field("data_stream", req=True, help="image-block source")
    max_frames = Field(int, default="8", help="frame limit")

    def main(self) -> None:
        from .. import stream  # noqa: F401 (registers stream types)
        proc_bs, proc_p = spawn_worker("proc_ipc")
        disp_bs, disp_p = spawn_worker(
            "display_ipc", f"--boda_output_dir={self.boda_output_dir}")
        try:
            self.src.start()
            n = 0
            while n < self.max_frames:
                b = self.src.read()
                if b is None:
                    break
                if b.nda is None or b.nda.data.ndim != 3 \
                        or b.nda.data.shape[-1] != 4:
                    continue
                tag = b.tag or f"frame_{n}"
                # proc round-trip (the reference's proc_done handshake)
                write_frame(proc_bs, n, tag, np.asarray(b.nda.data, np.uint8))
                pf = read_frame(proc_bs)
                assert pf is not None
                # display round-trip (the redisplay handshake)
                write_frame(disp_bs, *pf)
                ack = disp_bs.read_msg()
                print(f"cs_disp: {tag} -> proc -> {ack[1]}")
                n += 1
        finally:
            for bs, p in ((proc_bs, proc_p), (disp_bs, disp_p)):
                try:
                    bs.write_msg(_QUIT)
                    done = bs.read_msg()
                    assert done[0] == "done", done
                except Exception:
                    pass
                bs.close()
                p.wait(timeout=60)
        print(f"cs_disp: {n} frames through 2 workers "
              f"(proc rc={proc_p.returncode} disp rc={disp_p.returncode})")
