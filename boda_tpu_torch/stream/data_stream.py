"""Data streams: typed, timestamped block pipelines, and the binary
block-stream container.

Counterpart of ``boda_tpu/stream/data_stream.py`` (itself modelled on ref
src/data-stream*.cc): ``DataBlock`` is a timestamped, tagged block of bytes
or an ND-array, possibly with named sub-blocks; sources, transforms and
sinks are registered ``data_stream`` types composed into pipelines. Every
type of boda_tpu's is here under the same name, with the same fields and
the same output: file/csv/text/image/gen sources; start-stop-skip, stamp,
crop, ts-merge, merge, seq, sync, fold, flatten, sort-by-ts, pass and
adj-angle; null/print/block-file/csv sinks; add-img, add-img-pts, velo-src
and render-pts; pcap, mxnet-brick, MJPEG-in-AVI, rosbag, dumpvideo and qt
streams; hash-pair/hash-check; img-add-text; velodyne-gen, velo-cloud-gen
and velo-rev. ffmpeg stays a feature-gated error, as in boda_tpu. Host code
on numpy, as boda_tpu's is.

The block-file format is the one the record files in testdata/lmdb use
(``frontend/datum.py`` reads and writes them). An ND block's dims carry
their type name; a ``bfloat16`` block's bytes are widened to float32 on the
host (numpy has no bfloat16), which is exact.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import ConfigError, Field, get_env, register, register_base
from ..utils.dims import NDA, Dims, np_dtype


@dataclass
class DataBlock:
    """ref data_block_t (data-stream.H:24): timestamp + tag + payload."""
    ts: int = 0                      # nanoseconds
    tag: str = ""
    data: Optional[bytes] = None     # raw payload
    nda: Optional[NDA] = None        # nd-array payload
    subs: dict[str, "DataBlock"] = field(default_factory=dict)  # nested blocks
    frame_ix: int = -1               # its place in its stream, as read

    def brief(self) -> str:
        kind = ("nda" + str(self.nda.dims)) if self.nda is not None else \
            (f"bytes[{len(self.data)}]" if self.data is not None else
             f"subs[{','.join(self.subs)}]")
        return f"ts={self.ts} tag={self.tag} ix={self.frame_ix} {kind}"


@register_base("data_stream", tid_vn="stream")
class DataStream:
    """Source (read) / transform (proc) / sink (proc, no output)."""

    def start(self) -> None:
        pass

    def read(self) -> Optional[DataBlock]:  # sources override
        raise ConfigError(f"{type(self).__name__} is not a source")

    def proc(self, blk: DataBlock) -> Optional[DataBlock]:  # transforms/sinks
        return blk

    def finish(self) -> None:
        pass


def _out_path(fn: str) -> str:
    """Resolve a sink's relative output filename under the running mode's
    boda_output_dir (pushed into the config env by config.run_mode)."""
    if os.path.isabs(fn):
        return fn
    d = get_env().get("boda_output_dir", ".")
    os.makedirs(d, exist_ok=True)
    return os.path.join(d, fn)


# -- binary block container ------------------------------------------------------

_MAGIC = b"bodablk1"


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


# -- sources ------------------------------------------------------------------------

@register("data_stream", "block-file-src", help="read a binary block-stream file")
class BlockFileSrc(DataStream):
    fn = Field("filename", req=True, help="input block-stream file")

    def start(self) -> None:
        self._it = read_block_stream(self.fn)

    def read(self):
        return next(self._it, None)


@register("data_stream", "text-src", help="one block per text line")
class TextSrc(DataStream):
    fn = Field("filename", req=True, help="input text file")

    def start(self) -> None:
        self._f = open(self.fn, "rb")
        self._ix = 0

    def read(self):
        line = self._f.readline()
        if not line:
            return None
        b = DataBlock(ts=self._ix, tag="line", data=line.rstrip(b"\n"),
                      frame_ix=self._ix)
        self._ix += 1
        return b


@register("data_stream", "csv-src", help="csv rows as float ndas (col 0 = ts)")
class CsvSrc(DataStream):
    fn = Field("filename", req=True, help="input csv")
    ts_col = Field(int, default="0", help="timestamp column (-1: row index)")

    def start(self) -> None:
        self._f = open(self.fn)
        self._ix = 0

    def read(self):
        while True:
            line = self._f.readline()
            if not line:
                return None
            line = line.strip()
            if line and not line.startswith("#"):
                break
        vals = np.array([float(v) for v in line.split(",")], np.float32)
        ts = self._ix if self.ts_col < 0 else int(vals[self.ts_col])
        b = DataBlock(ts=ts, tag="row", nda=NDA.from_array(vals),
                      frame_ix=self._ix)
        self._ix += 1
        return b


@register("data_stream", "img-dir-src", help="images in a directory as RGBA blocks")
class ImgDirSrc(DataStream):
    dir = Field("filename", req=True, help="directory of images")
    glob = Field(str, default="", help="substring filter on filenames")

    def start(self) -> None:
        fns = sorted(os.listdir(self.dir))
        self._fns = [os.path.join(self.dir, f) for f in fns
                     if (not self.glob or self.glob in f)
                     and f.lower().endswith((".png", ".jpg", ".jpeg"))]
        self._ix = 0

    def read(self):
        from ..utils.img_io import Img
        if self._ix >= len(self._fns):
            return None
        img = Img.load(self._fns[self._ix])
        b = DataBlock(ts=self._ix, tag=os.path.basename(self._fns[self._ix]),
                      nda=NDA.from_array(img.data, ("y", "x", "c")),
                      frame_ix=self._ix)
        self._ix += 1
        return b


@register("data_stream", "gen-src", help="synthetic nda blocks (for tests)")
class GenSrc(DataStream):
    n = Field(int, default="10", help="number of blocks")
    sz = Field(int, default="16", help="elements per block")
    ts_step = Field(int, default="10", help="timestamp step")
    ts0 = Field(int, default="0", help="first timestamp")

    def start(self) -> None:
        self._ix = 0

    def read(self):
        if self._ix >= self.n:
            return None
        v = np.arange(self.sz, dtype=np.float32) + self._ix
        b = DataBlock(ts=self.ts0 + self._ix * self.ts_step, tag="gen",
                      nda=NDA.from_array(v), frame_ix=self._ix)
        self._ix += 1
        return b


# -- transforms ------------------------------------------------------------------------

@register("data_stream", "start-stop-skip", help="slice a stream: [start, stop) step skip+1")
class StartStopSkip(DataStream):
    src = Field("data_stream", req=True, help="upstream source")
    start_ix = Field(int, default="0", help="first frame to keep")
    stop_ix = Field(int, default="0", help="stop before this frame (0=end)")
    skip = Field(int, default="0", help="frames to skip between kept frames")

    def start(self) -> None:
        self.src.start()
        self._ix = 0

    def read(self):
        while True:
            b = self.src.read()
            if b is None:
                return None
            ix = self._ix
            self._ix += 1
            if ix < self.start_ix:
                continue
            if self.stop_ix and ix >= self.stop_ix:
                return None
            if (ix - self.start_ix) % (self.skip + 1):
                continue
            return b


@register("data_stream", "stamp", help="restamp block timestamps")
class Stamp(DataStream):
    src = Field("data_stream", req=True, help="upstream source")
    ts0 = Field(int, default="0", help="first ts")
    step = Field(int, default="1", help="ts step")

    def start(self) -> None:
        self.src.start()
        self._n = 0

    def read(self):
        b = self.src.read()
        if b is not None:
            b.ts = self.ts0 + self._n * self.step
            self._n += 1
        return b


@register("data_stream", "crop", help="crop image-like (y,x,...) nda blocks")
class Crop(DataStream):
    src = Field("data_stream", req=True, help="upstream source")
    y0 = Field(int, default="0", help="top")
    x0 = Field(int, default="0", help="left")
    y1 = Field(int, req=True, help="bottom (exclusive)")
    x1 = Field(int, req=True, help="right (exclusive)")

    def start(self) -> None:
        self.src.start()

    def read(self):
        b = self.src.read()
        if b is None or b.nda is None:
            return b
        d = b.nda.data[self.y0:self.y1, self.x0:self.x1]
        names = b.nda.dims.names
        b.nda = NDA.from_array(np.ascontiguousarray(d), names)
        return b


@register("data_stream", "ts-merge", help="merge streams by nearest timestamp")
class TsMerge(DataStream):
    """Primary stream drives; each secondary contributes its nearest-ts block
    as a nested sub-block (ref sync/merge, data-stream.cc:622)."""
    primary = Field("data_stream", req=True, help="driving stream")
    secondary = Field((dict, "data_stream"), req=True, help="named followers")
    max_dt = Field(int, default="1000000000", help="max |ts delta| to accept")

    def start(self) -> None:
        self.primary.start()
        self._bufs: dict[str, list[DataBlock]] = {}
        for name, s in self.secondary.items():
            s.start()
            self._bufs[name] = []
            while True:
                b = s.read()
                if b is None:
                    break
                self._bufs[name].append(b)

    def read(self):
        p = self.primary.read()
        if p is None:
            return None
        for name, buf in self._bufs.items():
            if not buf:
                continue
            best = min(buf, key=lambda b: abs(b.ts - p.ts))
            if abs(best.ts - p.ts) <= self.max_dt:
                p.subs[name] = best
        return p


@register("data_stream", "merge",
          help="read one block from each named stream per step; subs named by key")
class Merge(DataStream):
    """ref data_stream_merge_t (data-stream.cc:409): produce one block per read
    holding a sub-block from every input stream; keeps going until *all* inputs
    are exhausted (exhausted inputs simply stop contributing subs)."""
    streams = Field((dict, "data_stream"), req=True, help="named input streams")

    def start(self) -> None:
        for s in self.streams.values():
            s.start()
        self._done: set[str] = set()
        self._n = 0

    def read(self):
        out = DataBlock(tag="merge", frame_ix=self._n)
        first = True
        for name, s in self.streams.items():
            if name in self._done:
                continue
            b = s.read()
            if b is None:
                self._done.add(name)
                continue
            out.subs[name] = b
            if first:
                out.ts = b.ts
                first = False
        if not out.subs:
            return None
        self._n += 1
        return out


@register("data_stream", "seq",
          help="concatenate finite streams: read each to exhaustion in order")
class Seq(DataStream):
    """ref data_stream_seq_t (data-stream.cc:462)."""
    streams = Field((list, "data_stream"), req=True, help="input streams, in order")

    def start(self) -> None:
        for s in self.streams:
            s.start()
        self._ix = 0

    def read(self):
        while self._ix < len(self.streams):
            b = self.streams[self._ix].read()
            if b is not None:
                return b
            self._ix += 1
        return None


@register("data_stream", "sync",
          help="primary-driven streaming nearest-ts alignment of named streams")
class Sync(DataStream):
    """ref data_stream_sync_t (data-stream.cc:622): for each primary block, emit
    a block whose subs hold the nearest-by-ts block of every secondary stream.
    Streaming (two-block window per secondary, unlike ts-merge's full buffering);
    if ``max_dt`` is nonzero and any secondary has no block within it, the
    primary block is *skipped* entirely (ref max_delta_ns semantics)."""
    primary = Field("data_stream", req=True, help="driving stream")
    secondary = Field((dict, "data_stream"), req=True, help="named follower streams")
    max_dt = Field(int, default="0", help="if nonzero: max |ts delta|, else skip primary")

    def start(self) -> None:
        self.primary.start()
        self._win: dict[str, list[Optional[DataBlock]]] = {}
        for name, s in self.secondary.items():
            s.start()
            b0 = s.read()
            if b0 is None:
                raise ConfigError(f"sync: no blocks at all in secondary stream '{name}'")
            self._win[name] = [b0, s.read()]
        self._n = 0

    def read(self):
        while True:
            p = self.primary.read()
            if p is None:
                return None
            ok = True
            picks: dict[str, DataBlock] = {}
            for name, s in self.secondary.items():
                win = self._win[name]
                # advance window until tail is the last block with ts < primary ts
                while win[1] is not None and win[1].ts < p.ts:
                    win[0] = win[1]
                    win[1] = s.read()
                tail_dt = abs(win[0].ts - p.ts)
                head_closer = win[1] is not None and abs(win[1].ts - p.ts) < tail_dt
                best = win[1] if head_closer else win[0]
                if self.max_dt and abs(best.ts - p.ts) > self.max_dt:
                    ok = False
                    break
                picks[name] = best
            if not ok:
                continue
            p.subs.update(picks)
            p.frame_ix = self._n
            self._n += 1
            return p


@register("data_stream", "fold",
          help="move sub-block 'src' to be a sub-sub-block of sub 'targ' (or drop)")
class Fold(DataStream):
    """ref data_stream_fold_t (data-stream.cc:542); subs are named here, so
    src/targ are sub-block names rather than indices."""
    src = Field("data_stream", req=True, help="upstream (blocks must have subs)")
    fold_src = Field(str, req=True, help="name of sub-block to fold")
    fold_targ = Field(str, default="", help="name of target sub (empty: drop src)")

    def start(self) -> None:
        self.src.start()

    def read(self):
        b = self.src.read()
        if b is None:
            return None
        if not b.subs:
            raise ConfigError("fold: input data block has no subblocks")
        if self.fold_src not in b.subs:
            raise ConfigError(f"fold: no sub-block named '{self.fold_src}' in input "
                              f"block (has: {','.join(b.subs)})")
        sb = b.subs.pop(self.fold_src)
        if self.fold_targ:
            if self.fold_targ not in b.subs:
                raise ConfigError(f"fold: no sub-block named '{self.fold_targ}' in "
                                  f"input block (has: {','.join(b.subs)})")
            b.subs[self.fold_targ].subs[self.fold_src] = sb
        return b


@register("data_stream", "flatten",
          help="flatten subs-of-subs into one level ('outer.inner' names)")
class Flatten(DataStream):
    """ref data_stream_flatten_t (data-stream.cc:506): every sub-block must
    itself have subs; the output block holds all sub-subs, dot-prefixed by the
    outer sub name so merges of syncs stay collision-free."""
    src = Field("data_stream", req=True, help="upstream (blocks of blocks)")

    def start(self) -> None:
        self.src.start()

    def read(self):
        b = self.src.read()
        if b is None:
            return None
        if not b.subs:
            raise ConfigError("flatten: input data block must have subblocks")
        out = DataBlock(ts=b.ts, tag=b.tag, frame_ix=b.frame_ix)
        for name, sb in b.subs.items():
            if not sb.subs:
                raise ConfigError("flatten: all stream output data blocks must "
                                  f"have subblocks (sub '{name}' does not)")
            for iname, isb in sb.subs.items():
                out.subs[f"{name}.{iname}"] = isb
        return out


@register("data_stream", "sort-by-ts",
          help="buffer up to max_buf blocks, emit in timestamp order")
class SortByTs(DataStream):
    """ref data_stream_sort_by_ts_t (data-stream.cc:859): buffer blocks until
    end-of-stream (or ``max_buf`` reached), then flush sorted by ts."""
    src = Field("data_stream", req=True, help="upstream source")
    max_buf = Field(int, default="0", help="flush when buffer reaches N (0=unlimited)")

    def start(self) -> None:
        self.src.start()
        self._buf: list[DataBlock] = []
        self._flush_pos = -1

    def read(self):
        while True:
            if self._flush_pos >= 0:  # flush in progress
                b = self._buf[self._flush_pos]
                self._flush_pos += 1
                if self._flush_pos == len(self._buf):
                    self._buf = []
                    self._flush_pos = -1
                return b
            b = self.src.read()
            if b is not None:
                self._buf.append(b)
                if self.max_buf and len(self._buf) >= self.max_buf:
                    self._buf.sort(key=lambda x: x.ts)
                    self._flush_pos = 0
                continue
            if not self._buf:
                return None
            self._buf.sort(key=lambda x: x.ts)
            self._flush_pos = 0


@register("data_stream", "pass", help="identity transform")
class Pass(DataStream):
    """ref data_stream_pass_t (data-stream.cc:965)."""
    src = Field("data_stream", req=True, help="upstream source")

    def start(self) -> None:
        self.src.start()

    def read(self):
        return self.src.read()


@register("data_stream", "adj-angle",
          help="normalize angle ndas (degrees) to [-180,180) with offset")
class AdjAngle(DataStream):
    """ref data_stream_adj_angle_t (data-stream.cc:944)."""
    src = Field("data_stream", req=True, help="upstream source")
    adj = Field(float, default="0.0", help="added offset (degrees)")
    negate = Field(int, default="0", help="if nonzero, negate input angle")

    def start(self) -> None:
        self.src.start()

    def read(self):
        b = self.src.read()
        if b is None:
            return None
        if b.nda is None:
            raise ConfigError("can only adj-angle on data blocks with nda data, "
                              "but nda was null in input db.")
        v = b.nda.data.astype(np.float64)
        if self.negate:
            v = -v
        # np.mod result is always in [0, 360), so shifting back to
        # [-180, 180) is an unconditional subtract
        v = np.mod(v + self.adj + 180.0, 360.0) - 180.0
        out = v if b.nda.data.dtype.kind == "f" else np.rint(v)
        b.nda = NDA(b.nda.dims, np.ascontiguousarray(out.astype(b.nda.data.dtype)))
        return b


# -- sinks ------------------------------------------------------------------------------

@register("data_stream", "null-sink", help="discard blocks (count only)")
class NullSink(DataStream):
    def start(self) -> None:
        self.n = 0

    def proc(self, blk):
        self.n += 1
        return None


@register("data_stream", "print-sink", help="print block briefs")
class PrintSink(DataStream):
    deep = Field(int, default="0", help="if nonzero, also print nested sub-blocks")

    def proc(self, blk):
        print(blk.brief())
        if self.deep:
            self._print_subs(blk, "  ")
        return None

    def _print_subs(self, blk: DataBlock, indent: str) -> None:
        for name, sb in blk.subs.items():
            print(f"{indent}{name}: {sb.brief()}")
            self._print_subs(sb, indent + "  ")


@register("data_stream", "block-file-sink", help="write a binary block-stream file")
class BlockFileSink(DataStream):
    fn = Field("filename", req=True, help="output file")

    def start(self) -> None:
        self._blocks: list[DataBlock] = []

    def proc(self, blk):
        self._blocks.append(blk)
        return None

    def finish(self) -> None:
        write_block_stream(_out_path(self.fn), self._blocks)


@register("data_stream", "csv-sink", help="write nda blocks as csv rows")
class CsvSink(DataStream):
    fn = Field("filename", req=True, help="output csv")

    def start(self) -> None:
        self._f = open(_out_path(self.fn), "w")

    def proc(self, blk):
        if blk.nda is not None:
            vals = ",".join(f"{float(v):g}" for v in blk.nda.data.reshape(-1))
            self._f.write(f"{blk.ts},{vals}\n")
        return None

    def finish(self) -> None:
        self._f.close()


@register("data_stream", "add-img", help="convert nda blocks to RGBA image blocks")
class AddImg(DataStream):
    """ref data-to-img.cc:12 add-img: normalize an nda into a viewable image."""
    src = Field("data_stream", req=True, help="upstream source")

    def start(self) -> None:
        self.src.start()

    def proc_one(self, blk):
        if blk is None or blk.nda is None:
            return blk
        d = blk.nda.data.astype(np.float32)
        if d.ndim == 3 and d.shape[2] in (3, 4):
            rgb = d[..., :3]
        elif d.ndim == 2:
            rgb = np.repeat(d[..., None], 3, axis=2)
        else:
            return blk
        lo, hi = float(rgb.min()), float(rgb.max())
        scale = 255.0 / (hi - lo) if hi > lo else 1.0
        u8 = ((rgb - lo) * scale).astype(np.uint8)
        a = np.full(u8.shape[:2] + (1,), 255, np.uint8)
        from ..utils.dims import NDA
        blk.nda = NDA.from_array(np.concatenate([u8, a], axis=2), ("y", "x", "c"))
        return blk

    def read(self):
        return self.proc_one(self.src.read())


@register("data_stream", "add-img-pts", help="render (N,>=3) point blocks top-down")
class AddImgPts(DataStream):
    """Point-cloud to image (the os-render.cc OSMesa renderer's role, done as
    a top-down orthographic projection; no GL in this environment)."""
    src = Field("data_stream", req=True, help="upstream point source")
    img_sz = Field(int, default="256", help="output image size")
    rng_m = Field(float, default="100.0", help="meters covered half-width")

    def start(self) -> None:
        self.src.start()

    def read(self):
        blk = self.src.read()
        if blk is None or blk.nda is None or blk.nda.data.ndim != 2 \
                or blk.nda.data.shape[1] < 3:
            return blk
        pts = blk.nda.data
        n = self.img_sz
        img = np.zeros((n, n, 4), np.uint8)
        img[:, :, 3] = 255
        xs = ((pts[:, 0] / self.rng_m * 0.5 + 0.5) * (n - 1)).astype(int)
        ys = ((pts[:, 1] / self.rng_m * 0.5 + 0.5) * (n - 1)).astype(int)
        ok = (xs >= 0) & (xs < n) & (ys >= 0) & (ys < n)
        inten = pts[:, 3].astype(np.uint8) if pts.shape[1] > 3 else 255
        img[ys[ok], xs[ok], 1] = inten[ok] if pts.shape[1] > 3 else 255
        from ..utils.dims import NDA
        blk.nda = NDA.from_array(img, ("y", "x", "c"))
        return blk


@register("data_stream", "velo-src",
          help="velodyne raw packet file -> (N,4) point blocks per packet")
class VeloSrc(DataStream):
    """File of raw 1206-byte VLP-16 packets -> one (N,4) x/y/z/refl point
    block per packet (the source role of ref src/data-stream-velo.cc)."""
    fn = Field("filename", req=True, help="raw packet file")

    def start(self) -> None:
        from .velodyne import PACKET_BYTES
        with open(self.fn, "rb") as f:
            data = f.read()
        self._pkts = [data[i:i + PACKET_BYTES]
                      for i in range(0, len(data) - PACKET_BYTES + 1,
                                     PACKET_BYTES)]
        self._ix = 0

    def read(self):
        from ..utils.dims import NDA
        from .velodyne import packet_to_points_vlp16
        if self._ix >= len(self._pkts):
            return None
        pts = packet_to_points_vlp16(self._pkts[self._ix])
        blk = DataBlock(ts=self._ix, tag="velo-pts",
                        nda=NDA.from_array(pts.astype(np.float32),
                                           ("pt", "attr")))
        self._ix += 1
        return blk


@register("data_stream", "render-pts",
          help="perspective-render (N,>=3) point blocks (pinhole + z-buffer)")
class RenderPts(DataStream):
    """3D perspective point renderer — the full role of the reference's
    OSMesa point-cloud renderer (ref src/os-render.cc:80 render_pts: GL
    camera at eye_pos looking at look_at, gluPerspective(fov), point
    splats), implemented as a software pinhole camera with a z-buffer so
    nearer points win, no GL needed. Points color by reflectance (column 3)
    through a green-hot ramp; background black."""
    src = Field("data_stream", req=True, help="upstream point source")
    img_y = Field(int, default="256", help="output image height")
    img_x = Field(int, default="384", help="output image width")
    fov_deg = Field(float, default="60.0", help="vertical field of view")
    eye = Field((list, float), default="(x=0,y=-20,z=10)",
                help="camera position (meters)")
    look_at = Field((list, float), default="(x=0,y=0,z=0)", help="aim point")
    pt_sz = Field(int, default="2", help="splat size in pixels")

    def start(self) -> None:
        self.src.start()
        eye = np.array(list(self.eye) or [0.0, -20.0, 10.0], np.float32)
        tgt = np.array(list(self.look_at) or [0.0, 0.0, 0.0], np.float32)
        fwd = tgt - eye
        fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
        up0 = np.array([0.0, 0.0, 1.0], np.float32)
        if abs(float(fwd @ up0)) > 0.99:  # looking straight up/down
            up0 = np.array([0.0, 1.0, 0.0], np.float32)
        right = np.cross(fwd, up0)
        right = right / max(np.linalg.norm(right), 1e-9)
        up = np.cross(right, fwd)
        self._eye, self._rot = eye, np.stack([right, up, fwd])  # world->cam

    def read(self):
        blk = self.src.read()
        if blk is None or blk.nda is None or blk.nda.data.ndim != 2 \
                or blk.nda.data.shape[1] < 3:
            return blk
        pts = blk.nda.data.astype(np.float32)
        cam = (pts[:, :3] - self._eye) @ self._rot.T  # (right, up, fwd)
        z = cam[:, 2]
        ok = z > 0.1  # near clip
        cam, z = cam[ok], z[ok]
        refl = pts[ok, 3] if pts.shape[1] > 3 else np.full(len(z), 255.0)
        h, w = self.img_y, self.img_x
        f = (h / 2.0) / np.tan(np.radians(self.fov_deg) / 2.0)
        xs = (w / 2.0 + f * cam[:, 0] / z).astype(np.int32)
        ys = (h / 2.0 - f * cam[:, 1] / z).astype(np.int32)
        img = np.zeros((h, w, 4), np.uint8)
        img[:, :, 3] = 255
        zbuf = np.full((h, w), np.inf, np.float32)
        r = max(int(self.pt_sz), 1)
        inb = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
        xs, ys, z, refl = xs[inb], ys[inb], z[inb], refl[inb]
        # z-buffered splat: paint far-to-near so near points overwrite
        order = np.argsort(-z)
        for i in order:
            y0, y1 = max(ys[i] - r // 2, 0), min(ys[i] + (r + 1) // 2, h)
            x0, x1 = max(xs[i] - r // 2, 0), min(xs[i] + (r + 1) // 2, w)
            if z[i] >= zbuf[y0:y1, x0:x1].min():
                sub = zbuf[y0:y1, x0:x1]
                m = z[i] < sub
                if not m.any():
                    continue
            else:
                m = np.ones((y1 - y0, x1 - x0), bool)
            g = np.uint8(min(255.0, 64.0 + refl[i] * 0.75))
            reg = img[y0:y1, x0:x1]
            reg[m] = (g // 3, g, g // 4, 255)
            zbuf[y0:y1, x0:x1][m] = z[i]
        from ..utils.dims import NDA
        blk.nda = NDA.from_array(img, ("y", "x", "c"))
        return blk


# -- pcap (packet capture) src/sink ------------------------------------------------------
# format per the libpcap file layout (ref src/data-stream-pcap.cc:45-107:
# pcap_hdr_t/pcaprec_hdr_t; UDP-payload extraction :140-163)

_PCAP_MAGIC = 0xA1B2C3D4


def _ip_cksum(data: bytes) -> int:
    """16-bit ones-complement checksum (ref in_cksum, data-stream-pcap.cc:15)."""
    if len(data) % 2:
        data += b"\0"
    s = sum(struct.unpack(f"!{len(data) // 2}H", data))
    s = (s >> 16) + (s & 0xFFFF)
    s += s >> 16
    return (~s) & 0xFFFF


@register("data_stream", "pcap-src",
          help="pcap file packets (optionally extract UDP payloads)")
class PcapSrc(DataStream):
    fn = Field("filename", req=True, help="input .pcap file")
    extract_udp_payload = Field(bool, default="1",
                                help="assume eth+ipv4+udp; emit udp payloads")
    udp_dest_port = Field(int, default="0",
                          help="if nonzero, keep only this udp dest port")

    def start(self) -> None:
        self._f = open(self.fn, "rb")
        hdr = self._f.read(24)
        if len(hdr) < 24:
            raise ConfigError(f"pcap-src: {self.fn!r}: truncated pcap header")
        magic = struct.unpack("<I", hdr[:4])[0]
        if magic == _PCAP_MAGIC:
            self._endian = "<"
        elif magic == struct.unpack(">I", struct.pack("<I", _PCAP_MAGIC))[0]:
            self._endian = ">"
        else:
            raise ConfigError(f"pcap-src: {self.fn!r}: bad magic {magic:#x}")
        self._ix = 0

    def read(self):
        while True:
            rh = self._f.read(16)
            if len(rh) < 16:
                return None
            ts_sec, ts_usec, incl_len, _orig = struct.unpack(
                self._endian + "IIII", rh)
            pkt = self._f.read(incl_len)
            if len(pkt) < incl_len:
                return None
            ts = (ts_sec * 1000_000 + ts_usec) * 1000
            if not self.extract_udp_payload:
                payload = pkt
            else:
                payload = self._udp_payload(pkt)
                if payload is None:
                    continue
            b = DataBlock(ts=ts, tag="pkt", data=payload, frame_ix=self._ix)
            self._ix += 1
            return b

    def _udp_payload(self, pkt: bytes) -> Optional[bytes]:
        if len(pkt) < 14 + 20 + 8:
            raise ConfigError("pcap-src: packet too short for eth+ipv4+udp")
        ethertype = struct.unpack("!H", pkt[12:14])[0]
        if ethertype != 0x0800:
            raise ConfigError(f"pcap-src: expected IPv4 ethertype, "
                              f"got {ethertype:#x}")
        ihl = (pkt[14] & 0x0F) * 4
        if pkt[14] >> 4 != 4 or ihl < 20:
            raise ConfigError("pcap-src: bad IPv4 header")
        udp_off = 14 + ihl
        dport, ulen = struct.unpack("!HH", pkt[udp_off + 2:udp_off + 6])
        if self.udp_dest_port and dport != self.udp_dest_port:
            return None
        return pkt[udp_off + 8:udp_off + ulen]


@register("data_stream", "pcap-sink",
          help="write blocks as UDP packets in a pcap file")
class PcapSink(DataStream):
    fn = Field("filename", req=True, help="output .pcap file")
    udp_dest_port = Field(int, default="2368", help="udp dest port to stamp")

    def start(self) -> None:
        self._f = open(_out_path(self.fn), "wb")
        self._f.write(struct.pack("<IHHiIII", _PCAP_MAGIC, 2, 4, 0, 0,
                                  65535, 1))
        self._n = 0

    def proc(self, blk):
        payload = blk.data if blk.data is not None else \
            (blk.nda.data.tobytes() if blk.nda is not None else b"")
        udp = struct.pack("!HHHH", 2368, self.udp_dest_port,
                          8 + len(payload), 0) + payload
        ip_hdr = struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(udp),
                             self._n & 0xFFFF, 0, 64, 17, 0,
                             bytes([10, 0, 0, 1]), bytes([10, 0, 0, 2]))
        ip_hdr = ip_hdr[:10] + struct.pack("!H", _ip_cksum(ip_hdr)) + ip_hdr[12:]
        eth = bytes(12) + struct.pack("!H", 0x0800)
        pkt = eth + ip_hdr + udp
        ts_ns = blk.ts
        self._f.write(struct.pack("<IIII", ts_ns // 1_000_000_000,
                                  (ts_ns % 1_000_000_000) // 1000,
                                  len(pkt), len(pkt)))
        self._f.write(pkt)
        self._n += 1
        return None

    def finish(self) -> None:
        self._f.close()


# -- mxnet brick (RecordIO) src/sink ------------------------------------------------------
# record framing per ref src/data-stream-mxnet.cc:16-23: [magic u32][lrec u32 =
# cflag<<29 | len][len bytes][pad to 4]; cflag 0=whole, 1=start, 2=mid, 3=end.

_MXNET_MAGIC = 0xCED7230A
_MXNET_MAX_REC = 1 << 29


@register("data_stream", "mxnet-brick-src",
          help="mxnet-brick (RecordIO) records as blocks")
class MxnetBrickSrc(DataStream):
    fn = Field("filename", req=True, help="input brick file")

    def start(self) -> None:
        self._f = open(self.fn, "rb")
        self._ix = 0

    def read(self):
        parts = []
        while True:
            hdr = self._f.read(8)
            if not hdr:
                if parts:
                    raise ConfigError("mxnet-brick-src: eof mid-record")
                return None
            if len(hdr) < 8:
                raise ConfigError("mxnet-brick-src: truncated record header")
            magic, lrec = struct.unpack("<II", hdr)
            if magic != _MXNET_MAGIC:
                raise ConfigError(f"mxnet-brick-src: expected magic "
                                  f"{_MXNET_MAGIC:#x}, got {magic:#x}")
            cflag, ln = lrec >> 29, lrec & (_MXNET_MAX_REC - 1)
            data = self._f.read(ln)
            if len(data) < ln:
                raise ConfigError("mxnet-brick-src: truncated record body")
            self._f.read((-ln) % 4)  # pad to 4
            if cflag in (0, 1):
                if parts:
                    raise ConfigError(f"mxnet-brick-src: cflag={cflag} "
                                      "inside a split record")
                parts.append(data)
                if cflag == 0:
                    break
            elif cflag in (2, 3):
                if not parts:
                    raise ConfigError(f"mxnet-brick-src: cflag={cflag} "
                                      "at record start")
                parts.append(data)
                if cflag == 3:
                    break
        b = DataBlock(ts=self._ix, tag="rec", data=b"".join(parts),
                      frame_ix=self._ix)
        self._ix += 1
        return b


@register("data_stream", "mxnet-brick-sink",
          help="write blocks as mxnet-brick (RecordIO) records")
class MxnetBrickSink(DataStream):
    fn = Field("filename", req=True, help="output brick file")
    split_at = Field(int, default="0",
                     help="if nonzero, split records into chunks of this size")

    def start(self) -> None:
        self._f = open(_out_path(self.fn), "wb")

    def _emit(self, cflag: int, data: bytes) -> None:
        assert len(data) < _MXNET_MAX_REC
        self._f.write(struct.pack("<II", _MXNET_MAGIC,
                                  (cflag << 29) | len(data)))
        self._f.write(data)
        self._f.write(b"\0" * ((-len(data)) % 4))

    def proc(self, blk):
        data = blk.data if blk.data is not None else \
            (blk.nda.data.tobytes() if blk.nda is not None else b"")
        sz = self.split_at or max(len(data), 1)
        chunks = [data[i:i + sz] for i in range(0, len(data), sz)] or [b""]
        if len(chunks) == 1:
            self._emit(0, chunks[0])
        else:
            for i, c in enumerate(chunks):
                self._emit(1 if i == 0 else (3 if i == len(chunks) - 1 else 2), c)
        return None

    def finish(self) -> None:
        self._f.close()


# -- gated format-specific streams ------------------------------------------------------

for _fmt in ("ffmpeg",):
    def _make(fmt):
        @register("data_stream", f"{fmt}-src",
                  help=f"{fmt} source (not available in this build)")
        class _Gated(DataStream):  # noqa
            fn = Field("filename", default="", help="input file")

            def start(self):
                raise ConfigError(
                    f"data stream format {fmt!r} is not available in this "
                    f"build (reference gates it behind a build feature too); "
                    f"MJPEG .avi files need no codec — use avi-mjpeg-src")
        return _Gated
    _make(_fmt)


@register("data_stream", "avi-mjpeg-src",
          help="MJPEG-in-AVI video source (pure-python demux + jpeg decode)")
class AviMjpegSrc(DataStream):
    """Codec-free video ingestion (see stream/avi.py): each AVI movi chunk
    is a complete JPEG, decoded by the same path as image files. General
    codecs remain ffmpeg-gated (ref src/data-stream-ffmpeg.cc)."""
    fn = Field("filename", req=True, help=".avi file (MJPG fourcc)")
    stream_ix = Field(int, default="0", help="AVI stream index to read")

    def start(self) -> None:
        from .avi import read_avi_mjpeg
        self._frames = iter(read_avi_mjpeg(self.fn))

    def read(self):
        from ..utils.img_io import Img
        for fr in self._frames:
            if fr.stream_ix != self.stream_ix:
                continue
            img = Img.from_bytes(fr.jpeg, what=f"mjpeg frame {fr.frame_ix}")
            return DataBlock(ts=fr.ts_us, tag=f"frame_{fr.frame_ix}",
                             frame_ix=fr.frame_ix,
                             nda=NDA.from_array(img.data, ("y", "x", "c")))
        return None


@register("data_stream", "rosbag-src",
          help="rosbag v2.0 topic source (sensor_msgs Image / PointCloud2)")
class RosbagSrc(DataStream):
    """Pure-python rosbag reader (ref src/data-stream-rosbag.cc's source
    role): emits one block per message on the selected topic — Image
    messages as (y,x,chan) uint8 ndas, PointCloud2 as (pt,attr) float32
    point blocks; other message types pass through as raw bytes. Multi-topic
    primary sync = compose with ts-merge, like any other source pair."""
    fn = Field("filename", req=True, help=".bag file")
    topic = Field(str, default="", help="topic to read ('' = first seen)")

    def start(self) -> None:
        from .rosbag import read_bag
        self._msgs = iter(read_bag(self.fn))
        self._topic = self.topic

    def read(self):
        from ..utils.dims import NDA
        from .rosbag import parse_image, parse_pointcloud2
        for m in self._msgs:
            if not self._topic:
                self._topic = m.conn.topic
            if m.conn.topic != self._topic:
                continue
            blk = DataBlock(ts=m.ts, tag=m.conn.topic)
            if m.conn.dtype == "sensor_msgs/Image":
                blk.nda = NDA.from_array(parse_image(m.raw), ("y", "x", "c"))
            elif m.conn.dtype == "sensor_msgs/PointCloud2":
                blk.nda = NDA.from_array(parse_pointcloud2(m.raw),
                                         ("pt", "attr"))
            else:
                blk.data = m.raw
            return blk
        return None


# -- remaining reference stream formats / checks ----------------------------------

@register("data_stream", "dumpvideo-src",
          help="length-prefixed camera dumpvideo stream (u32-size frames)")
class DumpvideoSrc(DataStream):
    """ref data_stream_dumpvideo_t (data-stream.cc:242): [u32 size][payload]
    repeated; a u32 0xFFFFFFFF marks end-of-stream. Payloads are camera
    frames (typically jpeg) left as raw bytes, tag 'camera-dumpvideo'."""
    fn = Field("filename", req=True, help="dumpvideo file")

    def start(self) -> None:
        self._f = open(self.fn, "rb")
        self._ix = 0

    def read(self):
        hdr = self._f.read(4)
        if len(hdr) < 4:
            return None
        (sz,) = struct.unpack("<I", hdr)
        if sz == 0xFFFFFFFF:  # explicit end marker
            return None
        payload = self._f.read(sz)
        if len(payload) < sz:
            raise ConfigError(f"dumpvideo stream: frame header says {sz} "
                              f"bytes but only {len(payload)} remain")
        b = DataBlock(ts=self._ix, tag="camera-dumpvideo",
                      data=payload, frame_ix=self._ix)
        self._ix += 1
        return b


@register("data_stream", "qt-src",
          help="qt-style serialized stream ([u64 ts_ns][u32 size][payload])")
class QtSrc(DataStream):
    """ref data_stream_qt_t (data-stream.cc:168): fixed framing of
    [u64 timestamp_ns][u32 payload size][payload]."""
    fn = Field("filename", req=True, help="qt stream file")

    def start(self) -> None:
        self._f = open(self.fn, "rb")
        self._ix = 0

    def read(self):
        hdr = self._f.read(12)
        if len(hdr) < 12:
            return None
        ts, sz = struct.unpack("<QI", hdr)
        payload = self._f.read(sz)
        if len(payload) < sz:
            raise ConfigError("qt stream: read timestamp, but not enough "
                              "data left to read payload")
        b = DataBlock(ts=ts, tag="qt", data=payload, frame_ix=self._ix)
        self._ix += 1
        return b


@register("data_stream", "text-sink", help="blocks as hex text, one per line")
class TextSink(DataStream):
    """ref data_sink_text_t (data-stream.cc:313): hex of each block's raw
    bytes, one line per block, no header."""
    fn = Field("filename", req=True, help="output text file")

    def start(self) -> None:
        self._f = open(_out_path(self.fn), "w")

    def proc(self, blk):
        raw = blk.data if blk.data is not None else (
            np.ascontiguousarray(blk.nda.data).tobytes()
            if blk.nda is not None else None)
        if raw is None:
            raise ConfigError("text-sink: expected data block to have data")
        self._f.write(raw.hex().upper() + "\n")
        return None

    def finish(self) -> None:
        self._f.close()


def _block_hash64(raw: bytes) -> int:
    import hashlib
    return int.from_bytes(hashlib.blake2b(raw, digest_size=8).digest(),
                          "little")


@register("data_stream", "hash-pair",
          help="emit each block followed by its 8-byte hash block")
class HashPair(DataStream):
    """Producer side of the hash-check pairing (the reference's pairs come
    from its mxnet dump tooling, data-stream-mxnet.cc): after every payload
    block, emit an 8-byte little-endian hash-of-payload block."""
    src = Field("data_stream", req=True, help="upstream source")

    def start(self) -> None:
        self.src.start()
        self._pend = None

    def read(self):
        if self._pend is not None:
            h, self._pend = self._pend, None
            return h
        b = self.src.read()
        if b is None:
            return None
        raw = b.data if b.data is not None else \
            np.ascontiguousarray(b.nda.data).tobytes()
        self._pend = DataBlock(ts=b.ts, tag="hash",
                               data=struct.pack("<Q", _block_hash64(raw)))
        return b


@register("data_stream", "hash-check",
          help="verify alternating block / hash-block pairs")
class HashCheck(DataStream):
    """ref data_sink_hash_check_t (data-stream-mxnet.cc:220): stream must be
    (payload, hash) pairs; raises on mismatch, odd pairing, or bad sizes."""

    def start(self) -> None:
        self.tot_num_read = 0
        self._hash = None

    def proc(self, blk):
        raw = blk.data if blk.data is not None else \
            np.ascontiguousarray(blk.nda.data).tobytes()
        if not (self.tot_num_read & 1):
            self._hash = _block_hash64(raw)
        else:
            if len(raw) != 8:
                raise ConfigError(
                    f"expected hash-only block at tot_num_read="
                    f"{self.tot_num_read}, but block size was {len(raw)}")
            (fs_hash,) = struct.unpack("<Q", raw)
            if fs_hash != self._hash:
                raise ConfigError(
                    f"block hash compare failure: fs_block_hash={fs_hash} "
                    f"block_hash={self._hash}")
        self.tot_num_read += 1
        return blk

    def finish(self) -> None:
        if self.tot_num_read & 1:
            raise ConfigError("hash-check: odd number of blocks "
                              "(final payload lost its hash block)")


@register("data_stream", "img-add-text",
          help="draw text onto image blocks (in place)")
class ImgAddText(DataStream):
    """ref data_stream_img_add_text_t (data-stream-img-util.cc:12); PIL's
    default bitmap font plays the ttf font-renderer role."""
    text_x = Field(int, default="0", help="text x position")
    text_y = Field(int, default="0", help="text y position")
    text_str = Field(str, default="", help="text to draw")
    prefix_with_tag = Field(bool, default="0", help="prefix text with block tag")

    def proc(self, blk):
        if blk.nda is None or blk.nda.data.ndim != 3:
            raise ConfigError("img-add-text: expected an image block")
        from PIL import Image, ImageDraw
        txt = (blk.tag if self.prefix_with_tag else "") + self.text_str
        arr = np.ascontiguousarray(blk.nda.data)
        if arr.shape[2] >= 3:
            im = Image.fromarray(arr[..., :3])
            ImageDraw.Draw(im).text((self.text_x, self.text_y), txt,
                                    fill=(255, 255, 0))
            out = np.asarray(im)
            if arr.shape[2] == 4:
                out = np.concatenate([out, arr[..., 3:]], axis=2)
        else:  # grayscale: scalar fill, rank preserved
            im = Image.fromarray(arr[..., 0])
            ImageDraw.Draw(im).text((self.text_x, self.text_y), txt, fill=255)
            out = np.asarray(im)[..., None]
        blk.nda = NDA(blk.nda.dims, np.ascontiguousarray(out))
        return blk


@register("data_stream", "velodyne-gen",
          help="dense (laser,azi) distance ndas -> velodyne udp packets")
class VelodyneGen(DataStream):
    """ref data_stream_velodyne_gen_t (data-stream-velo.cc:706): the inverse
    of velo-src — converts dense point-cloud blocks (nda [32 lasers, n_azi]
    of distances in meters, optional 'refl' sub-block) into standard
    12-firing-block 1206-byte packet payloads. Azimuth advances azi_step
    degrees per firing block from fov_center - span/2; per-packet gps
    timestamps step by timestamp_step microseconds."""
    src = Field("data_stream", req=True, help="upstream dense-cloud source")
    azi_step = Field(float, default="0.165", help="degrees per firing block")
    fov_center = Field(float, default="0.0", help="FoV center in degrees")
    timestamp_step = Field(int, default="553", help="per-packet ts step (us)")
    timestamp_start = Field(int, default="0", help="first packet ts (us)")

    def start(self) -> None:
        if not (0.0 <= self.fov_center < 360.0):
            raise ConfigError(f"fov_center must be in [0.0,360.0) but was "
                              f"{self.fov_center}")
        self.src.start()
        self._pkts: list[bytes] = []
        self._ts = self.timestamp_start
        self._ix = 0

    def _gen_packets(self, blk: DataBlock) -> None:
        from .velodyne import _BLOCKS, encode_packet
        d = blk.nda.data
        if d.ndim != 2 or d.shape[0] != 32:
            raise ConfigError("velodyne-gen: expected a (32, n_azi) dense "
                              f"distance nda, got {d.shape}")
        if float(d.min()) < 0 or float(d.max()) > 0xFFFF * 0.002:
            raise ConfigError(
                "velodyne-gen: distances must be in [0, 131.07] m (u16 "
                f"2mm ticks), got [{float(d.min()):g}, {float(d.max()):g}]")
        refl = blk.subs["refl"].nda.data if "refl" in blk.subs else \
            np.zeros_like(d, np.uint8)
        n_azi = d.shape[1]
        span = n_azi * self.azi_step
        azi0 = (self.fov_center - span / 2.0) % 360.0
        for p0 in range(0, n_azi, _BLOCKS):
            cols = min(_BLOCKS, n_azi - p0)
            az = np.array([(azi0 + (p0 + i) * self.azi_step) % 360.0
                           for i in range(_BLOCKS)], np.float32)
            dist = np.zeros((_BLOCKS, 32), np.float32)
            rf = np.zeros((_BLOCKS, 32), np.uint8)
            dist[:cols] = d[:, p0:p0 + cols].T
            rf[:cols] = refl[:, p0:p0 + cols].T
            self._pkts.append(encode_packet(az, dist, rf, ts_usec=self._ts))
            self._ts += self.timestamp_step

    def read(self):
        while not self._pkts:
            b = self.src.read()
            if b is None:
                return None
            if b.nda is None:
                raise ConfigError("velodyne-gen: input block has no nda")
            self._gen_packets(b)
        pkt = self._pkts.pop(0)
        out = DataBlock(ts=self._ix, tag="velodyne", data=pkt,
                        frame_ix=self._ix)
        self._ix += 1
        return out


@register("data_stream", "velo-cloud-gen",
          help="deterministic dense (32,n_azi) distance clouds (for tests)")
class VeloCloudGen(DataStream):
    n = Field(int, default="1", help="number of cloud blocks")
    n_azi = Field(int, default="24", help="azimuth steps per cloud")

    def start(self) -> None:
        self._ix = 0

    def read(self):
        if self._ix >= self.n:
            return None
        lz = np.arange(32, dtype=np.float32)[:, None]
        az = np.arange(self.n_azi, dtype=np.float32)[None, :]
        dense = 1.0 + 0.25 * lz + 0.125 * az + self._ix  # meters, all distinct
        b = DataBlock(ts=self._ix, tag="cloud",
                      nda=NDA.from_array(dense, ("laser", "azi")),
                      frame_ix=self._ix)
        self._ix += 1
        return b


@register("data_stream", "rosbag-sink",
          help="write image / point blocks to a rosbag v2.0 file")
class RosbagSink(DataStream):
    """Write side of stream/rosbag.py (ref data-stream-rosbag.cc): image
    blocks ((y,x,3|4) uint8 ndas) become sensor_msgs/Image, (pt,attr)
    float32 point blocks become sensor_msgs/PointCloud2, raw-bytes blocks
    pass through verbatim under raw_dtype. Round-trips with rosbag-src."""
    fn = Field("filename", req=True, help="output .bag file")
    # a ROS topic carries ONE message type: blocks are routed to per-kind
    # topics under this prefix (<prefix>/image, /points, /raw)
    topic = Field(str, default="/boda", help="topic prefix")
    compression = Field(str, default="none", help="chunk compression: none | bz2")
    raw_dtype = Field(str, default="boda_tpu/bytes",
                      help="message type recorded for raw-bytes blocks")

    def start(self) -> None:
        self._msgs: list[tuple] = []

    def proc(self, blk):
        from .rosbag import ser_image, ser_pointcloud2
        d = blk.nda.data if blk.nda is not None else None
        if d is not None and d.ndim == 3 and d.dtype == np.uint8 \
                and d.shape[2] in (3, 4):
            raw = ser_image(d[..., :3], ts=blk.ts)
            dtype, sub = "sensor_msgs/Image", "image"
        elif d is not None and d.ndim == 2 and d.dtype == np.float32:
            raw = ser_pointcloud2(d, ts=blk.ts)
            dtype, sub = "sensor_msgs/PointCloud2", "points"
        elif blk.data is not None:
            raw, dtype, sub = blk.data, self.raw_dtype, "raw"
        else:
            raise ConfigError("rosbag-sink: block has neither a writable "
                              "nda (u8 image / f32 points) nor raw bytes")
        self._msgs.append((f"{self.topic}/{sub}", dtype, blk.ts, raw))
        return None

    def finish(self) -> None:
        from .rosbag import write_bag
        write_bag(_out_path(self.fn), self._msgs,
                  compression=self.compression)


@register("data_stream", "velo-rev",
          help="merge velodyne packet blocks into per-revolution point blocks")
class VeloRev(DataStream):
    """ref data_stream_velodyne_t (data-stream-velo.cc:103, type_id
    'velodyne'): accumulate raw packets and emit ONE merged (N,4) point
    block per full revolution — frames split where the azimuth crosses
    fov_center + 180 degrees. Upstream is any source of raw 1206-byte
    packet blocks (velo-src file framing, velodyne-gen, pcap payloads)."""
    src = Field("data_stream", req=True, help="upstream raw-packet source")
    fov_center = Field(float, default="0.0", help="FoV center in degrees")

    def start(self) -> None:
        self.src.start()
        self._pts: list[np.ndarray] = []
        self._last_rel = None
        self._rev_ix = 0
        self._ts0 = None
        self._done = False

    def _split_rel(self, az_deg: float) -> float:
        return (az_deg - (self.fov_center + 180.0)) % 360.0

    def _emit(self):
        pts = np.concatenate(self._pts, axis=0) if self._pts else \
            np.zeros((0, 4), np.float32)
        b = DataBlock(ts=self._ts0 or 0, tag=f"rev_{self._rev_ix}",
                      nda=NDA.from_array(pts, ("pt", "attr")),
                      frame_ix=self._rev_ix)
        self._pts, self._ts0 = [], None
        self._rev_ix += 1
        self._last_rel = None
        return b

    def read(self):
        from .velodyne import decode_packet, packet_to_points_vlp16
        while not self._done:
            blk = self.src.read()
            if blk is None:
                self._done = True
                break
            if blk.data is None:
                raise ConfigError("velo-rev: expected raw packet blocks")
            az, _dist, _refl, ts_us = decode_packet(blk.data)
            if self._ts0 is None:
                self._ts0 = int(ts_us) * 1000
            # revolution boundary: azimuth (relative to the split angle)
            # wraps downward between consecutive firing blocks
            out = None
            rel = [self._split_rel(float(a)) for a in az]
            boundary = self._last_rel is not None and \
                rel[0] < self._last_rel
            boundary = boundary or any(rel[i + 1] < rel[i]
                                       for i in range(len(rel) - 1))
            if boundary and self._pts:
                out = self._emit()
                self._ts0 = int(ts_us) * 1000
            self._pts.append(packet_to_points_vlp16(blk.data))
            self._last_rel = rel[-1]
            if out is not None:
                return out
        if self._pts:  # final partial revolution
            return self._emit()
        return None
