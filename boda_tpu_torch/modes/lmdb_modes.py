"""Record modes: datum parsing and the classification accuracy loop.

Counterpart of ``boda_tpu/modes/lmdb_modes.py``: ``lmdb_parse_datums``
(ref lmdb_caffe_io.H:13), ``display_lmdb`` (its dump role: PNGs, not SDL
windows) and ``test_lmdb`` (ref src/lmdb_caffe_io.cc:37, top-1/top-5 over
labelled records). Records come from a block-stream file (``--rec-fn``,
testdata/lmdb) or a real LMDB (``--db-fn``, needs the ``lmdb`` module).
``test_lmdb`` runs the port's engine, on the card unless the engine is
given ``device=cpu``; its ``--ckpt-fn`` evaluates the weights of a
train_lmdb checkpoint (either package's).
"""

from __future__ import annotations

import numpy as np

from .. import graph  # noqa: F401  (registers the "conv_fwd" engines)
from ..config import ConfigError, Field, Mode, register
from ..utils.dims import NDA
from .cnet import load_net


def _iter_records(db_fn: str, rec_fn: str, max_records: int):
    from ..frontend.datum import read_lmdb_records, read_rec_records
    if db_fn and rec_fn:
        raise ConfigError("give either --db-fn (lmdb) or --rec-fn (block stream)")
    if db_fn:
        return read_lmdb_records(db_fn, max_records)
    if rec_fn:
        return read_rec_records(rec_fn, max_records)
    raise ConfigError("one of --db-fn or --rec-fn is required")


@register("mode", "lmdb_parse_datums", help="parse datum records; dump stats")
class LmdbParseDatums(Mode):
    db_fn = Field("filename", default="", help="lmdb directory (needs lmdb feature)")
    rec_fn = Field("filename", default="", help="block-stream record file")
    max_records = Field(int, default="0", help="record limit (0=all)")
    write_pngs = Field(int, default="0", help="write first N records as PNGs (needs PIL)")

    def main(self) -> None:
        from ..frontend.datum import parse_datum
        n = 0
        labels: dict[int, int] = {}
        for key, val in _iter_records(self.db_fn, self.rec_fn, self.max_records):
            d = parse_datum(val)
            labels[d.label] = labels.get(d.label, 0) + 1
            if n < self.write_pngs:
                from ..utils.img_io import Img
                Img.from_rgb(d.to_rgb()).save(self.out_path(f"rec_{n}.png"))
            if n == 0:
                print(f"first record: key={key.decode(errors='replace')} "
                      f"chan={d.chan} y={d.y} x={d.x} label={d.label}")
            n += 1
        print(f"lmdb_parse_datums: {n} records, {len(labels)} distinct labels")


@register("mode", "display_lmdb", help="dump datum records as PNGs (headless display)")
class DisplayLmdb(LmdbParseDatums):
    write_pngs = Field(int, default="16", help="write first N records as PNGs (needs PIL)")


@register("mode", "test_lmdb", help="classification accuracy benchmark over records")
class TestLmdb(Mode):
    db_fn = Field("filename", default="", help="lmdb directory (needs lmdb feature)")
    rec_fn = Field("filename", default="", help="block-stream record file")
    model = Field(str, default="", help="zoo model")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    weights_fn = Field("filename", default="", help="caffemodel weights")
    ckpt_fn = Field("filename", default="",
                    help="train_lmdb checkpoint to evaluate (overrides weights)")
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="engine")
    out_node_name = Field(str, default="prob", help="prob node")
    img = Field(int, default="4", help="batch size")
    max_records = Field(int, default="0", help="record limit")
    in_sz = Field(int, default="0", help="input size override")

    def main(self) -> None:
        from ..apps.preproc import img_to_batch_np
        from ..frontend.datum import parse_datum
        from ..utils.img_io import Img
        pipe, in_dims = load_net(self.model, self.ptt_fn, self.weights_fn,
                                 img=self.img, in_sz=self.in_sz)
        if self.ckpt_fn:  # train->eval loop: weights from a training checkpoint
            from ..parallel.checkpoint import load_checkpoint
            step, w_ck, _m = load_checkpoint(self.ckpt_fn)
            unknown = sorted(set(w_ck) - set(pipe.weights))
            if unknown:
                raise ConfigError(f"ckpt weights not in net: {unknown[:4]}")
            for k, v in w_ck.items():
                pipe.weights[k] = NDA(pipe.weights[k].dims, v.float().numpy())
            print(f"test_lmdb: weights from {self.ckpt_fn} (step {step})")
        self.conv_fwd.init(pipe)
        d = in_dims["data"]
        batch = np.zeros((self.img, d["y"], d["x"], 4), np.uint8)
        labels = np.zeros(self.img, np.int64)
        n = top1 = top5 = 0
        fill = 0

        def flush(fill_n: int):
            nonlocal top1, top5
            x = img_to_batch_np(batch).astype(np.float32)
            outs = self.conv_fwd.run_fwd({"data": NDA(d, x)},
                                         [self.out_node_name])
            prob = outs[self.out_node_name].data.reshape(self.img, -1)
            order = np.argsort(-prob, axis=1)
            for i in range(fill_n):
                if order[i, 0] == labels[i]:
                    top1 += 1
                if labels[i] in order[i, :5]:
                    top5 += 1

        for key, val in _iter_records(self.db_fn, self.rec_fn,
                                      self.max_records):
            dt = parse_datum(val)
            img = Img.from_rgb(dt.to_rgb()).resize(d["y"], d["x"])
            batch[fill] = img.data
            labels[fill] = dt.label
            fill += 1
            n += 1
            if fill == self.img:
                flush(fill)
                fill = 0
        if fill:
            flush(fill)
        if n == 0:
            raise ConfigError("no records found")
        print(f"test_lmdb: n={n} top1={top1 / n:.4f} top5={top5 / n:.4f} "
              f"net={pipe.name}")
