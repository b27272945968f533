"""net_calib: offline activation-range calibration for static int8.

Counterpart of ``boda_tpu/modes/calib.py``. Runs the net in its float
configuration over N batches on the port's engine with ``per_layer_stats``
(the per-node min/max/sum/sum_sq the engine computes on the card), keeps
each node's |activation| maximum, and writes node -> amax as a sidecar
(prof/calib.py). An engine given it as ``calib_fn`` quantizes its int8
conv/fc inputs with the static per-tensor scale. The batches are synthetic
(the gen_data pattern and seeded Gaussians, alternately) or, with
``--lmdb-fn``, the records of a block-stream file or an LMDB, resized to the
net's input where they differ.
"""

from __future__ import annotations

import numpy as np

from .. import graph  # noqa: F401  (registers the "conv_fwd" engines)
from ..config import ConfigError, Field, Mode, make, register
from ..utils.dims import NDA
from .cnet import load_net


@register("mode", "net_calib", help="calibrate per-node act ranges for static int8")
class NetCalib(Mode):
    model = Field(str, default="", help="zoo model name")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    weights_fn = Field(str, default="", help="caffemodel weights (':'-sep fallbacks)")
    img = Field(int, default="8", help="batch size per calibration batch")
    in_sz = Field(int, default="0", help="input size override")
    batches = Field(int, default="8", help="number of calibration batches")
    out_node = Field(str, default="prob", help="net output node to pull")
    out_fn = Field("filename", default="calib.json", help="output sidecar file")
    compute_tn = Field(str, default="bfloat16",
                       help="calibration compute dtype ('' = f32)")
    lmdb_fn = Field(str, default="", help="optional LMDB dir or block-stream "
                                          "record file: calibrate on real data")
    seed = Field(int, default="42", help="seed for synthetic calibration batches")
    device = Field(str, default="cuda", help="the engine's device: cuda | cpu")

    def main(self) -> None:
        from ..prof.calib import write_calib
        pipe, in_dims = load_net(self.model, self.ptt_fn, self.weights_fn,
                                 self.img, self.in_sz)
        eng = make("conv_fwd", "cuda", compute_tn=self.compute_tn,
                   precision="default" if self.compute_tn == "bfloat16"
                   else "highest", per_layer_stats=True, device=self.device)
        eng.init(pipe)
        d = in_dims["data"]
        amax: dict[str, float] = {}
        rng = np.random.RandomState(self.seed)
        n_done = 0
        for x in self._batches(d, rng):
            eng.run_fwd({"data": NDA(d, x)}, [self.out_node])
            # var-stats cover op outputs; the input node (quantized by the
            # first conv) is observed directly from the batch
            amax["data"] = max(amax.get("data", 0.0), float(np.abs(x).max()))
            for n, s in eng._last_stats.items():
                a = max(abs(float(s[0])), abs(float(s[1])))
                amax[n] = max(amax.get(n, 0.0), a)
            n_done += 1
            if n_done >= self.batches:
                break
        if n_done == 0:
            raise ConfigError("no calibration batches produced")
        write_calib(self.out_path(self.out_fn), pipe.name, amax,
                    batches=n_done, compute_tn=self.compute_tn)
        qn = [n for n in sorted(amax) if not n.endswith("__grad")]
        print(f"net_calib {pipe.name}: {n_done} batches x {self.img} imgs, "
              f"{len(qn)} nodes -> {self.out_fn}")
        for n in qn[:12]:
            print(f"  {n}: amax={amax[n]:.5g}")
        if len(qn) > 12:
            print(f"  ... {len(qn) - 12} more")

    def _batches(self, d, rng):
        if self.lmdb_fn:
            import os

            from ..apps.preproc import img_to_batch_np
            from ..frontend.datum import (parse_datum, read_lmdb_records,
                                          read_rec_records)
            from ..utils.img_io import Img
            reader = read_lmdb_records if os.path.isdir(self.lmdb_fn) \
                else read_rec_records
            batch = []
            for _k, val in reader(self.lmdb_fn):
                rgb = parse_datum(val).to_rgb()
                if rgb.shape[:2] != (d.shape[2], d.shape[3]):
                    rgb = Img.from_rgb(rgb).resize(d.shape[2], d.shape[3]).rgb()
                batch.append(rgb)
                if len(batch) == d.shape[0]:
                    yield img_to_batch_np(np.stack(batch)).astype(np.float32)
                    batch = []
            return
        # synthetic: gen_data-style structured patterns + gaussian mixtures,
        # varied per batch (a fixed pattern would under-observe the range)
        from ..ops.kernels.gen_data import gen_data_pattern
        for i in range(self.batches):
            if i % 2 == 0:
                yield gen_data_pattern(d.shape, d.tn, offset=i * 3,
                                       stride=7 + i).float().numpy()
            else:
                yield (rng.randn(*d.shape) * (0.5 + 0.25 * i)).astype(np.float32)
