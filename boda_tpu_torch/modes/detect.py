"""Detection-net inference: run a net with a DetectionOutput head, write
its scored boxes, and optionally score them against ground truth.

Counterpart of ``boda_tpu/modes/detect.py`` (``cnet_detect``), with the same
text format and the same batch-0-only filter; the forward engine defaults
to the card (``--conv-fwd=(mode=cuda)``), where the whole forward, the NMS
head included, replays as one captured CUDA graph. On the CPU, pass
``--conv-fwd=(mode=cuda,device=cpu)`` (the kernels' plain versions).
"""

from __future__ import annotations

import numpy as np

from .. import graph  # noqa: F401  (registers the "conv_fwd" engines)
from ..config import ConfigError, Field, register
from ..utils.dims import NDA
from .cnet import _NetMode, load_net


@register("mode", "cnet_detect",
          help="run a detection net; write (and optionally score) detections")
class CnetDetect(_NetMode):
    img_fn = Field("filename", default="", help="input image (resized to net input)")
    img_id = Field(str, default="", help="image id for det lines (default: img stem)")
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="forward engine")
    out_node_name = Field(str, default="",
                          help="detection node (default: first DetectionOutput top)")
    conf_thresh = Field(float, default="0.1", help="min score to emit")
    cls_names = Field(str, default="",
                      help="':'-separated class names (default cls<label>)")
    dets_fn = Field(str, default="dets.txt", help="output detections file")
    gt_fn = Field("filename", default="", help="if set, score vs this gt file")
    iou = Field(float, default="0.5", help="IoU threshold for scoring")

    def main(self) -> None:
        from ..apps.preproc import img_to_batch_np
        from ..utils.img_io import Img
        pipe, in_dims = load_net(self.model, self.ptt_fn, self.weights_fn,
                                 self.img, self.in_sz)
        out_node = self.out_node_name
        if not out_node:
            det_ops = [op for op in pipe.ops.values() if op.type == "DetectionOutput"]
            if not det_ops:
                raise ConfigError("net has no DetectionOutput op; use --out-node-name=")
            out_node = det_ops[-1].tops[0]
        d = in_dims["data"]
        ih, iw = d["y"], d["x"]
        if self.img_fn:
            img = Img.load(self.img_fn).resize(ih, iw)
            x = img_to_batch_np(np.repeat(img.data[None], d["img"], axis=0))
            img_sz = img.sz  # boxes are emitted in net-input pixel coords
            img_id = self.img_id or self.img_fn.rsplit("/", 1)[-1].split(".")[0]
        else:  # the deterministic pattern input (analysis and golden runs)
            from ..ops.kernels.gen_data import gen_data_pattern
            x = gen_data_pattern(d.shape, d.tn).float().numpy()
            img_sz = (ih, iw)
            img_id = self.img_id or "gen"
        self.conv_fwd.init(pipe)
        outs = self.conv_fwd.run_fwd({"data": NDA(d, x.astype(np.float32))}, [out_node])
        dets = np.asarray(outs[out_node].data, np.float32).reshape(-1, 7)
        names = [s for s in self.cls_names.split(":") if s]
        lines = []
        for rec in dets:
            img_i, lab, score, x0, y0, x1, y1 = (float(v) for v in rec)
            # the one input image is repeated across the batch: keep batch
            # index 0 only, or every detection comes img times (and the
            # duplicates count as false positives in the scoring)
            if img_i != 0 or lab < 0 or score < self.conf_thresh:
                continue
            lab = int(lab)
            cls = names[lab] if lab < len(names) else f"cls{lab}"
            lines.append(f"{img_id} {cls} {score:.4f} "
                         f"{x0 * img_sz[1]:.1f} {y0 * img_sz[0]:.1f} "
                         f"{x1 * img_sz[1]:.1f} {y1 * img_sz[0]:.1f}")
        fn = self.out_path(self.dets_fn)
        with open(fn, "w") as f:
            f.write("# img_id class score x0 y0 x1 y1\n")
            f.writelines(ln + "\n" for ln in lines)
        print(f"cnet_detect: {len(lines)} detections (node {out_node}, "
              f"conf>={self.conf_thresh}) -> {self.dets_fn}")
        if self.gt_fn:
            from ..apps.scoring import load_dets_file, load_gt_file, score_all
            results, mAP = score_all(load_dets_file(fn), load_gt_file(self.gt_fn), self.iou)
            for r in results:
                print(f"class {r.cls:<16} AP={r.ap:.4f} n_gt={r.n_gt} n_det={r.n_det}")
            print(f"mAP={mAP:.4f} over {len(results)} classes")
