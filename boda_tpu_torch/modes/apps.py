"""Application modes: detection scoring and PASCAL annotation loading.

Counterpart of the ``score``, ``score_files`` and ``load_pil`` modes of
``boda_tpu/modes/apps.py``, with their output and errors word for word; the
scorer is apps/scoring.py. The other modes of that module (``cnet_predict``,
the pyramid and dense modes) are not ported yet (ROADMAP §1 item 9).
"""

from __future__ import annotations

import os

from ..config import ConfigError, Field, Mode, register


@register("mode", "score", help="score detections vs ground truth (VOC PR/mAP)")
class Score(Mode):
    dets_fn = Field("filename", req=True, help="detections file")
    gt_fn = Field("filename", req=True, help="ground-truth file")
    iou = Field(float, default="0.5", help="IoU match threshold")
    use_07_metric = Field(bool, default="0", help="11-point VOC07 AP")
    prc_fn = Field(str, default="", help="write per-class PR points to file")

    def main(self) -> None:
        from ..apps.scoring import load_dets_file, load_gt_file, score_all
        dets = load_dets_file(self.dets_fn)
        gt = load_gt_file(self.gt_fn)
        results, mAP = score_all(dets, gt, self.iou, self.use_07_metric)
        for r in results:
            print(f"class {r.cls:<16} AP={r.ap:.4f} n_gt={r.n_gt} n_det={r.n_det}")
        print(f"mAP={mAP:.4f} over {len(results)} classes")
        if self.prc_fn:
            with open(self.out_path(self.prc_fn), "w") as f:
                for r in results:
                    for rec, prec in zip(r.recall, r.precision):
                        f.write(f"{r.cls} {rec:.6f} {prec:.6f}\n")


@register("mode", "score_files",
          help="score per-class VOC-format results files; write a summary")
class ScoreFiles(Mode):
    """ref score_results_files_t (results_io.cc:470): per-class DPM-style
    results files — ``img_id score x0 y0 x1 y1`` per line, one file per
    class via a %s filename template — scored against a gt file, with an
    all-classes summary written to summary_fn."""
    res_fn = Field(str, req=True,
                   help="results filename template; %s -> class name")
    classes = Field((list, str), req=True, help="class names to score")
    gt_fn = Field("filename", req=True, help="ground-truth file")
    iou = Field(float, default="0.5", help="IoU match threshold")
    use_07_metric = Field(bool, default="0", help="11-point VOC07 AP")
    summary_fn = Field(str, default="summary.txt",
                       help="output: all-classes text summary")

    def main(self) -> None:
        from ..apps.scoring import Box, Det, load_gt_file, score_all
        dets = {}
        for cls in self.classes:
            fn = self.res_fn.replace("%s", cls)
            cds = []
            with open(fn) as f:
                for ln, line in enumerate(f, 1):
                    parts = line.split()
                    if not parts or parts[0].startswith("#"):
                        continue
                    if len(parts) != 6:
                        raise ConfigError(
                            f"{fn}:{ln}: want 6 fields "
                            "(img_id score x0 y0 x1 y1), got "
                            f"{len(parts)}")
                    img_id, score = parts[0], float(parts[1])
                    cds.append(Det(img_id, score,
                                   Box(*(float(v) for v in parts[2:6]))))
            dets[cls] = cds
        # score exactly the requested classes: gt classes outside the set
        # must not add AP=0 rows, and requested classes with no gt still
        # get a row (AP=0 unless they truly have no dets either)
        gt = load_gt_file(self.gt_fn)
        gt = {c: gt.get(c, {}) for c in self.classes}
        results, mAP = score_all(dets, gt, self.iou, self.use_07_metric)
        lines = [f"class {r.cls:<16} AP={r.ap:.4f} n_gt={r.n_gt} "
                 f"n_det={r.n_det}" for r in results]
        lines.append(f"mAP={mAP:.4f} over {len(results)} classes")
        txt = "\n".join(lines) + "\n"
        print(txt, end="")
        with open(self.out_path(self.summary_fn), "w") as f:
            f.write(txt)


@register("mode", "load_pil", help="load a PASCAL image list + annotations; dump stats")
class LoadPil(Mode):
    ann_dir = Field("filename", req=True, help="dir of VOC annotation XMLs")
    img_list_fn = Field("filename", req=True, help="image-id list, one per line")

    def main(self) -> None:
        from ..apps.scoring import load_pascal_annotation
        # typed PASCAL image-list: '<id>' or '<id> <1|-1|0>' per line, each id
        # at most once (ref results_io.cc read_pascal_image_list_file: parts
        # != 2 / bad type string / duplicate-annotation-load errors)
        base = os.path.basename(self.img_list_fn)
        ids: list[str] = []
        seen: set[str] = set()
        with open(self.img_list_fn) as f:
            for lno, ln in enumerate(f, 1):
                parts = ln.split()
                if not parts:
                    continue
                if len(parts) > 2:
                    raise ConfigError(
                        f"invalid line {lno} in image list file {base!r}: "
                        f"want 'id' or 'id <type>', got {len(parts)} fields "
                        f"in {ln.strip()!r}")
                if len(parts) == 2 and parts[1] not in ("1", "-1", "0"):
                    raise ConfigError(
                        f"invalid type string in image list file {base!r} "
                        f"line {lno}: saw {parts[1]!r}, expected '1', '-1', "
                        f"or '0'")
                if parts[0] in seen:
                    raise ConfigError(
                        f"duplicate image id {parts[0]!r} in image list file "
                        f"{base!r} line {lno}: annotations would load "
                        f"multiple times")
                seen.add(parts[0])
                ids.append(parts[0])
        n_obj = 0
        by_cls: dict[str, int] = {}
        for iid in ids:
            fn = os.path.join(self.ann_dir, f"{iid}.xml")
            if not os.path.exists(fn):
                raise ConfigError(
                    f"missing annotation {os.path.basename(fn)!r} for image "
                    f"id {iid!r} in annotation dir")
            ann = load_pascal_annotation(fn)
            for cls, boxes in ann.items():
                by_cls[cls] = by_cls.get(cls, 0) + len(boxes)
                n_obj += len(boxes)
        for cls in sorted(by_cls):
            print(f"{cls}: {by_cls[cls]}")
        print(f"load_pil: {len(ids)} images, {n_obj} objects, "
              f"{len(by_cls)} classes")
