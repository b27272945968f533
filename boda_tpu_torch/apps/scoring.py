"""PASCAL-VOC-style detection scoring: PR curves and (m)AP.

Counterpart of ``boda_tpu/apps/scoring.py``, copied (pure Python and
numpy): annotation and detection-file loading, greedy IoU matching of scored
detections by descending score, precision and recall, AP (VOC07's 11-point
and the area under the monotone envelope), per-class and mean AP, as the
``score`` and ``load_pil`` modes and ``cnet_detect --gt-fn`` use them.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from collections import defaultdict
from dataclasses import dataclass

import numpy as np


@dataclass
class Box:
    x0: float
    y0: float
    x1: float
    y1: float

    def area(self) -> float:
        return max(0.0, self.x1 - self.x0) * max(0.0, self.y1 - self.y0)

    def iou(self, o: "Box") -> float:
        ix0, iy0 = max(self.x0, o.x0), max(self.y0, o.y0)
        ix1, iy1 = min(self.x1, o.x1), min(self.y1, o.y1)
        inter = max(0.0, ix1 - ix0) * max(0.0, iy1 - iy0)
        union = self.area() + o.area() - inter
        return inter / union if union > 0 else 0.0


@dataclass
class GtBox:
    box: Box
    difficult: bool = False
    matched: bool = False


@dataclass
class Det:
    img_id: str
    score: float
    box: Box


def load_pascal_annotation(fn: str) -> dict[str, list[GtBox]]:
    """Parse one PASCAL VOC annotation XML: class -> gt boxes."""
    root = ET.parse(fn).getroot()
    out: dict[str, list[GtBox]] = defaultdict(list)
    for obj in root.iter("object"):
        cls = obj.findtext("name")
        bb = obj.find("bndbox")
        box = Box(float(bb.findtext("xmin")), float(bb.findtext("ymin")),
                  float(bb.findtext("xmax")), float(bb.findtext("ymax")))
        difficult = (obj.findtext("difficult") or "0").strip() == "1"
        out[cls].append(GtBox(box, difficult))
    return dict(out)


def load_dets_file(fn: str) -> dict[str, list[Det]]:
    """Text dets: ``img_id class score x0 y0 x1 y1`` per line -> class -> dets."""
    out: dict[str, list[Det]] = defaultdict(list)
    with open(fn) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) != 7:
                raise ValueError(
                    f"{os.path.basename(fn)}:{ln}: want 7 fields, "
                    f"got {len(parts)}")
            img_id, cls, score, x0, y0, x1, y1 = parts
            out[cls].append(Det(img_id, float(score),
                                Box(float(x0), float(y0), float(x1), float(y1))))
    return dict(out)


def load_gt_file(fn: str) -> dict[str, dict[str, list[GtBox]]]:
    """Text gt: ``img_id class x0 y0 x1 y1 [difficult]`` -> class -> img -> boxes."""
    out: dict[str, dict[str, list[GtBox]]] = defaultdict(lambda: defaultdict(list))
    with open(fn) as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) not in (6, 7):
                raise ValueError(
                    f"{os.path.basename(fn)}:{ln}: want 6-7 fields, "
                    f"got {len(parts)}")
            img_id, cls = parts[0], parts[1]
            box = Box(*(float(v) for v in parts[2:6]))
            diff = len(parts) == 7 and parts[6] == "1"
            out[cls][img_id].append(GtBox(box, diff))
    return {c: dict(v) for c, v in out.items()}


@dataclass
class PrResult:
    cls: str
    ap: float
    n_gt: int
    n_det: int
    recall: np.ndarray
    precision: np.ndarray


def score_class(dets: list[Det], gt: dict[str, list[GtBox]],
                iou_thresh: float = 0.5, use_07_metric: bool = False) -> PrResult:
    """Greedy matching by descending score (the standard VOC protocol,
    ref results_io.cc score flow)."""
    for boxes in gt.values():
        for g in boxes:
            g.matched = False
    n_gt = sum(1 for boxes in gt.values() for g in boxes if not g.difficult)
    dets = sorted(dets, key=lambda d: -d.score)
    tp = np.zeros(len(dets))
    fp = np.zeros(len(dets))
    for i, d in enumerate(dets):
        cands = gt.get(d.img_id, [])
        best, best_iou = None, iou_thresh
        for g in cands:
            iou = d.box.iou(g.box)
            if iou >= best_iou and not g.matched:
                best, best_iou = g, iou
        if best is None:
            # also allow matching an already-matched or difficult box check
            anyover = any(d.box.iou(g.box) >= iou_thresh and g.difficult
                          for g in cands)
            if anyover:
                continue  # difficult boxes neither count nor penalize
            fp[i] = 1
        elif best.difficult:
            pass  # ignored
        else:
            best.matched = True
            tp[i] = 1
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / max(n_gt, 1)
    precision = ctp / np.maximum(ctp + cfp, 1e-12)
    ap = _voc_ap(recall, precision, use_07_metric)
    return PrResult("", ap, n_gt, len(dets), recall, precision)


def _voc_ap(recall: np.ndarray, precision: np.ndarray,
            use_07_metric: bool) -> float:
    if len(recall) == 0:
        return 0.0
    if use_07_metric:  # 11-point interpolation
        ap = 0.0
        for t in np.linspace(0, 1, 11):
            p = precision[recall >= t].max() if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    # area under the monotone envelope
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def score_all(dets_by_cls: dict[str, list[Det]],
              gt_by_cls: dict[str, dict[str, list[GtBox]]],
              iou_thresh: float = 0.5,
              use_07_metric: bool = False) -> tuple[list[PrResult], float]:
    results = []
    for cls in sorted(gt_by_cls):
        r = score_class(dets_by_cls.get(cls, []), gt_by_cls[cls],
                        iou_thresh, use_07_metric)
        r.cls = cls
        results.append(r)
    mAP = float(np.mean([r.ap for r in results])) if results else 0.0
    return results, mAP
