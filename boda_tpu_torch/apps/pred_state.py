"""Multi-scale prediction state: per-pel PDF normalization, temporal EMA
filtering with show/drop hysteresis, and coverage-grid NMS annotations.

A copy of ``boda_tpu/apps/pred_state.py``. Parity target: the cnet_predict_t
pred/filter/anno machinery (ref src/caffeif.H:87-160 scale_info_t/
pred_state_t/nms_grid_t and src/caffeif.cc:399-560 do_predict_region/
nms_grid_op/pred_state_to_annos). The conv pyramid runs on the card as one
forward; this post-processing is host numpy over the handful of per-scale
prob planes (vectorized over pels, unlike the reference's per-pel loops).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ScalePred:
    """One pyramid scale's prediction region: per-feat-pel image boxes and
    the flat slice [psb, psb + n_labels*n_pels) of the state arrays (the
    scale_info_t psb indexing scheme, ref caffeif.H:96-101)."""
    img_boxes: np.ndarray   # (n_pels, 4) int32 (x0, y0, x1, y1) in image coords
    psb: int
    n_pels: int


@dataclass
class Anno:
    box: tuple[int, int, int, int]
    items: list = field(default_factory=list)  # (label_ix, filt_prob, cur_prob)


class PredState:
    """Dense multi-scale class predictions with temporal filtering + NMS."""

    def __init__(self, n_labels: int, *, filt_rate: float = 0.2,
                 filt_show_thresh: float = 0.02,
                 filt_drop_thresh: float = 0.005,
                 nms_grid_pels: tuple[int, int] = (25, 25),
                 nms_core_rat: float = 0.75, max_num_disp: int = 20,
                 max_labels_per_anno: int = 5):
        self.n_labels = n_labels
        self.filt_rate = filt_rate
        self.filt_show_thresh = filt_show_thresh
        self.filt_drop_thresh = filt_drop_thresh
        self.nms_grid_pels = nms_grid_pels
        self.nms_core_rat = nms_core_rat
        self.max_num_disp = max_num_disp
        self.max_labels_per_anno = max_labels_per_anno
        self.scales: list[ScalePred] = []
        self._n = 0
        self.cur_prob = np.zeros(0)
        self.filt_prob = np.zeros(0)
        self.filt_init = np.zeros(0, bool)
        self.to_disp = np.zeros(0, bool)

    def add_scale(self, img_boxes: np.ndarray) -> ScalePred:
        """Register a scale given its per-feat-pel image boxes (n_pels, 4)."""
        sp = ScalePred(img_boxes=np.asarray(img_boxes, np.int32),
                       psb=self._n, n_pels=len(img_boxes))
        self.scales.append(sp)
        self._n += self.n_labels * sp.n_pels
        for name in ("cur_prob", "filt_prob"):
            setattr(self, name, np.resize(getattr(self, name), self._n))
        self.filt_prob[sp.psb:] = 0.0
        self.cur_prob[sp.psb:] = 0.0
        self.filt_init = np.resize(self.filt_init, self._n)
        self.filt_init[sp.psb:] = False
        self.to_disp = np.resize(self.to_disp, self._n)
        self.to_disp[sp.psb:] = False
        return sp

    def update_scale(self, sp: ScalePred, probs: np.ndarray) -> None:
        """Feed one scale's raw outputs (n_labels, n_pels): per-pel
        normalize (keep if ~PDF else softmax, ref caffeif.cc:509-539),
        then EMA-filter and apply the show/drop hysteresis."""
        assert probs.shape == (self.n_labels, sp.n_pels), probs.shape
        p = probs.astype(np.float64)
        pel_sums = p.sum(axis=0)
        pel_maxs = p.max(axis=0)
        is_pdf = (np.abs(pel_sums - 1.0) < 0.01) & (pel_maxs < 1.01)
        sm = np.exp(p - pel_maxs[None, :])
        sm /= sm.sum(axis=0, keepdims=True)
        p = np.where(is_pdf[None, :], p, sm)
        flat = p.reshape(-1)  # chan-major then pel (psix = psb + c*n_pels + pel)
        s = slice(sp.psb, sp.psb + self.n_labels * sp.n_pels)
        init = self.filt_init[s]
        fp = self.filt_prob[s]
        fp = np.where(init, fp * (1 - self.filt_rate) + flat * self.filt_rate,
                      flat)
        self.filt_prob[s] = fp
        self.filt_init[s] = True
        self.cur_prob[s] = flat
        td = self.to_disp[s]
        td = np.where(fp >= self.filt_show_thresh, True,
                      np.where(fp <= self.filt_drop_thresh, False, td))
        self.to_disp[s] = td

    # -- NMS coverage grid (ref caffeif.cc:399-427) ------------------------------

    def _shrunk_quant(self, box) -> tuple[int, int, int, int]:
        r, (gx, gy) = self.nms_core_rat, self.nms_grid_pels
        x0, y0, x1, y1 = (int(round(v * r)) for v in box)
        return (x0 // gx, y0 // gy, x1 // gx, y1 // gy)

    def _grid_op(self, grid: dict, do_set: bool, box):
        qx0, qy0, qx1, qy1 = self._shrunk_quant(box)
        center = ((qx0 + qx1) // 2, (qy0 + qy1) // 2)
        center_match = grid.get(center)
        tot = over = center_cnt = 0
        for by in range(qy0, qy1):
            for bx in range(qx0, qx1):
                if do_set:
                    grid[(bx, by)] = tuple(box)
                    continue
                tot += 1
                hit = grid.get((bx, by))
                if hit is not None:
                    over += 1
                    if center_match is not None and hit == center_match:
                        center_cnt += 1
        if do_set:
            return None
        if center_cnt * 4 > tot * 3:  # mostly covers one existing match
            return center_match
        if over:
            return ()  # suppressed
        return tuple(box)  # no overlap: new anno

    def _box_of(self, psix: int):
        for sp in self.scales:
            if sp.psb <= psix < sp.psb + self.n_labels * sp.n_pels:
                return sp.img_boxes[(psix - sp.psb) % sp.n_pels]
        raise IndexError(psix)

    def annos(self) -> list[Anno]:
        """Displayed predictions -> NMS'd annotation list (highest filtered
        prob first; overlapping boxes merge labels into the covering anno)."""
        disp = np.nonzero(self.to_disp)[0]
        disp = disp[np.argsort(-self.filt_prob[disp], kind="stable")]
        grid: dict = {}
        annos: dict[tuple, Anno] = {}
        seen: dict[tuple, set] = {}
        n_disp = 0
        for psix in disp:
            if n_disp == self.max_num_disp:
                break
            box = tuple(int(v) for v in self._box_of(int(psix)))
            nms_box = self._grid_op(grid, False, box)
            if nms_box == ():
                continue  # overlaps another core, no center match
            a = annos.get(nms_box)
            if a is not None and len(a.items) >= self.max_labels_per_anno:
                continue
            if a is None:
                assert nms_box == box
                a = annos[nms_box] = Anno(box=nms_box)
                seen[nms_box] = set()
                self._grid_op(grid, True, box)
            label_ix = self._label_of(int(psix))
            if label_ix in seen[nms_box]:
                continue  # dup label within one anno
            seen[nms_box].add(label_ix)
            a.items.append((label_ix, float(self.filt_prob[psix]),
                            float(self.cur_prob[psix])))
            n_disp += 1
        return list(annos.values())

    def _label_of(self, psix: int) -> int:
        for sp in self.scales:
            if sp.psb <= psix < sp.psb + self.n_labels * sp.n_pels:
                return (psix - sp.psb) // sp.n_pels
        raise IndexError(psix)


def feat_pel_img_boxes(fy0: int, fx0: int, fy1: int, fx1: int,
                       support_stride: tuple[int, int],
                       support_sz: tuple[int, int],
                       eff_tot_pad: tuple[int, int],
                       scale_img_sz: tuple[int, int],
                       orig_img_sz: tuple[int, int]) -> np.ndarray:
    """Image-space box of every feat pel in [fy0,fy1)x[fx0,fx1): the pel's
    support box in scaled-image coords, rescaled to the original image (the
    feat_img_box -> img_box mapping, ref caffeif.cc:376-392). Returns
    (n_pels, 4) int32 (x0, y0, x1, y1), pel order row-major (y, x)."""
    sy, sx = support_stride
    ky, kx = support_sz
    py, px = eff_tot_pad
    ys = np.arange(fy0, fy1)
    xs = np.arange(fx0, fx1)
    # support box of feat pel (y, x) in scaled-image coords
    y0 = ys * sy - py
    x0 = xs * sx - px
    sh, sw = scale_img_sz
    oh, ow = orig_img_sz
    ry, rx = oh / max(sh, 1), ow / max(sw, 1)
    bx0, by0 = np.meshgrid(x0, y0)[0], np.meshgrid(x0, y0)[1]
    boxes = np.stack([
        np.clip(np.round(bx0 * rx), 0, ow).astype(np.int32),
        np.clip(np.round(by0 * ry), 0, oh).astype(np.int32),
        np.clip(np.round((bx0 + kx) * rx), 0, ow).astype(np.int32),
        np.clip(np.round((by0 + ky) * ry), 0, oh).astype(np.int32),
    ], axis=-1)
    return boxes.reshape(-1, 4)
