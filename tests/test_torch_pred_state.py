"""The port's copy of the multi-scale prediction postprocessing
(boda_tpu_torch/apps/pred_state.py): tests/test_pred_state.py's seven cases
on the port, each state and annotation list also equal to boda_tpu's
(boda_tpu/apps/pred_state.py) after the same calls.

Covers per-pel PDF-vs-softmax normalization, EMA filtering with show/drop
hysteresis, coverage-grid NMS (suppression, center-match merge, label dedup,
caps), and the feat-pel -> image-box mapping. Ref semantics:
src/caffeif.cc:399-560."""

import numpy as np

from boda_tpu.apps import pred_state as ref
from boda_tpu_torch.apps.pred_state import PredState, feat_pel_img_boxes


class _Both:
    """A port PredState whose every call is repeated on boda_tpu's, and
    whose state and annotations are held equal to it after each."""

    def __init__(self, n_labels, **kw):
        self.p, self.r = PredState(n_labels, **kw), ref.PredState(n_labels, **kw)

    def add_scale(self, boxes):
        return self.p.add_scale(boxes), self.r.add_scale(boxes)

    def update_scale(self, sp, probs):
        self.p.update_scale(sp[0], probs)
        self.r.update_scale(sp[1], probs)
        for k in ("cur_prob", "filt_prob", "filt_init", "to_disp"):
            assert np.array_equal(getattr(self.p, k), getattr(self.r, k)), k

    def annos(self):
        a, b = self.p.annos(), self.r.annos()
        assert [(x.box, x.items) for x in a] == [(x.box, x.items) for x in b]
        return a

    def __getattr__(self, k):
        return getattr(self.p, k)


def _mk(n_labels=3, boxes=None, **kw):
    ps = _Both(n_labels, **kw)
    if boxes is None:
        boxes = [[(0, 0, 100, 100)]]
    sps = [ps.add_scale(np.array(b, np.int32)) for b in boxes]
    return ps, sps


def test_pdf_kept_softmax_applied():
    ps, (sp,) = _mk(n_labels=2, boxes=[[(0, 0, 10, 10), (10, 0, 20, 10)]])
    # pel 0: already a pdf (sums to 1); pel 1: logits -> softmaxed
    probs = np.array([[0.7, 2.0],
                      [0.3, 0.0]])
    ps.update_scale(sp, probs)
    got = ps.cur_prob.reshape(2, 2)  # (label, pel)
    assert np.allclose(got[:, 0], [0.7, 0.3])
    e = np.exp([2.0, 0.0])
    assert np.allclose(got[:, 1], e / e.sum())


def test_ema_filter_and_hysteresis():
    # two labels, pdf inputs (kept as-is): label 0 goes 1.0 then 0.0 forever
    ps, (sp,) = _mk(n_labels=2, boxes=[[(0, 0, 50, 50)]],
                    filt_rate=0.5, filt_show_thresh=0.6, filt_drop_thresh=0.2)
    ps.update_scale(sp, np.array([[1.0], [0.0]]))
    assert ps.to_disp[0]  # filt init = 1.0 >= show
    off = np.array([[0.0], [1.0]])
    ps.update_scale(sp, off)
    assert ps.to_disp[0] and np.isclose(ps.filt_prob[0], 0.5)
    ps.update_scale(sp, off)
    assert ps.to_disp[0] and np.isclose(ps.filt_prob[0], 0.25)  # hysteresis band
    ps.update_scale(sp, off)
    assert not ps.to_disp[0]  # fell through drop thresh


def test_nms_separate_boxes_two_annos():
    ps, (sp,) = _mk(n_labels=1,
                    boxes=[[(0, 0, 100, 100), (500, 500, 600, 600)]],
                    filt_show_thresh=0.1)
    ps.update_scale(sp, np.array([[0.9, 0.8]]))
    annos = ps.annos()
    assert len(annos) == 2
    assert annos[0].box == (0, 0, 100, 100)  # higher prob first


def test_nms_overlap_suppressed_and_merged():
    # same box twice with different labels -> center-match merge into one anno
    ps, (sp,) = _mk(n_labels=2, boxes=[[(0, 0, 100, 100)]],
                    filt_show_thresh=0.1)
    ps.update_scale(sp, np.array([[0.9], [0.8]]))
    annos = ps.annos()
    assert len(annos) == 1
    assert len(annos[0].items) == 2  # both labels merged onto one box
    # a shifted-but-core-overlapping weaker box is suppressed entirely
    ps2, (sp2,) = _mk(n_labels=1,
                      boxes=[[(0, 0, 100, 100), (30, 30, 130, 130)]],
                      filt_show_thresh=0.1)
    ps2.update_scale(sp2, np.array([[0.9, 0.8]]))
    annos2 = ps2.annos()
    assert len(annos2) == 1
    assert annos2[0].box == (0, 0, 100, 100)


def test_max_labels_per_anno_cap():
    ps, (sp,) = _mk(n_labels=5, boxes=[[(0, 0, 100, 100)]],
                    filt_show_thresh=0.01, max_labels_per_anno=2)
    ps.update_scale(sp, np.array([[0.5], [0.4], [0.3], [0.2], [0.1]]))
    annos = ps.annos()
    assert len(annos) == 1 and len(annos[0].items) == 2


def test_label_dedup_within_anno():
    # same label at two pels of the same box region: only counted once
    ps, (sp,) = _mk(n_labels=1, boxes=[[(0, 0, 100, 100), (0, 0, 100, 100)]],
                    filt_show_thresh=0.1)
    ps.update_scale(sp, np.array([[0.9, 0.8]]))
    annos = ps.annos()
    assert len(annos) == 1 and len(annos[0].items) == 1


def test_feat_pel_img_boxes_mapping():
    kw = dict(support_stride=(8, 8), support_sz=(16, 16), eff_tot_pad=(4, 4),
              scale_img_sz=(64, 64), orig_img_sz=(128, 128))
    boxes = feat_pel_img_boxes(0, 0, 2, 2, **kw)
    assert np.array_equal(boxes, ref.feat_pel_img_boxes(0, 0, 2, 2, **kw))
    assert boxes.shape == (4, 4)
    # pel (0,0): scaled box (-4,-4)..(12,12) -> x2 -> clip -> (0,0)..(24,24)
    assert tuple(boxes[0]) == (0, 0, 24, 24)
    # pel (1,1): scaled (4,4)..(20,20) -> (8,8)..(40,40)
    assert tuple(boxes[3]) == (8, 8, 40, 40)
