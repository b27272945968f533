"""Application modes: predict, pyramid packing, dense-equivalence tests, scoring.

Counterpart of ``boda_tpu/modes/apps.py``, with its Fields, output lines and
errors word for word: ``cnet_predict`` (ref src/caffeif.H:120),
``img_pyra_pack``/``blf_pack`` (ref src/blf_pack.cc), ``conv_pyra`` (ref
src/conv_pyra.cc:23), ``test_dense`` (ref src/test_dense.cc:44),
``predict_dense``, ``test_upsamp`` and ``score``/``score_files``/``load_pil``
(ref src/results_io.cc); the scorer is apps/scoring.py. The engines default
to the port's ``(mode=cuda)`` on the card, as run_cnet does (boda_tpu's
default is its f32 ``xla`` engine); ``test_upsamp``'s two engines are the
library path, with a ``device`` Field.
"""

from __future__ import annotations

import json
import os

import numpy as np

from .. import graph  # noqa: F401  (registers the "conv_fwd" engines)
from ..config import ConfigError, Field, Mode, register
from ..utils.dims import NDA
from ..utils.img_io import Img
from .cnet import load_net


@register("mode", "cnet_predict", help="classify image(s) with a net; print top-N")
class CnetPredict(Mode):
    model = Field(str, default="", help="zoo model name")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    weights_fn = Field("filename", default="", help="caffemodel weights")
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="forward engine")
    img_fns = Field((list, "filename"), req=True, help="input image files")
    out_node_name = Field(str, default="prob", help="output prob node")
    top_n = Field(int, default="5", help="print top N classes")
    labels_fn = Field("filename", default="", help="class-label names, one/line")
    in_sz = Field(int, default="0", help="input size (0=model default)")
    scale = Field(float, default="1.0", help="input scale after mean subtract")
    # multi-scale: also evaluate a 2x-upsampled center crop and average probs
    # (ref enable_upsamp_net second-net flow, caffeif.H:50)
    enable_upsamp_net = Field(bool, default="0", help="average with 2x-upsampled crop")

    def main(self) -> None:
        from ..apps.preproc import center_crop, img_to_batch_np
        imgs = [Img.load(fn) for fn in self.img_fns]
        pipe, in_dims = load_net(self.model, self.ptt_fn, self.weights_fn,
                                 img=len(imgs), in_sz=self.in_sz)
        d = in_dims["data"]
        batch = np.zeros((len(imgs), d["y"], d["x"], 4), np.uint8)
        for i, im in enumerate(imgs):
            batch[i] = im.resize(d["y"], d["x"]).data
        x = img_to_batch_np(batch, scale=self.scale).astype(np.float32)
        self.conv_fwd.init(pipe)
        outs = self.conv_fwd.run_fwd({"data": NDA(d, x)}, [self.out_node_name])
        prob = outs[self.out_node_name].data.reshape(len(imgs), -1)
        if self.enable_upsamp_net:
            up = np.zeros_like(batch)
            for i, im in enumerate(imgs):
                big = im.resize(d["y"] * 2, d["x"] * 2)
                up[i] = center_crop(big.data, d["y"], d["x"])
            xu = img_to_batch_np(up, scale=self.scale).astype(np.float32)
            outs_u = self.conv_fwd.run_fwd({"data": NDA(d, xu)},
                                           [self.out_node_name])
            prob = 0.5 * (prob + outs_u[self.out_node_name].data
                          .reshape(len(imgs), -1))
        labels = None
        if self.labels_fn:
            with open(self.labels_fn) as f:
                labels = [ln.strip() for ln in f]
        for i, fn in enumerate(self.img_fns):
            top = np.argsort(-prob[i])[: self.top_n]
            items = [{"cls": int(c),
                      "label": labels[c] if labels and c < len(labels) else str(int(c)),
                      "p": round(float(prob[i][c]), 5)} for c in top]
            print(json.dumps({"img": os.path.basename(fn), "top": items}))


@register("mode", "blf_pack", help="bottom-left-fill pack a list of box sizes")
class BlfPack(Mode):
    sizes = Field((list, "lexp"), req=True,
                  help="box sizes, e.g. (a=(y=100,x=200),b=(y=50,x=50))")
    plane_y = Field(int, default="512", help="plane height")
    plane_x = Field(int, default="512", help="plane width")
    pad = Field(int, default="0", help="padding between boxes")

    def main(self) -> None:
        from ..apps.pyramid import blf_pack
        sizes = []
        for l in self.sizes:
            g = {k: int(v.leaf_val) for k, v in l.kids}
            sizes.append((g["y"], g["x"]))
        placements = blf_pack(sizes, (self.plane_y, self.plane_x), pad=self.pad)
        for i, p in enumerate(placements):
            print(f"box {i} sz=({p.sz[0]},{p.sz[1]}) -> plane {p.plane} "
                  f"at ({p.y},{p.x})")
        print(f"blf_pack: {len(sizes)} boxes into "
              f"{max(p.plane for p in placements) + 1} plane(s)")


@register("mode", "img_pyra_pack", help="pack an image's scale pyramid into planes")
class ImgPyraPack(Mode):
    img_fn = Field("filename", req=True, help="input image")
    plane_y = Field(int, default="512", help="plane height")
    plane_x = Field(int, default="512", help="plane width")
    interval = Field(int, default="4", help="scales per octave")
    min_sz = Field(int, default="32", help="smallest pyramid dim")
    write_planes = Field(bool, default="0", help="save plane images as PNGs")

    def main(self) -> None:
        from ..apps.pyramid import img_pyra_pack
        img = Img.load(self.img_fn)
        pack = img_pyra_pack(img, (self.plane_y, self.plane_x),
                             interval=self.interval, min_sz=self.min_sz)
        for i, (p, sz) in enumerate(zip(pack.placements, pack.sizes)):
            print(f"scale {i}: {sz[0]}x{sz[1]} -> plane {p.plane} at ({p.y},{p.x})")
        print(f"img_pyra_pack: {len(pack.sizes)} scales into "
              f"{pack.planes.shape[0]} plane(s) of {self.plane_y}x{self.plane_x}")
        if self.write_planes:
            for i in range(pack.planes.shape[0]):
                Img(pack.planes[i]).save(self.out_path(f"plane_{i}.png"))


@register("mode", "conv_pyra", help="run conv features over a packed scale pyramid")
class ConvPyra(Mode):
    model = Field(str, default="mini_resnet", help="zoo model (conv trunk used)")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img_fn = Field("filename", req=True, help="input image")
    out_node_name = Field(str, req=True, help="feature node to extract")
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="engine")
    plane_sz = Field(int, default="256", help="square plane size")
    interval = Field(int, default="4", help="scales per octave")
    min_sz = Field(int, default="32", help="smallest pyramid dim")

    def main(self) -> None:
        from ..apps.preproc import img_to_batch_np
        from ..apps.pyramid import feat_coords_of_placement, img_pyra_pack
        img = Img.load(self.img_fn)
        pack = img_pyra_pack(img, (self.plane_sz, self.plane_sz),
                             interval=self.interval, min_sz=self.min_sz)
        n_planes = pack.planes.shape[0]
        pipe, in_dims = load_net(self.model, self.ptt_fn, "", img=n_planes,
                                 in_sz=self.plane_sz)
        self.conv_fwd.init(pipe)
        d = in_dims["data"]
        x = img_to_batch_np(pack.planes).astype(np.float32)
        outs = self.conv_fwd.run_fwd({"data": NDA(d, x)}, [self.out_node_name])
        feat = outs[self.out_node_name]
        csi = pipe.nodes[self.out_node_name].csi
        print(f"feature node {self.out_node_name} dims={feat.dims} "
              f"support_stride={csi.support_stride} pad={csi.eff_tot_pad}")
        for i, p in enumerate(pack.placements):
            fy0, fx0, fy1, fx1 = feat_coords_of_placement(
                p, csi.support_stride, csi.eff_tot_pad)
            sub = feat.data[p.plane, :, fy0:fy1, fx0:fx1]
            print(f"scale {i} ({p.sz[0]}x{p.sz[1]}): feat[{p.plane}, :, "
                  # 3 sig figs: stable across the CPU's and the card's
                  # reduction orders (goldens compare exact text)
                  f"{fy0}:{fy1}, {fx0}:{fx1}] mean={float(sub.mean()):.3g}")


@register("mode", "test_dense", help="dense-vs-cropped-window feature equivalence")
class TestDense(Mode):
    """Scientific validation of the dense pyramid trick (ref test_dense.cc:44):
    features computed on a large input must equal features computed on an
    aligned crop, at the positions the receptive-field calculus predicts."""
    model = Field(str, default="mini_resnet", help="zoo conv model")
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="engine")
    out_node_name = Field(str, req=True, help="conv feature node to compare")
    big_sz = Field(int, default="64", help="large input size")
    win_sz = Field(int, default="32", help="cropped window size")
    mrd_toler = Field(float, default="1e-5", help="comparison tolerance")

    def main(self) -> None:
        import sys

        from ..ops.kernels.gen_data import gen_data_pattern
        from ..utils.digest import comp_vars
        pipe_b, ind_b = load_net(self.model, "", "", img=1, in_sz=self.big_sz)
        pipe_w, ind_w = load_net(self.model, "", "", img=1, in_sz=self.win_sz)
        csi = pipe_b.nodes[self.out_node_name].csi
        sy, sx = csi.support_stride
        if not sy or not sx:
            raise ConfigError(f"node {self.out_node_name} has global support; "
                              "pick a conv node")
        db = ind_b["data"]
        x_big = gen_data_pattern(db.shape, db.tn).float().numpy()
        # crop aligned to the support stride so feature grids align
        off_y, off_x = sy * 2, sx * 2
        x_win = x_big[:, :, off_y:off_y + self.win_sz, off_x:off_x + self.win_sz]
        eng_b = self.conv_fwd
        eng_b.init(pipe_b)
        fb = eng_b.run_fwd({"data": NDA(db, x_big)}, [self.out_node_name])
        from ..config import make
        # the window engine is the big one's configuration: its device,
        # kernel policy and compute dtype too (boda_tpu copies precision only,
        # which would send a CPU run to the card and run another policy there)
        eng_w = make("conv_fwd", type(eng_b)._tid, precision=eng_b.precision,
                     device=eng_b.device, kernel_policy=eng_b.kernel_policy,
                     compute_tn=eng_b.compute_tn)
        eng_w.init(pipe_w)
        fw = eng_w.run_fwd({"data": NDA(ind_w["data"], x_win)},
                           [self.out_node_name])
        big = fb[self.out_node_name].data
        win = fw[self.out_node_name].data
        fy, fx = off_y // sy, off_x // sx
        wy, wx = win.shape[2], win.shape[3]
        # interior only: border features see different (padded) context
        m = 2
        a = big[:, :, fy + m:fy + wy - m, fx + m:fx + wx - m]
        b = win[:, :, m:wy - m, m:wx - m]
        scale = max(1e-30, float(np.abs(a).max()))
        r = comp_vars(a, b, mrd_toler=self.mrd_toler, atol=self.mrd_toler * scale)
        # stdout stays platform-stable (golden-dir tests); fp detail -> stderr
        print(f"test_dense {self.model}/{self.out_node_name}: "
              f"{'PASS' if r.ok() else 'FAIL'} num_diff={r.num_diff}/{r.n} "
              f"stride=({sy},{sx}) off=({off_y},{off_x})")
        print(f"test_dense detail: {r}", file=sys.stderr)
        if not r.ok():
            sys.exit(1)


def _clip_feat_region(coords, prob_shape):
    """Clip a placement's feature-coordinate box to the valid (non-empty)
    range of the prob map: tiny scales near the min support size can round
    past the map edge, which would yield empty slices (NaN means)."""
    fy0, fx0, fy1, fx1 = coords
    fy0 = min(max(fy0, 0), prob_shape[2] - 1)
    fx0 = min(max(fx0, 0), prob_shape[3] - 1)
    fy1 = min(max(fy1, fy0 + 1), prob_shape[2])
    fx1 = min(max(fx1, fx0 + 1), prob_shape[3])
    return fy0, fx0, fy1, fx1


@register("mode", "predict_dense", help="dense multi-scale class heatmaps via fc->conv + pyramid")
class PredictDense(Mode):
    """The reference's dense multi-scale prediction story (cnet_predict
    multi-scale + conv_pyra, ref caffeif.H:87-160): convert the classifier to
    fully-convolutional (fc_to_conv), pack a scale pyramid into batch planes,
    run once, and map per-scale per-position class scores back to image
    coordinates via the receptive-field calculus."""
    model = Field(str, default="", help="zoo model name")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    weights_fn = Field("filename", default="", help="caffemodel weights")
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="engine")
    img_fn = Field("filename", req=True, help="input image")
    plane_sz = Field(int, default="256", help="square pyramid plane size")
    interval = Field(int, default="3", help="scales per octave")
    min_sz = Field(int, default="64", help="smallest pyramid dim")
    out_node_name = Field(str, default="prob", help="dense prob node")
    top_n = Field(int, default="3", help="top classes per scale")
    write_heatmap = Field(str, default="", help="write argmax-prob heatmap PNG")
    # annotation pipeline (temporal EMA filter + coverage-grid NMS, ref
    # caffeif.cc:399-560); n_frames>1 feeds the same image repeatedly to
    # exercise the filter's convergence (video stand-in)
    annos = Field(bool, default="0", help="emit NMS'd box annotations")
    n_frames = Field(int, default="1", help="filter update rounds")
    filt_rate = Field(float, default="0.2", help="EMA rate (<1)")
    filt_show_thresh = Field(float, default="0.02", help="display-on threshold")
    filt_drop_thresh = Field(float, default="0.005", help="display-off threshold")
    nms_grid_pels = Field(int, default="25", help="nms coverage grid cell size")
    nms_core_rat = Field(float, default="0.75", help="core shrink for coverage")
    max_num_disp = Field(int, default="20", help="max total displayed items")
    max_labels_per_anno = Field(int, default="5", help="max labels per box")

    def main(self) -> None:
        from ..apps.preproc import img_to_batch_np
        from ..apps.pyramid import feat_coords_of_placement, img_pyra_pack
        from ..frontend.surgery import fc_to_conv
        img = Img.load(self.img_fn)
        pack = img_pyra_pack(img, (self.plane_sz, self.plane_sz),
                             interval=self.interval, min_sz=self.min_sz)
        n_planes = pack.planes.shape[0]
        pipe, in_dims = load_net(self.model, self.ptt_fn, self.weights_fn,
                                 img=n_planes, in_sz=self.plane_sz)
        converted = fc_to_conv(pipe)
        d = in_dims["data"]
        self.conv_fwd.init(pipe)
        x = img_to_batch_np(pack.planes).astype(np.float32)
        outs = self.conv_fwd.run_fwd({"data": NDA(d, x)}, [self.out_node_name])
        prob = outs[self.out_node_name].data  # (planes, cls, fy, fx)
        csi = pipe.nodes[self.out_node_name].csi
        print(f"predict_dense: fc_to_conv converted {converted}; dense prob "
              f"dims={outs[self.out_node_name].dims} "
              f"stride={csi.support_stride}")
        for i, p in enumerate(pack.placements):
            fy0, fx0, fy1, fx1 = _clip_feat_region(
                feat_coords_of_placement(p, csi.support_stride,
                                         csi.eff_tot_pad), prob.shape)
            sub = prob[p.plane, :, fy0:fy1, fx0:fx1]
            mean_prob = sub.reshape(sub.shape[0], -1).mean(axis=1)
            top = np.argsort(-mean_prob)[: self.top_n]
            print(f"scale {i} ({p.sz[0]}x{p.sz[1]}): positions "
                  f"{sub.shape[1]}x{sub.shape[2]} top="
                  f"{[(int(c), round(float(mean_prob[c]), 4)) for c in top]}")
        if self.write_heatmap:
            hm = prob.max(axis=1)  # max class prob per position
            lo, hi = float(hm.min()), float(hm.max())
            u8 = ((hm - lo) / max(hi - lo, 1e-9) * 255).astype(np.uint8)
            for pl in range(n_planes):
                rgb = np.stack([u8[pl]] * 3, axis=2)
                Img.from_rgb(rgb).save(
                    self.out_path(f"{self.write_heatmap}_{pl}.png"))
            print(f"wrote {n_planes} heatmap plane(s)")
        if self.annos:
            from ..apps.pred_state import PredState, feat_pel_img_boxes
            n_cls = prob.shape[1]
            ps = PredState(
                n_cls, filt_rate=self.filt_rate,
                filt_show_thresh=self.filt_show_thresh,
                filt_drop_thresh=self.filt_drop_thresh,
                nms_grid_pels=(self.nms_grid_pels, self.nms_grid_pels),
                nms_core_rat=self.nms_core_rat,
                max_num_disp=self.max_num_disp,
                max_labels_per_anno=self.max_labels_per_anno)
            regions = []
            for p in pack.placements:
                fy0, fx0, fy1, fx1 = _clip_feat_region(
                    feat_coords_of_placement(p, csi.support_stride,
                                             csi.eff_tot_pad), prob.shape)
                boxes = feat_pel_img_boxes(
                    fy0, fx0, fy1, fx1, csi.support_stride, csi.support_sz,
                    csi.eff_tot_pad, (p.sz[0], p.sz[1]),
                    (img.rgb().shape[0], img.rgb().shape[1]))
                regions.append((ps.add_scale(boxes), p.plane,
                                (fy0, fx0, fy1, fx1)))
            for _frame in range(max(1, self.n_frames)):
                for sp, plane, (fy0, fx0, fy1, fx1) in regions:
                    sub = prob[plane, :, fy0:fy1, fx0:fx1]
                    ps.update_scale(sp, sub.reshape(n_cls, -1))
            out_annos = ps.annos()
            for a in out_annos:
                items = ", ".join(f"cls{l}:filt={fp:.4f}:p={cp:.4f}"
                                  for l, fp, cp in a.items)
                print(f"anno box=({a.box[0]},{a.box[1]},{a.box[2]},{a.box[3]})"
                      f" {items}")
            print(f"predict_dense: {len(out_annos)} annos "
                  f"({self.n_frames} filter frames)")


@register("mode", "test_upsamp", help="2x-upsampled-net vs original-net equivalence")
class TestUpsamp(Mode):
    """ref test_upsamp_t (test_dense.cc:144): a net whose first conv uses
    2x-upsampled filters + doubled stride/pad, run on a 2x-upsampled image,
    must approximate the original net on the original image."""
    model = Field(str, default="mini_resnet", help="zoo conv model")
    out_node_name = Field(str, req=True, help="feature node to compare")
    in_sz = Field(int, default="32", help="original input size")
    mrd_toler = Field(float, default="1e-4", help="tolerance (fp reassociation only)")
    device = Field(str, default="cuda", help="engines' device: cuda | cpu (plain versions)")

    def main(self) -> None:
        import sys

        from ..config import make
        from ..frontend.surgery import upsample_2x_net
        from ..utils.digest import comp_vars
        from ..ops.kernels.gen_data import gen_data_pattern
        pipe_a, ind_a = load_net(self.model, "", "", img=1, in_sz=self.in_sz)
        pipe_b, ind_b = load_net(self.model, "", "", img=1, in_sz=self.in_sz * 2)
        changed = upsample_2x_net(pipe_b)
        # re-infer shapes with the modified first conv
        for node in pipe_b.nodes.values():
            if node.name not in pipe_b.weights and node.name != "data":
                node.dims = None
        pipe_b.nodes["data"].dims = ind_b["data"]
        pipe_b.calc_dims(ind_b)
        da, db = ind_a["data"], ind_b["data"]
        if pipe_b.must_dims(self.out_node_name).shape != \
                pipe_a.must_dims(self.out_node_name).shape:
            raise ConfigError(
                f"upsampled net output {pipe_b.must_dims(self.out_node_name)} != "
                f"original {pipe_a.must_dims(self.out_node_name)}")
        x = gen_data_pattern(da.shape, da.tn).float().numpy()
        # nearest-neighbor 2x upsample: the fabrication is exact for it
        x_up = np.repeat(np.repeat(x, 2, axis=2), 2, axis=3)
        # the library path in f32 on both nets (boda_tpu: its xla engine)
        ea = make("conv_fwd", "cuda", kernel_policy="lib", device=self.device)
        ea.init(pipe_a)
        eb = make("conv_fwd", "cuda", kernel_policy="lib", device=self.device)
        eb.init(pipe_b)
        fa = ea.run_fwd({"data": NDA(da, x)}, [self.out_node_name])
        fb = eb.run_fwd({"data": NDA(db, x_up)}, [self.out_node_name])
        a = fa[self.out_node_name].data
        b = fb[self.out_node_name].data
        scale = max(1e-30, float(np.abs(a).max()))
        r = comp_vars(a, b, mrd_toler=self.mrd_toler, atol=self.mrd_toler * scale)
        print(f"test_upsamp {self.model}/{self.out_node_name} (first conv "
              f"{changed!r} upsampled): {'PASS' if r.ok() else 'FAIL'} "
              f"num_diff={r.num_diff}/{r.n}")
        print(f"test_upsamp detail: {r}", file=sys.stderr)
        if not r.ok():
            sys.exit(1)


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
