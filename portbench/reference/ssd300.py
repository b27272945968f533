"""SSD300 in its VOC configuration (Liu et al. 2016, arXiv:1512.02325;
weiliu89/caffe models/VGGNet/VOC0712/SSD_300x300 deploy.prototxt): the
VGG-16 trunk with pool5 3x3/1 and fc6/fc7 as convolutions (fc6 dilated 6),
the extra layers conv6..conv9, L2 Normalize on conv4_3 (scale 20), six
sources with 4/6/6/6/4/4 priors per location (8,732 priors), a 3x3 loc and
conf head on each, and DetectionOutput: CENTER_SIZE decoding with the
prior variances, per-class greedy NMS (IoU > 0.45 suppresses, top_k 400,
confidence > 0.01), then the keep_top_k 200 best across classes per image.
Plain float32 PyTorch and NumPy.

Ties: among equal scores the lower index comes first (a stable sort), in
the per-class top_k over priors and in the keep_top_k over the per-class
lists taken class by class. Caffe leaves this order to ``std::sort``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import common as C

# (name, in, out, k, stride, pad, dilation); "pool<k>,<s>,<p>" entries pool
TRUNK = [("conv1_1", 3, 64, 3, 1, 1, 1), ("conv1_2", 64, 64, 3, 1, 1, 1), "pool2,2,0",
         ("conv2_1", 64, 128, 3, 1, 1, 1), ("conv2_2", 128, 128, 3, 1, 1, 1), "pool2,2,0",
         ("conv3_1", 128, 256, 3, 1, 1, 1), ("conv3_2", 256, 256, 3, 1, 1, 1),
         ("conv3_3", 256, 256, 3, 1, 1, 1), "pool2,2,0",
         ("conv4_1", 256, 512, 3, 1, 1, 1), ("conv4_2", 512, 512, 3, 1, 1, 1),
         ("conv4_3", 512, 512, 3, 1, 1, 1), "pool2,2,0",
         ("conv5_1", 512, 512, 3, 1, 1, 1), ("conv5_2", 512, 512, 3, 1, 1, 1),
         ("conv5_3", 512, 512, 3, 1, 1, 1), "pool3,1,1",
         ("fc6", 512, 1024, 3, 1, 6, 6), ("fc7", 1024, 1024, 1, 1, 0, 1),
         ("conv6_1", 1024, 256, 1, 1, 0, 1), ("conv6_2", 256, 512, 3, 2, 1, 1),
         ("conv7_1", 512, 128, 1, 1, 0, 1), ("conv7_2", 128, 256, 3, 2, 1, 1),
         ("conv8_1", 256, 128, 1, 1, 0, 1), ("conv8_2", 128, 256, 3, 1, 0, 1),
         ("conv9_1", 256, 128, 1, 1, 0, 1), ("conv9_2", 128, 256, 3, 1, 0, 1)]
# (source, head tag, in channels, priors per location, min size, max size, aspect ratios)
SOURCES = [("conv4_3", "conv4_3_norm", 512, 4, 30.0, 60.0, (2.0,)),
           ("fc7", "fc7", 1024, 6, 60.0, 111.0, (2.0, 3.0)),
           ("conv6_2", "conv6_2", 512, 6, 111.0, 162.0, (2.0, 3.0)),
           ("conv7_2", "conv7_2", 256, 6, 162.0, 213.0, (2.0, 3.0)),
           ("conv8_2", "conv8_2", 256, 4, 213.0, 264.0, (2.0,)),
           ("conv9_2", "conv9_2", 256, 4, 264.0, 315.0, (2.0,))]
VARIANCE = (0.1, 0.1, 0.2, 0.2)


def _convs(cfg):
    n_cls = cfg["num_classes"]
    out = [c for c in TRUNK if not isinstance(c, str)]
    for _, tag, ci, npl, *_ in SOURCES:
        out += [(f"{tag}_mbox_loc", ci, npl * 4, 3, 1, 1, 1),
                (f"{tag}_mbox_conf", ci, npl * n_cls, 3, 1, 1, 1)]
    return out


def spec(cfg) -> list:
    """[(name, shape, init)] of every parameter (see resnet50.spec)."""
    init = cfg["init"]
    out = []
    for name, ci, co, k, *_ in _convs(cfg):
        gain = init["first_conv_gain"] if name == "conv1_1" else 1.0
        out += [(f"{name}__filts", (co, ci, k, k), ("he", ci * k * k, gain)),
                (f"{name}__biases", (co,), ("normal", 0.0, init["bias_std"]))]
    out.append(("conv4_3_norm__scales", (512,), ("const", cfg["normalize_scale"])))
    return out


def _trunk_sizes(size: int) -> dict:
    """Spatial size of each trunk conv's input and output."""
    h, out = size, {}
    for c in TRUNK:
        if isinstance(c, str):
            k, s, p = (int(v) for v in c[4:].split(","))
            h = C.pool_out_ceil(h, k, s, p)
            continue
        name, _, _, k, s, p, d = c
        oh = C.conv_out(h, k, s, p, d)
        out[name] = (h, oh)
        h = oh
    return out


def layers(cfg, batch: int, size: int = 0) -> list:
    """The conv work of one forward (see resnet50.layers)."""
    sz = _trunk_sizes(size or cfg["image_size"])
    src_h = {tag: sz[src][1] for src, tag, *_ in SOURCES}
    out = []
    for name, ci, co, k, s, p, d in _convs(cfg):
        h = sz[name][0] if name in sz else src_h[name.rsplit("_mbox_", 1)[0]]
        oh = C.conv_out(h, k, s, p, d)
        out.append(dict(name=name, kind="conv", n=batch, h=h, w=h, c=ci, oc=co, k=k,
                        stride=s, pad=p, dil=d, oh=oh, ow=oh, first=name == "conv1_1"))
    return out


def priors(cfg, size: int = 0) -> np.ndarray:
    """(n_priors, 4) boxes and (n_priors, 4) variances of the six sources,
    source by source (Caffe's PriorBoxLayer: min box, then sqrt(min*max),
    then each aspect ratio and its flip; corners over the image size). The
    step between centres is the image size over the feature size, as the
    program's zoo has it, not the published PriorBox steps (the
    configuration's ``assumed.prior_steps``)."""
    img = size or cfg["image_size"]
    sz = _trunk_sizes(img)
    boxes = []
    for src, _, _, npl, mn, mx, ars in SOURCES:
        f = sz[src][1]
        step = img / f
        wh = [(mn, mn), (math.sqrt(mn * mx),) * 2]
        for ar in ars:
            wh += [(mn * math.sqrt(ar), mn / math.sqrt(ar)),
                   (mn * math.sqrt(1 / ar), mn / math.sqrt(1 / ar))]
        assert len(wh) == npl
        c = (np.arange(f, dtype=np.float32) + 0.5) * np.float32(step)
        b = np.empty((f, f, npl, 4), np.float32)
        for j, (bw, bh) in enumerate(wh):
            b[:, :, j, 0] = (c[None, :] - bw / 2.0) / img
            b[:, :, j, 1] = (c[:, None] - bh / 2.0) / img
            b[:, :, j, 2] = (c[None, :] + bw / 2.0) / img
            b[:, :, j, 3] = (c[:, None] + bh / 2.0) / img
        boxes.append(b.reshape(-1, 4))
    boxes = np.concatenate(boxes)
    return boxes, np.tile(np.asarray(VARIANCE, np.float32), (len(boxes), 1))


def trunk(p: dict, x: torch.Tensor, cfg, quant=None) -> dict:
    """The head inputs of the NCHW float32 batch x: ``loc`` (n, P*4),
    ``conf_logits`` (n, P*classes) and ``conf`` (their softmax over the
    classes, flattened), each prior's values in source order, location by
    location (y, x), prior by prior."""
    feats, t = {}, x
    for c in TRUNK:
        if isinstance(c, str):
            k, s, pd = (int(v) for v in c[4:].split(","))
            t = C.maxpool_ceil(t, k, s, pd)
            continue
        name, _, _, k, s, pd, d = c
        t = C.out(F.relu(C.conv(t, p[f"{name}__filts"], p[f"{name}__biases"], s, pd, d,
                                quant=quant)), quant)
        feats[name] = t
    c43 = feats["conv4_3"]
    norm = torch.sqrt((c43 * c43).sum(dim=1, keepdim=True) + 1e-10)
    feats["conv4_3_norm"] = C.out(c43 / norm * p["conv4_3_norm__scales"].reshape(1, -1, 1, 1),
                                  quant)
    n = x.shape[0]
    locs, confs = [], []
    for src, tag, *_ in SOURCES:
        f = feats["conv4_3_norm" if src == "conv4_3" else src]
        for name, acc in ((f"{tag}_mbox_loc", locs), (f"{tag}_mbox_conf", confs)):
            h = C.out(C.conv(f, p[f"{name}__filts"], p[f"{name}__biases"], 1, 1, quant=quant),
                      quant)
            acc.append(h.permute(0, 2, 3, 1).reshape(n, -1))
    loc, logits = torch.cat(locs, 1), torch.cat(confs, 1)
    n_cls = cfg["num_classes"]
    conf = torch.softmax(logits.reshape(n, -1, n_cls), dim=2).reshape(n, -1)
    return {"loc": loc, "conf_logits": logits, "conf": conf}


def _iou(b: torch.Tensor) -> torch.Tensor:
    """(..., K, 4) corner boxes -> (..., K, K) intersection over union."""
    area = torch.clamp_min(b[..., 2] - b[..., 0], 0) * torch.clamp_min(b[..., 3] - b[..., 1], 0)
    x0 = torch.maximum(b[..., :, None, 0], b[..., None, :, 0])
    y0 = torch.maximum(b[..., :, None, 1], b[..., None, :, 1])
    x1 = torch.minimum(b[..., :, None, 2], b[..., None, :, 2])
    y1 = torch.minimum(b[..., :, None, 3], b[..., None, :, 3])
    inter = torch.clamp_min(x1 - x0, 0) * torch.clamp_min(y1 - y0, 0)
    union = area[..., :, None] + area[..., None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def detection_out(loc: torch.Tensor, conf: torch.Tensor, pri: tuple, cfg) -> np.ndarray:
    """DetectionOutput of head inputs loc (n, P*4) and conf (n, P*classes),
    computed in float32 on their device: (n, keep_top_k, 7) rows [image,
    label, score, x0, y0, x1, y1], rows past the detections label -1."""
    d = cfg["detection"]
    n_cls, bg = cfg["num_classes"], d["background_label_id"]
    n = loc.shape[0]
    pb = torch.as_tensor(pri[0], device=loc.device)
    pv = torch.as_tensor(pri[1], device=loc.device)
    P = pb.shape[0]
    lo = loc.float().reshape(n, P, 4)
    # CENTER_SIZE decoding with the variances
    pw, ph = pb[:, 2] - pb[:, 0], pb[:, 3] - pb[:, 1]
    pcx, pcy = (pb[:, 0] + pb[:, 2]) * 0.5, (pb[:, 1] + pb[:, 3]) * 0.5
    cx = pv[:, 0] * lo[..., 0] * pw + pcx
    cy = pv[:, 1] * lo[..., 1] * ph + pcy
    w = torch.exp(pv[:, 2] * lo[..., 2]) * pw
    h = torch.exp(pv[:, 3] * lo[..., 3]) * ph
    boxes = torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)
    classes = [c for c in range(n_cls) if c != bg]
    sc = conf.float().reshape(n, P, n_cls)[..., classes].transpose(1, 2)  # (n, C, P)
    k = min(d["top_k"], P)
    top, idx = torch.sort(sc, dim=-1, descending=True, stable=True)
    top, idx = top[..., :k], idx[..., :k]
    cand = torch.gather(boxes[:, None].expand(n, len(classes), P, 4), 2,
                        idx[..., None].expand(*idx.shape, 4))
    over = (_iou(cand) > d["nms_threshold"]).cpu().numpy()
    top_np, cand_np = top.cpu().numpy(), cand.cpu().numpy()
    keep = np.zeros(top_np.shape, bool)
    ok = top_np > d["confidence_threshold"]
    for i in range(k):  # greedy, in score order: kept unless a kept one overlaps it
        keep[..., i] = ok[..., i] & ~np.any(keep[..., :i] & over[..., :i, i], axis=-1)
    kk = d["keep_top_k"]
    out = np.zeros((n, kk, 7), np.float32)
    out[:, :, 1] = -1
    for img in range(n):
        s = np.where(keep[img], top_np[img], -1.0).reshape(-1)  # class by class
        order = np.argsort(-s, kind="stable")[:kk]
        order = order[s[order] > 0]
        ci, ri = order // k, order % k
        m = len(order)
        out[img, :, 0] = img
        out[img, :m, 1] = np.asarray(classes, np.float32)[ci]
        out[img, :m, 2] = s[order]
        out[img, :m, 3:] = cand_np[img, ci, ri]
    return out
