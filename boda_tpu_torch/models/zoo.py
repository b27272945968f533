"""Programmatic net zoo: the models the reference ships as prototxt.

Counterpart of ``boda_tpu/models/zoo.py``: graph builders emitting the
ConvPipe IR with deterministic pseudo-random weights, seeded per layer from
``stable_hash`` of the weight name exactly as ``boda_tpu`` seeds them, so the
two packages build bit-identical weights: alexnet_ng_conv, nin_imagenet,
googlenet_conv, VGG-16/19, ResNet-50/101/152, squeezenet, firenet, and the
gradient regression net ``bconv_strides``, and the detection net ``ssd300``
on the SSD head's op rules (graph/ssd_ops.py).
"""

from __future__ import annotations

import numpy as np

from ..graph.pipe import ConvOp, ConvPipe
from ..utils.dims import NDA, Dims, stable_hash


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class NetBuilder:
    """Small fluent builder over ConvPipe. Methods return the top node name."""

    def __init__(self, name: str, tn: str = "float32", weight_scale: float = 1.0,
                 seed: int = 1234):
        self.pipe = ConvPipe(name)
        self.tn = tn
        self.weight_scale = weight_scale
        self.seed = seed
        self._n = 0

    # -- weights ----------------------------------------------------------------
    def _winit(self, name: str, dims: Dims, fan_in: int) -> str:
        rng = np.random.RandomState((self.seed + stable_hash(name)) % (2 ** 31))
        std = self.weight_scale * np.sqrt(2.0 / max(fan_in, 1))
        data = (rng.randn(*dims.shape) * std).astype(np.float32)
        self.pipe.weights[name] = NDA(dims, data)
        return name

    def _binit(self, name: str, out_chan: int) -> str:
        dims = Dims.of(out_chan=out_chan, tn=self.tn)
        self.pipe.weights[name] = NDA(dims, np.zeros(out_chan, dtype=np.float32))
        return name

    # -- layers -----------------------------------------------------------------
    def input(self, name: str = "data", **dims) -> str:
        self.pipe.get_or_make_node(name)
        return name

    def conv(self, name: str, bot: str, out_chans: int, kern, stride=1, pad=0,
             groups: int = 1, relu: bool = False, in_chans: int | None = None,
             dilation=1) -> str:
        k, s, p = _pair(kern), _pair(stride), _pair(pad)
        if in_chans is None:
            raise ValueError(f"conv {name}: in_chans required (builder is eager)")
        fd = Dims.of(out_chan=out_chans, in_chan=in_chans // groups,
                     y=k[0], x=k[1], tn=self.tn)
        w = self._winit(f"{name}__filts", fd, fan_in=(in_chans // groups) * k[0] * k[1])
        b = self._binit(f"{name}__biases", out_chans)
        params = {"kern_sz": k, "stride": s, "pad": p, "groups": groups}
        if _pair(dilation) != (1, 1):  # atrous conv (SSD fc6)
            params["dilation"] = _pair(dilation)
        self.pipe.add_op(ConvOp(name, "Convolution", params,
                                bots=[bot, w, b], tops=[name]))
        return self.relu(f"{name}_relu", name) if relu else name

    def fc(self, name: str, bot: str, out_chans: int, in_feats: int,
           relu: bool = False) -> str:
        fd = Dims.of(out_chan=out_chans, in_feats=in_feats, tn=self.tn)
        w = self._winit(f"{name}__filts", fd, fan_in=in_feats)
        b = self._binit(f"{name}__biases", out_chans)
        self.pipe.add_op(ConvOp(name, "InnerProduct", {}, bots=[bot, w, b],
                                tops=[name]))
        return self.relu(f"{name}_relu", name) if relu else name

    def relu(self, name: str, bot: str) -> str:
        self.pipe.add_op(ConvOp(name, "ReLU", {}, bots=[bot], tops=[name]))
        return name

    def pool(self, name: str, bot: str, kern=2, stride=2, pad=0, avg=False,
             global_pool=False) -> str:
        params = {"kern_sz": _pair(kern), "stride": _pair(stride),
                  "pad": _pair(pad), "avg_pool": avg,
                  "global_pooling": global_pool}
        self.pipe.add_op(ConvOp(name, "Pooling", params, bots=[bot], tops=[name]))
        return name

    def lrn(self, name: str, bot: str, local_size=5, alpha=1e-4, beta=0.75) -> str:
        self.pipe.add_op(ConvOp(name, "LRN",
                                {"local_size": local_size, "alpha": alpha,
                                 "beta": beta},
                                bots=[bot], tops=[name]))
        return name

    def dropout(self, name: str, bot: str, ratio=0.5) -> str:
        self.pipe.add_op(ConvOp(name, "Dropout", {"dropout_ratio": ratio},
                                bots=[bot], tops=[name]))
        return name

    def softmax(self, name: str, bot: str) -> str:
        self.pipe.add_op(ConvOp(name, "Softmax", {}, bots=[bot], tops=[name]))
        return name

    def concat(self, name: str, bots: list[str], axis: int | None = None) -> str:
        params = {} if axis is None else {"axis": axis}
        self.pipe.add_op(ConvOp(name, "Concat", params, bots=list(bots),
                                tops=[name]))
        return name

    # -- SSD detection ops (graph/ssd_ops.py; SSD-Caffe's layer set) -------------
    def permute(self, name: str, bot: str, order: list[int]) -> str:
        self.pipe.add_op(ConvOp(name, "Permute", {"order": list(order)},
                                bots=[bot], tops=[name]))
        return name

    def flatten(self, name: str, bot: str, axis: int = 1) -> str:
        self.pipe.add_op(ConvOp(name, "Flatten", {"axis": axis, "end_axis": -1},
                                bots=[bot], tops=[name]))
        return name

    def reshape(self, name: str, bot: str, shape: list[int]) -> str:
        self.pipe.add_op(ConvOp(name, "Reshape", {"shape": list(shape)},
                                bots=[bot], tops=[name]))
        return name

    def normalize(self, name: str, bot: str, chans: int, scale: float = 20.0) -> str:
        """SSD's conv4_3 L2 Normalize with a learned per-channel scale."""
        self.pipe.weights[f"{name}__scales"] = NDA(
            Dims.of(out_chan=chans), np.full(chans, scale, dtype=np.float32))
        self.pipe.add_op(ConvOp(name, "Normalize", {"across_spatial": False, "eps": 1e-10},
                                bots=[bot, f"{name}__scales"], tops=[name]))
        return name

    def priorbox(self, name: str, feat: str, data: str, min_sizes, max_sizes,
                 aspect_ratios, flip: bool = True, clip: bool = False,
                 variance=(0.1, 0.1, 0.2, 0.2), step: float = 0) -> str:
        self.pipe.add_op(ConvOp(name, "PriorBox", {
            "min_sizes": list(min_sizes), "max_sizes": list(max_sizes),
            "aspect_ratios": list(aspect_ratios), "flip": flip, "clip": clip,
            "variance": list(variance), "step": step, "step_h": 0.0, "step_w": 0.0,
            "offset": 0.5}, bots=[feat, data], tops=[name]))
        return name

    def detection_output(self, name: str, loc: str, conf: str, priors: str,
                         num_classes: int, nms_threshold: float = 0.45,
                         top_k: int = 400, keep_top_k: int = 200,
                         confidence_threshold: float = 0.01) -> str:
        self.pipe.add_op(ConvOp(name, "DetectionOutput", {
            "num_classes": num_classes, "share_location": True,
            "background_label_id": 0, "nms_threshold": nms_threshold,
            "top_k": top_k, "code_type": "CENTER_SIZE", "keep_top_k": keep_top_k,
            "confidence_threshold": confidence_threshold},
            bots=[loc, conf, priors], tops=[name]))
        return name

    def softmax_axis(self, name: str, bot: str, axis: int) -> str:
        self.pipe.add_op(ConvOp(name, "Softmax", {"axis": axis}, bots=[bot], tops=[name]))
        return name

    def eltwise(self, name: str, bots: list[str], op="sum", relu=False) -> str:
        self.pipe.add_op(ConvOp(name, "Eltwise", {"eltwise_op": op},
                                bots=list(bots), tops=[name]))
        return self.relu(f"{name}_relu", name) if relu else name

    def bn_scale(self, name: str, bot: str, chans: int) -> str:
        """Caffe-style BatchNorm (stats blobs) + Scale (learned affine)."""
        rng = np.random.RandomState((self.seed + stable_hash(name)) % (2 ** 31))
        self.pipe.weights[f"{name}__means"] = NDA(
            Dims.of(out_chan=chans), rng.randn(chans).astype(np.float32) * 0.1)
        self.pipe.weights[f"{name}__vars"] = NDA(
            Dims.of(out_chan=chans), (1 + 0.1 * rng.rand(chans)).astype(np.float32))
        self.pipe.weights[f"{name}__sf"] = NDA(
            Dims.of(out_chan=1), np.ones(1, dtype=np.float32))
        self.pipe.add_op(ConvOp(name, "BatchNorm", {},
                                bots=[bot, f"{name}__means", f"{name}__vars",
                                      f"{name}__sf"],
                                tops=[name]))
        sname = f"{name}_scale"
        self.pipe.weights[f"{sname}__scales"] = NDA(
            Dims.of(out_chan=chans), (1 + 0.1 * rng.rand(chans)).astype(np.float32))
        self.pipe.weights[f"{sname}__biases"] = NDA(
            Dims.of(out_chan=chans), (0.1 * rng.randn(chans)).astype(np.float32))
        self.pipe.add_op(ConvOp(sname, "Scale", {},
                                bots=[name, f"{sname}__scales", f"{sname}__biases"],
                                tops=[sname]))
        return sname

    def done(self, in_dims: dict[str, Dims]) -> ConvPipe:
        self.pipe.calc_dims(in_dims)
        self.pipe.calc_support_info()
        return self.pipe


# -- model builders ------------------------------------------------------------------
# each returns (pipe, in_dims) for a given batch size

def build_alexnet_ng_conv(img: int = 1, num_cls: int = 1000, in_sz: int = 227):
    """AlexNet, no-groups variant (ref nets/alexnet_ng_conv)."""
    b = NetBuilder("alexnet_ng_conv")
    d = b.input("data")
    t = b.conv("conv1", d, 96, 11, stride=4, in_chans=3, relu=True)
    t = b.lrn("norm1", t)
    t = b.pool("pool1", t, kern=3, stride=2)
    t = b.conv("conv2", t, 256, 5, pad=2, in_chans=96, relu=True)
    t = b.lrn("norm2", t)
    t = b.pool("pool2", t, kern=3, stride=2)
    t = b.conv("conv3", t, 384, 3, pad=1, in_chans=256, relu=True)
    t = b.conv("conv4", t, 384, 3, pad=1, in_chans=384, relu=True)
    t = b.conv("conv5", t, 256, 3, pad=1, in_chans=384, relu=True)
    t = b.pool("pool5", t, kern=3, stride=2)
    t = b.fc("fc6", t, 4096, in_feats=256 * 6 * 6, relu=True)
    t = b.dropout("drop6", t)
    t = b.fc("fc7", t, 4096, in_feats=4096, relu=True)
    t = b.dropout("drop7", t)
    t = b.fc("fc8", t, num_cls, in_feats=4096)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_nin_imagenet(img: int = 1, num_cls: int = 1000, in_sz: int = 227):
    """Network-in-Network (ref nets/nin_imagenet): convs + 1x1 "cccp" convs."""
    b = NetBuilder("nin_imagenet")
    d = b.input("data")
    t = b.conv("conv1", d, 96, 11, stride=4, in_chans=3, relu=True)
    t = b.conv("cccp1", t, 96, 1, in_chans=96, relu=True)
    t = b.conv("cccp2", t, 96, 1, in_chans=96, relu=True)
    t = b.pool("pool1", t, kern=3, stride=2)
    t = b.conv("conv2", t, 256, 5, pad=2, in_chans=96, relu=True)
    t = b.conv("cccp3", t, 256, 1, in_chans=256, relu=True)
    t = b.conv("cccp4", t, 256, 1, in_chans=256, relu=True)
    t = b.pool("pool2", t, kern=3, stride=2)
    t = b.conv("conv3", t, 384, 3, pad=1, in_chans=256, relu=True)
    t = b.conv("cccp5", t, 384, 1, in_chans=384, relu=True)
    t = b.conv("cccp6", t, 384, 1, in_chans=384, relu=True)
    t = b.pool("pool3", t, kern=3, stride=2)
    t = b.dropout("drop", t)
    t = b.conv("conv4-1024", t, 1024, 3, pad=1, in_chans=384, relu=True)
    t = b.conv("cccp7-1024", t, 1024, 1, in_chans=1024, relu=True)
    t = b.conv("cccp8-1024", t, num_cls, 1, in_chans=1024, relu=True)
    t = b.pool("pool4", t, kern=6, stride=1, avg=True, global_pool=True)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_googlenet_conv(img: int = 1, num_cls: int = 1000, in_sz: int = 224):
    """GoogLeNet v1, conv trunk + single classifier head (ref nets/googlenet_conv)."""
    b = NetBuilder("googlenet_conv")
    d = b.input("data")
    t = b.conv("conv1/7x7_s2", d, 64, 7, stride=2, pad=3, in_chans=3, relu=True)
    t = b.pool("pool1/3x3_s2", t, kern=3, stride=2)
    t = b.lrn("pool1/norm1", t)
    t = b.conv("conv2/3x3_reduce", t, 64, 1, in_chans=64, relu=True)
    t = b.conv("conv2/3x3", t, 192, 3, pad=1, in_chans=64, relu=True)
    t = b.lrn("conv2/norm2", t)
    t = b.pool("pool2/3x3_s2", t, kern=3, stride=2)

    def inception(tag, bot, in_c, c1, c3r, c3, c5r, c5, cp):
        p1 = b.conv(f"{tag}/1x1", bot, c1, 1, in_chans=in_c, relu=True)
        p2 = b.conv(f"{tag}/3x3_reduce", bot, c3r, 1, in_chans=in_c, relu=True)
        p2 = b.conv(f"{tag}/3x3", p2, c3, 3, pad=1, in_chans=c3r, relu=True)
        p3 = b.conv(f"{tag}/5x5_reduce", bot, c5r, 1, in_chans=in_c, relu=True)
        p3 = b.conv(f"{tag}/5x5", p3, c5, 5, pad=2, in_chans=c5r, relu=True)
        p4 = b.pool(f"{tag}/pool", bot, kern=3, stride=1, pad=1)
        p4 = b.conv(f"{tag}/pool_proj", p4, cp, 1, in_chans=in_c, relu=True)
        return b.concat(f"{tag}/output", [p1, p2, p3, p4]), c1 + c3 + c5 + cp

    t, c = inception("inception_3a", t, 192, 64, 96, 128, 16, 32, 32)
    t, c = inception("inception_3b", t, c, 128, 128, 192, 32, 96, 64)
    t = b.pool("pool3/3x3_s2", t, kern=3, stride=2)
    t, c = inception("inception_4a", t, c, 192, 96, 208, 16, 48, 64)
    t, c = inception("inception_4b", t, c, 160, 112, 224, 24, 64, 64)
    t, c = inception("inception_4c", t, c, 128, 128, 256, 24, 64, 64)
    t, c = inception("inception_4d", t, c, 112, 144, 288, 32, 64, 64)
    t, c = inception("inception_4e", t, c, 256, 160, 320, 32, 128, 128)
    t = b.pool("pool4/3x3_s2", t, kern=3, stride=2)
    t, c = inception("inception_5a", t, c, 256, 160, 320, 32, 128, 128)
    t, c = inception("inception_5b", t, c, 384, 192, 384, 48, 128, 128)
    t = b.pool("pool5/7x7_s1", t, kern=7, stride=1, avg=True, global_pool=True)
    t = b.dropout("pool5/drop_7x7_s1", t, ratio=0.4)
    t = b.fc("loss3/classifier", t, num_cls, in_feats=c)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_vgg(depth: int = 16, img: int = 1, num_cls: int = 1000, in_sz: int = 224):
    """VGG-16/19 (ref nets/VGG_ILSVRC_16/19)."""
    cfg = {
        16: [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)],
        19: [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)],
    }[depth]
    b = NetBuilder(f"vgg{depth}")
    t = b.input("data")
    in_c = 3
    for bi, (c, reps) in enumerate(cfg, start=1):
        for ri in range(1, reps + 1):
            t = b.conv(f"conv{bi}_{ri}", t, c, 3, pad=1, in_chans=in_c, relu=True)
            in_c = c
        t = b.pool(f"pool{bi}", t, kern=2, stride=2)
    t = b.fc("fc6", t, 4096, in_feats=512 * (in_sz // 32) ** 2, relu=True)
    t = b.dropout("drop6", t)
    t = b.fc("fc7", t, 4096, in_feats=4096, relu=True)
    t = b.dropout("drop7", t)
    t = b.fc("fc8", t, num_cls, in_feats=4096)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_resnet(depth: int = 50, img: int = 1, num_cls: int = 1000,
                 in_sz: int = 224):
    """ResNet-50/101/152 (ref nets/ResNet-50/101/152; Caffe BN+Scale form)."""
    blocks = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}[depth]
    b = NetBuilder(f"resnet{depth}")
    t = b.input("data")
    t = b.conv("conv1", t, 64, 7, stride=2, pad=3, in_chans=3)
    t = b.bn_scale("bn_conv1", t, 64)
    t = b.relu("conv1_relu", t)
    t = b.pool("pool1", t, kern=3, stride=2)
    in_c = 64
    for stage, (n_blocks, width) in enumerate(zip(blocks, (64, 128, 256, 512)),
                                              start=2):
        for bi in range(n_blocks):
            tag = f"res{stage}{chr(ord('a') + bi)}"
            stride = 2 if (bi == 0 and stage > 2) else 1
            # shortcut
            if bi == 0:
                sc = b.conv(f"{tag}_branch1", t, width * 4, 1, stride=stride,
                            in_chans=in_c)
                sc = b.bn_scale(f"bn{tag[3:]}_branch1", sc, width * 4)
            else:
                sc = t
            # bottleneck: 1x1 -> 3x3 -> 1x1
            u = b.conv(f"{tag}_branch2a", t, width, 1, stride=stride, in_chans=in_c)
            u = b.bn_scale(f"bn{tag[3:]}_branch2a", u, width)
            u = b.relu(f"{tag}_branch2a_relu", u)
            u = b.conv(f"{tag}_branch2b", u, width, 3, pad=1, in_chans=width)
            u = b.bn_scale(f"bn{tag[3:]}_branch2b", u, width)
            u = b.relu(f"{tag}_branch2b_relu", u)
            u = b.conv(f"{tag}_branch2c", u, width * 4, 1, in_chans=width)
            u = b.bn_scale(f"bn{tag[3:]}_branch2c", u, width * 4)
            t = b.eltwise(tag, [sc, u], relu=True)
            in_c = width * 4
    t = b.pool("pool5", t, kern=7, stride=1, avg=True, global_pool=True)
    t = b.fc(f"fc{num_cls}", t, num_cls, in_feats=2048)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_squeezenet(img: int = 1, num_cls: int = 1000, in_sz: int = 227):
    """SqueezeNet 1.0 (ref nets/squeezenet_v1.0)."""
    b = NetBuilder("squeezenet")
    t = b.input("data")
    t = b.conv("conv1", t, 96, 7, stride=2, in_chans=3, relu=True)
    t = b.pool("pool1", t, kern=3, stride=2)

    def fire(tag, bot, in_c, sq, e1, e3):
        s = b.conv(f"{tag}/squeeze1x1", bot, sq, 1, in_chans=in_c, relu=True)
        a = b.conv(f"{tag}/expand1x1", s, e1, 1, in_chans=sq, relu=True)
        c = b.conv(f"{tag}/expand3x3", s, e3, 3, pad=1, in_chans=sq, relu=True)
        return b.concat(f"{tag}/concat", [a, c]), e1 + e3

    t, c = fire("fire2", t, 96, 16, 64, 64)
    t, c = fire("fire3", t, c, 16, 64, 64)
    t, c = fire("fire4", t, c, 32, 128, 128)
    t = b.pool("pool4", t, kern=3, stride=2)
    t, c = fire("fire5", t, c, 32, 128, 128)
    t, c = fire("fire6", t, c, 48, 192, 192)
    t, c = fire("fire7", t, c, 48, 192, 192)
    t, c = fire("fire8", t, c, 64, 256, 256)
    t = b.pool("pool8", t, kern=3, stride=2)
    t, c = fire("fire9", t, c, 64, 256, 256)
    t = b.dropout("drop9", t)
    t = b.conv("conv10", t, num_cls, 1, in_chans=c, relu=True)
    t = b.pool("pool10", t, avg=True, global_pool=True)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_mini_resnet(img: int = 4, num_cls: int = 16, in_sz: int = 32,
                      widths=(16, 32, 64), reps: int = 2):
    """Small BN+eltwise residual net for fast tests and multi-chip dryruns
    (not a reference model; structure mirrors the ResNet builders)."""
    b = NetBuilder("mini_resnet")
    t = b.input("data")
    t = b.conv("conv1", t, widths[0], 3, pad=1, in_chans=3)
    t = b.bn_scale("bn1", t, widths[0])
    t = b.relu("relu1", t)
    in_c = widths[0]
    for stage, w in enumerate(widths, start=1):
        for r in range(reps):
            tag = f"s{stage}b{r}"
            stride = 2 if (r == 0 and stage > 1) else 1
            if in_c != w or stride != 1:
                sc = b.conv(f"{tag}_sc", t, w, 1, stride=stride, in_chans=in_c)
            else:
                sc = t
            u = b.conv(f"{tag}_c1", t, w, 3, stride=stride, pad=1, in_chans=in_c)
            u = b.bn_scale(f"{tag}_bn1", u, w)
            u = b.relu(f"{tag}_r1", u)
            u = b.conv(f"{tag}_c2", u, w, 3, pad=1, in_chans=w)
            t = b.eltwise(tag, [sc, u], relu=True)
            in_c = w
    t = b.pool("gap", t, avg=True, global_pool=True)
    t = b.fc("fc", t, num_cls, in_feats=in_c)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_firenet(img: int = 1, num_cls: int = 1000, in_sz: int = 227,
                  n_fire: int = 8):
    """FireNet-N (ref nets/firenet*): squeezenet-style fire stack with
    periodic pooling; the reference's small detection-oriented conv net."""
    b = NetBuilder("firenet")
    t = b.input("data")
    t = b.conv("conv1", t, 64, 3, stride=2, in_chans=3, relu=True)
    c = 64
    for i in range(2, 2 + n_fire):
        sq, e1, e3 = 16 * ((i // 2) + 1), 64 * ((i // 2) + 1), 64 * ((i // 2) + 1)
        s_ = b.conv(f"fire{i}/squeeze1x1", t, sq, 1, in_chans=c, relu=True)
        a = b.conv(f"fire{i}/expand1x1", s_, e1, 1, in_chans=sq, relu=True)
        d = b.conv(f"fire{i}/expand3x3", s_, e3, 3, pad=1, in_chans=sq, relu=True)
        t = b.concat(f"fire{i}/concat", [a, d])
        c = e1 + e3
        if i % 3 == 0:
            t = b.pool(f"pool{i}", t, kern=3, stride=2)
    t = b.conv("conv_final", t, num_cls, 1, in_chans=c, relu=True)
    t = b.pool("pool_final", t, avg=True, global_pool=True)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_bconv_strides(img: int = 2, num_cls: int = 8, in_sz: int = 24):
    """Strided-conv backward regression net — the bconv_strides analog of
    the reference's gradient configs (ref src/test_compute.cc:219-232,
    test/rtc/bconv.cucl test strided BckConv variants): every conv is
    strided (3x3 s2, 1x1 s2, 5x5 s3) so add_bck_ops exercises the strided
    dgrad/wgrad paths (none is eligible for the hand backward kernels, so
    every conv's backward is the autograd of its library lowering)."""
    b = NetBuilder("bconv_strides")
    t = b.input("data")
    t = b.conv("conv1", t, 8, 3, stride=2, pad=1, in_chans=3, relu=True)
    t = b.conv("conv2", t, 12, 1, stride=2, in_chans=8, relu=True)
    t = b.conv("conv3", t, 16, 5, stride=3, pad=2, in_chans=12, relu=True)
    t = b.pool("pool3", t, kern=2, stride=2)
    t = b.fc("fc1", t, num_cls, in_feats=16)
    b.softmax("prob", t)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


def build_ssd300(img: int = 1, num_cls: int = 21, in_sz: int = 300):
    """SSD300: the VGG-16 trunk, SSD's multi-scale heads and the fixed-shape
    NMS head (canonical SSD300-VOC geometry). Sources conv4_3 (38x38, L2
    Normalize at scale 20), fc7 (19), conv6_2 (10), conv7_2 (5), conv8_2
    (3) and conv9_2 (1) with 4/6/6/6/4/4 priors per location: 8,732
    priors. fc6 is dilated 6, so it takes the library conv."""
    b = NetBuilder("ssd300")
    d = b.input("data")
    t = b.conv("conv1_1", d, 64, 3, pad=1, in_chans=3, relu=True)
    t = b.conv("conv1_2", t, 64, 3, pad=1, in_chans=64, relu=True)
    t = b.pool("pool1", t, kern=2, stride=2)
    t = b.conv("conv2_1", t, 128, 3, pad=1, in_chans=64, relu=True)
    t = b.conv("conv2_2", t, 128, 3, pad=1, in_chans=128, relu=True)
    t = b.pool("pool2", t, kern=2, stride=2)
    t = b.conv("conv3_1", t, 256, 3, pad=1, in_chans=128, relu=True)
    t = b.conv("conv3_2", t, 256, 3, pad=1, in_chans=256, relu=True)
    t = b.conv("conv3_3", t, 256, 3, pad=1, in_chans=256, relu=True)
    t = b.pool("pool3", t, kern=2, stride=2)  # 38x38 (ceil)
    t = b.conv("conv4_1", t, 512, 3, pad=1, in_chans=256, relu=True)
    t = b.conv("conv4_2", t, 512, 3, pad=1, in_chans=512, relu=True)
    c43 = b.conv("conv4_3", t, 512, 3, pad=1, in_chans=512, relu=True)
    t = b.pool("pool4", c43, kern=2, stride=2)
    t = b.conv("conv5_1", t, 512, 3, pad=1, in_chans=512, relu=True)
    t = b.conv("conv5_2", t, 512, 3, pad=1, in_chans=512, relu=True)
    t = b.conv("conv5_3", t, 512, 3, pad=1, in_chans=512, relu=True)
    t = b.pool("pool5", t, kern=3, stride=1, pad=1)  # keeps 19x19
    t = b.conv("fc6", t, 1024, 3, pad=6, dilation=6, in_chans=512, relu=True)
    fc7 = b.conv("fc7", t, 1024, 1, in_chans=1024, relu=True)
    t = b.conv("conv6_1", fc7, 256, 1, in_chans=1024, relu=True)
    c62 = b.conv("conv6_2", t, 512, 3, stride=2, pad=1, in_chans=256, relu=True)
    t = b.conv("conv7_1", c62, 128, 1, in_chans=512, relu=True)
    c72 = b.conv("conv7_2", t, 256, 3, stride=2, pad=1, in_chans=128, relu=True)
    t = b.conv("conv8_1", c72, 128, 1, in_chans=256, relu=True)
    c82 = b.conv("conv8_2", t, 256, 3, in_chans=128, relu=True)  # 3x3
    t = b.conv("conv9_1", c82, 128, 1, in_chans=256, relu=True)
    c92 = b.conv("conv9_2", t, 256, 3, in_chans=128, relu=True)  # 1x1

    n43 = b.normalize("conv4_3_norm", c43, 512, scale=20.0)
    # (source, in_chans, priors per location, min, max, aspect ratios)
    srcs = [(n43, 512, 4, 30.0, 60.0, [2.0]),
            (fc7, 1024, 6, 60.0, 111.0, [2.0, 3.0]),
            (c62, 512, 6, 111.0, 162.0, [2.0, 3.0]),
            (c72, 256, 6, 162.0, 213.0, [2.0, 3.0]),
            (c82, 256, 4, 213.0, 264.0, [2.0]),
            (c92, 256, 4, 264.0, 315.0, [2.0])]
    locs, confs, priors = [], [], []
    for src, in_c, np_l, mn, mx, ars in srcs:
        tag = src.replace("_relu", "")
        lc = b.conv(f"{tag}_mbox_loc", src, np_l * 4, 3, pad=1, in_chans=in_c)
        lc = b.permute(f"{tag}_mbox_loc_perm", lc, [0, 2, 3, 1])
        locs.append(b.flatten(f"{tag}_mbox_loc_flat", lc))
        cf = b.conv(f"{tag}_mbox_conf", src, np_l * num_cls, 3, pad=1, in_chans=in_c)
        cf = b.permute(f"{tag}_mbox_conf_perm", cf, [0, 2, 3, 1])
        confs.append(b.flatten(f"{tag}_mbox_conf_flat", cf))
        priors.append(b.priorbox(f"{tag}_mbox_priorbox", src, d, [mn], [mx], ars))
    loc = b.concat("mbox_loc", locs, axis=1)
    conf = b.concat("mbox_conf", confs, axis=1)
    pri = b.concat("mbox_priorbox", priors, axis=2)
    cf = b.reshape("mbox_conf_reshape", conf, [0, -1, num_cls])
    cf = b.softmax_axis("mbox_conf_softmax", cf, axis=2)
    cf = b.flatten("mbox_conf_flatten", cf)
    b.detection_output("detection_out", loc, cf, pri, num_classes=num_cls)
    in_dims = {"data": Dims.of(img=img, chan=3, y=in_sz, x=in_sz)}
    return b.done(in_dims), in_dims


MODELS = {
    "mini_resnet": build_mini_resnet,
    "bconv_strides": build_bconv_strides,
    "firenet": build_firenet,
    "alexnet_ng_conv": build_alexnet_ng_conv,
    "nin_imagenet": build_nin_imagenet,
    "googlenet_conv": build_googlenet_conv,
    "vgg16": lambda **kw: build_vgg(16, **kw),
    "vgg19": lambda **kw: build_vgg(19, **kw),
    "resnet50": lambda **kw: build_resnet(50, **kw),
    "resnet101": lambda **kw: build_resnet(101, **kw),
    "resnet152": lambda **kw: build_resnet(152, **kw),
    "squeezenet": build_squeezenet,
    "ssd300": build_ssd300,
}


def build_model(name: str, **kw):
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](**kw)
