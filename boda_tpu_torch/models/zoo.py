"""Programmatic net zoo: the models the reference ships as prototxt.

Counterpart of ``boda_tpu/models/zoo.py``: graph builders emitting the
ConvPipe IR with deterministic pseudo-random weights, seeded per layer from
``stable_hash`` of the weight name exactly as ``boda_tpu`` seeds them, so the
two packages build bit-identical weights: alexnet_ng_conv, nin_imagenet,
googlenet_conv, VGG-16/19, ResNet-50/101/152, squeezenet, firenet, and the
gradient regression net ``bconv_strides``. ``ssd300`` comes with the SSD
head's op rules (Permute, Flatten, Reshape, Normalize, PriorBox,
DetectionOutput).
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
}


def build_model(name: str, **kw):
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](**kw)
