"""Programmatic net zoo: the ResNet builders of the slice.

Counterpart of ``boda_tpu/models/zoo.py``: graph builders emitting the
ConvPipe IR with deterministic pseudo-random weights, seeded per layer from
``stable_hash`` of the weight name exactly as ``boda_tpu`` seeds them, so the
two packages build bit-identical weights. Besides ResNet, the gradient
regression net ``bconv_strides``. The other zoo builders (alexnet,
NiN, googlenet, VGG, squeezenet, firenet, ssd300, ...) come with the op rules
they need (LRN, Concat, the SSD head).
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

    def softmax(self, name: str, bot: str) -> str:
        self.pipe.add_op(ConvOp(name, "Softmax", {}, bots=[bot], tops=[name]))
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
    "bconv_strides": build_bconv_strides,
    "mini_resnet": build_mini_resnet,
    "resnet50": lambda **kw: build_resnet(50, **kw),
    "resnet101": lambda **kw: build_resnet(101, **kw),
    "resnet152": lambda **kw: build_resnet(152, **kw),
}


def build_model(name: str, **kw):
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; have {sorted(MODELS)}")
    return MODELS[name](**kw)
