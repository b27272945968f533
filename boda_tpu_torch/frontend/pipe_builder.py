"""Caffe NetParameter -> ConvPipe: the model frontend.

Counterpart of ``boda_tpu/frontend/pipe_builder.py``, copied (pure Python
and numpy) onto the port's ConvPipe, with the same seeded weights, so a
prototxt without a caffemodel gives both packages the same arrays. Layer
types whose op rules the port does not have yet (:data:`NOT_PORTED`) raise
``PipeError`` naming the ROADMAP item that brings them.

Parity target: ``create_pipe_from_param`` (ref src/caffepb.cc:166) + the
legacy-format upgrade behavior (ref src/ext/upgrade_proto.cpp): accepts both
``layer`` (new) and ``layers`` (V1, enum types) lists, ``input``/``input_dim``
/``input_shape`` and Input layers, in-place layers (top==bottom), and
attaches weights from a .caffemodel (ref copy_matching_layer_blobs,
caffepb.cc:583-603) or deterministic seeded init when absent.
"""

from __future__ import annotations

import numpy as np

from ..graph.pipe import OP_INFOS, ConvOp, ConvPipe, PipeError
from ..utils.dims import NDA, Dims, stable_hash
from .textproto import get1, getl, parse_textproto_file


class FrontendError(PipeError):
    pass


# Caffe layer types without an op rule in the port yet -> the ROADMAP item
# that brings them
NOT_PORTED = dict.fromkeys(("Deconvolution", "Sigmoid", "TanH", "Reduce"),
                           "ROADMAP §1 item 4, the remaining NHWC rules")
NOT_PORTED.update(dict.fromkeys(("Permute", "Flatten", "Reshape", "Normalize",
                                 "PriorBox", "DetectionOutput"),
                                "ROADMAP §1 item 6, the SSD head"))


def _pair_param(msg: dict, base: str, default: int) -> tuple[int, int]:
    """Caffe geometry params: repeated ``kernel_size`` or ``kernel_h/_w``."""
    vs = getl(msg, base)
    h = get1(msg, base + "_h")
    w = get1(msg, base + "_w")
    if h is not None or w is not None:
        return (int(h if h is not None else default),
                int(w if w is not None else default))
    if not vs:
        return (default, default)
    if len(vs) == 1:
        return (int(vs[0]), int(vs[0]))
    return (int(vs[0]), int(vs[1]))


_ELTWISE_OPS = {0: "prod", 1: "sum", 2: "max", "PROD": "prod", "SUM": "sum",
                "MAX": "max"}
_POOL_AVE = {1, "AVE"}
_SKIP_TYPES = {"Data", "AnnotatedData", "HDF5Data", "ImageData", "WindowData",
               "MemoryData", "DummyData", "Silence", "Python", "Input",
               "Accuracy", "DATA", "HDF5_DATA", "IMAGE_DATA", "WINDOW_DATA",
               "MEMORY_DATA", "SILENCE", "ACCURACY",
               "MultiBoxLoss"}  # loss-only layer, ignored like ref loss layers
_DATA_TYPES = {"Data", "AnnotatedData", "DATA", "ImageData", "IMAGE_DATA"}

_V1_NAME_MAP = {  # V1 enum identifier -> canonical type
    "CONVOLUTION": "Convolution", "DECONVOLUTION": "Deconvolution",
    "POOLING": "Pooling", "RELU": "ReLU", "SIGMOID": "Sigmoid", "TANH": "TanH",
    "DROPOUT": "Dropout", "LRN": "LRN", "SOFTMAX": "Softmax",
    "SOFTMAX_LOSS": "SoftmaxWithLoss", "CONCAT": "Concat", "ELTWISE": "Eltwise",
    "INNER_PRODUCT": "InnerProduct", "SPLIT": "Split", "SCALE": "Scale",
    "BATCHNORM": "BatchNorm",
}


def pipe_from_netparam(npm: dict, weights: dict | None = None, img: int = 0,
                       in_sz: int = 0, seed: int = 1234,
                       name: str = "net") -> tuple[ConvPipe, dict[str, Dims]]:
    pipe = ConvPipe(get1(npm, "name", name))
    weights = weights or {}
    in_dims: dict[str, Dims] = {}

    # -- inputs ------------------------------------------------------------------
    inputs = [_s(v) for v in getl(npm, "input")]
    idims = getl(npm, "input_dim")
    ishapes = getl(npm, "input_shape")
    for i, inp in enumerate(inputs):
        if ishapes:
            dims = [int(d) for d in getl(ishapes[i], "dim")]
        elif idims:
            dims = [int(d) for d in idims[i * 4:(i + 1) * 4]]
        else:
            raise FrontendError(f"input {inp!r} has no dims")
        in_dims[inp] = _act_dims(dims, img, in_sz)
        pipe.get_or_make_node(inp).dims = in_dims[inp]

    layers = getl(npm, "layer") or getl(npm, "layers")
    cur: dict[str, str] = {}  # caffe blob name -> current SSA node name
    rng_seed = seed

    # if every data layer is TRAIN-phase (e.g. ref nets/rrc/train_val), keep
    # it as the input source instead of filtering it with the TRAIN ops
    data_phases = [_layer_phase(lm) for lm in layers
                   if _V1_NAME_MAP.get(_s(get1(lm, "type", "")),
                                       _s(get1(lm, "type", ""))) in _DATA_TYPES]
    train_data_only = bool(data_phases) and all(p == "TRAIN" for p in data_phases)

    for lmsg in layers:
        lname = _s(get1(lmsg, "name", ""))
        ltype = _s(get1(lmsg, "type", ""))
        ltype = _V1_NAME_MAP.get(ltype, ltype)
        bots = [_s(b) for b in getl(lmsg, "bottom")]
        tops = [_s(t) for t in getl(lmsg, "top")]
        phase = _layer_phase(lmsg)
        if phase == "TRAIN" and not (train_data_only and ltype in _DATA_TYPES):
            continue
        if ltype == "Input":
            shape = getl(get1(lmsg, "input_param", {}), "shape")
            for i, t in enumerate(tops):
                dims = [int(d) for d in getl(shape[i], "dim")] if shape else None
                if dims is None:
                    raise FrontendError(f"Input layer {lname!r} has no shape")
                in_dims[t] = _act_dims(dims, img, in_sz)
                pipe.get_or_make_node(t).dims = in_dims[t]
            continue
        if ltype in _SKIP_TYPES:
            if ltype in _DATA_TYPES and tops and tops[0] not in in_dims:
                # synthesize the data input node from the data layer, like the
                # reference (ref caffepb.cc:280-304: dims from batch_size +
                # transform_param.crop_size, 3 chans, then in_dims override)
                dp = get1(lmsg, "data_param", {})
                tp = get1(lmsg, "transform_param", {})
                batch = int(get1(dp, "batch_size", 1))
                crop = int(get1(tp, "crop_size",
                                get1(dp, "crop_size", 0)))  # V0 kept it in dp
                cy = cx = crop
                if not crop:  # SSD-style nets size via transform resize_param
                    rp = get1(tp, "resize_param", {})
                    cy = int(get1(rp, "height", 0))
                    cx = int(get1(rp, "width", 0))
                if cy and cx:
                    d = _act_dims([batch, 3, cy, cx], img, in_sz)
                    in_dims[tops[0]] = d
                    pipe.get_or_make_node(tops[0]).dims = d
                    if len(tops) > 1:  # label node (ref data_label_node)
                        ld = Dims.of(img=d["img"], tn="float32")
                        in_dims[tops[1]] = ld
                        pipe.get_or_make_node(tops[1]).dims = ld
            for t in tops:  # data layers feed nodes that become net inputs
                if t not in cur and t not in in_dims and ltype not in \
                        ("Silence", "SILENCE", "Accuracy", "ACCURACY"):
                    pipe.get_or_make_node(t)
            continue

        mapped_bots = [cur.get(b, b) for b in bots]
        # in-place layers: top == bottom -> new SSA node name
        mapped_tops = []
        for t in tops:
            if t in bots:
                nt = f"{t}@{lname}"
                mapped_tops.append(nt)
                cur[t] = nt
            else:
                mapped_tops.append(t)
                cur[t] = t

        if ltype == "SoftmaxWithLoss" and len(mapped_tops) < 2:
            # caffe declares 0/1 tops for loss layers (ref caffepb.cc:262);
            # our op signature is tops=[loss, prob]
            if not mapped_tops:
                mapped_tops.append(f"{lname}__loss")
            mapped_tops.append(f"{lname}__prob")

        op, wblobs = _make_op(pipe, lname, ltype, lmsg, mapped_bots, mapped_tops)
        # attach weights (stored caffemodel blobs or deterministic init)
        lw = weights.get(lname, [])
        for wi, (wname, wshaper) in enumerate(wblobs):
            if wi < len(lw):
                blob = lw[wi]
                data = np.asarray(blob.data, dtype=np.float32)
                nda = wshaper(data)
            else:  # boda_tpu's deterministic init
                nda = wshaper(None, seed=(rng_seed + wi + stable_hash(lname)) % 2 ** 31)
            pipe.weights[wname] = nda
            pipe.get_or_make_node(wname).dims = nda.dims
            op.bots.append(wname)
        pipe.add_op(op)
        pipe.infer_op_dims(op.name)  # incremental: later layers read these dims

    if not in_dims:
        raise FrontendError("net has no inputs (no input:/Input layer found)")
    pipe.calc_dims(in_dims)
    pipe.calc_support_info()
    return pipe, in_dims


def _act_dims(dims: list[int], img: int, in_sz: int) -> Dims:
    if len(dims) == 4:
        n, c, h, w = dims
        if img:
            n = img
        if in_sz:
            h = w = in_sz
        return Dims.of(img=n, chan=c, y=h, x=w)
    if len(dims) == 2:
        return Dims.of(img=img or dims[0], chan=dims[1])
    raise FrontendError(f"unsupported input rank {dims}")


def _s(v) -> str:
    return v if isinstance(v, str) else str(v)


def _layer_phase(lmsg: dict) -> str:
    for inc in getl(lmsg, "include"):
        ph = get1(inc, "phase")
        if ph is not None:
            return _s(ph)
    return ""


def _winit_shaper(dims: Dims, fan_in: int):
    def shaper(data, seed: int = 0):
        if data is None:
            rng = np.random.RandomState(seed % (2 ** 31))
            std = np.sqrt(2.0 / max(fan_in, 1))
            data = (rng.randn(*dims.shape) * std).astype(np.float32)
        return NDA(dims, np.asarray(data, np.float32).reshape(dims.shape))
    shaper.dims = dims
    return shaper


def _zero_shaper(dims: Dims):
    def shaper(data, seed: int = 0):
        if data is None:
            data = np.zeros(dims.shape, np.float32)
        return NDA(dims, np.asarray(data, np.float32).reshape(dims.shape))
    shaper.dims = dims
    return shaper


def _const_shaper(dims: Dims, value: float):
    def shaper(data, seed: int = 0):
        if data is None:
            data = np.full(dims.shape, value, np.float32)
        return NDA(dims, np.asarray(data, np.float32).reshape(dims.shape))
    shaper.dims = dims
    return shaper


def _make_op(pipe: ConvPipe, lname: str, ltype: str, lmsg: dict,
             bots: list[str], tops: list[str]):
    """Build the ConvOp (+ the list of (weight node name, shaper))."""
    if ltype in NOT_PORTED:
        raise PipeError(f"layer {lname!r}: type {ltype!r} has no op rule in "
                        f"boda_tpu_torch yet ({NOT_PORTED[ltype]})")
    wblobs: list[tuple[str, object]] = []
    params: dict = {}
    if ltype == "Convolution":
        cp = get1(lmsg, "convolution_param", {})
        oc = int(get1(cp, "num_output", 0))
        k = _pair_param(cp, "kernel_size", 1)
        # kernel_h/w override
        kh, kw = get1(cp, "kernel_h"), get1(cp, "kernel_w")
        if kh is not None:
            k = (int(kh), int(kw))
        s = _pair_param(cp, "stride", 1)
        p = _pair_param(cp, "pad", 0)
        g = int(get1(cp, "group", 1))
        d = _pair_param(cp, "dilation", 1)
        params = {"kern_sz": k, "stride": s, "pad": p, "groups": g}
        if d != (1, 1):
            params["dilation"] = d
        if not get1(cp, "bias_term", True):
            params["no_bias"] = True
        in_c = _chan_of(pipe, bots[0])
        fd = Dims.of(out_chan=oc, in_chan=in_c // g, y=k[0], x=k[1])
        fan_in = (in_c // g) * k[0] * k[1]
        wblobs = [(f"{lname}__filts", _winit_shaper(fd, fan_in)),
                  (f"{lname}__biases", _zero_shaper(Dims.of(out_chan=oc)))]
    elif ltype == "InnerProduct":
        ipp = get1(lmsg, "inner_product_param", {})
        oc = int(get1(ipp, "num_output", 0))
        in_feats = _feats_of(pipe, bots[0])
        fd = Dims.of(out_chan=oc, in_feats=in_feats)
        wblobs = [(f"{lname}__filts", _winit_shaper(fd, in_feats)),
                  (f"{lname}__biases", _zero_shaper(Dims.of(out_chan=oc)))]
    elif ltype == "Pooling":
        pp = get1(lmsg, "pooling_param", {})
        k = _pair_param(pp, "kernel_size", 1)
        s = _pair_param(pp, "stride", 1)
        p = _pair_param(pp, "pad", 0)
        params = {"kern_sz": k, "stride": s, "pad": p,
                  "avg_pool": get1(pp, "pool", 0) in _POOL_AVE,
                  "global_pooling": bool(get1(pp, "global_pooling", False))}
    elif ltype == "LRN":
        lp = get1(lmsg, "lrn_param", {})
        params = {"local_size": int(get1(lp, "local_size", 5)),
                  "alpha": float(get1(lp, "alpha", 1.0)),
                  "beta": float(get1(lp, "beta", 0.75)),
                  "k": float(get1(lp, "k", 1.0))}
    elif ltype == "Dropout":
        dp = get1(lmsg, "dropout_param", {})
        params = {"dropout_ratio": float(get1(dp, "dropout_ratio", 0.5))}
    elif ltype == "Concat":
        cp = get1(lmsg, "concat_param", {})
        axis = int(get1(cp, "axis", get1(cp, "concat_dim", 1)))
        params = {"axis": axis}
    elif ltype == "Eltwise":
        ep = get1(lmsg, "eltwise_param", {})
        op_v = get1(ep, "operation", "SUM")
        params = {"eltwise_op": _ELTWISE_OPS.get(op_v, "sum"),
                  "coeffs": [float(c) for c in getl(ep, "coeff")] or None}
    elif ltype == "BatchNorm":
        bp = get1(lmsg, "batch_norm_param", {})
        params = {"eps": float(get1(bp, "eps", 1e-5))}
        c = _chan_of(pipe, bots[0])
        wblobs = [(f"{lname}__means", _zero_shaper(Dims.of(out_chan=c))),
                  (f"{lname}__vars", _ones_shaper(Dims.of(out_chan=c))),
                  (f"{lname}__sf", _ones_shaper(Dims.of(out_chan=1)))]
    elif ltype == "Scale":
        sp = get1(lmsg, "scale_param", {})
        c = _chan_of(pipe, bots[0])
        wblobs = [(f"{lname}__scales", _ones_shaper(Dims.of(out_chan=c)))]
        if get1(sp, "bias_term", False):
            wblobs.append((f"{lname}__biases", _zero_shaper(Dims.of(out_chan=c))))
    elif ltype == "Softmax":
        sp = get1(lmsg, "softmax_param", {})
        params = {"axis": int(get1(sp, "axis", 1))}
    elif ltype in ("ReLU", "Split", "SoftmaxWithLoss"):
        params = {}
    else:
        raise FrontendError(f"layer {lname!r}: unsupported type {ltype!r} "
                            f"(supported: {sorted(OP_INFOS)})")
    return ConvOp(lname, ltype, params, bots=bots, tops=tops), wblobs


def _ones_shaper(dims: Dims):
    def shaper(data, seed: int = 0):
        if data is None:
            data = np.ones(dims.shape, np.float32)
        return NDA(dims, np.asarray(data, np.float32).reshape(dims.shape))
    shaper.dims = dims
    return shaper


def _chan_of(pipe: ConvPipe, node: str) -> int:
    n = pipe.nodes.get(node)
    if n is None or n.dims is None:
        raise FrontendError(f"bottom node {node!r} has no dims yet "
                            f"(is the net topologically ordered?)")
    return n.dims["chan"]


def _feats_of(pipe: ConvPipe, node: str) -> int:
    n = pipe.nodes.get(node)
    if n is None or n.dims is None:
        raise FrontendError(f"bottom node {node!r} has no dims yet "
                            f"(is the net topologically ordered?)")
    return n.dims.num_elems() // n.dims["img"]


def pipe_from_prototxt(ptt_fn: str, weights_fn: str = "", img: int = 0,
                       in_sz: int = 0, seed: int = 1234):
    npm = parse_textproto_file(ptt_fn)
    weights = None
    if weights_fn:
        from .caffemodel import read_caffemodel
        weights = read_caffemodel(weights_fn)
    return pipe_from_netparam(npm, weights, img=img, in_sz=in_sz, seed=seed)
