"""Net surgery: fc->conv conversion, conv filter resizing, net writing.

Counterpart of ``boda_tpu/frontend/surgery.py``, copied: pure Python and
numpy on the port's ConvPipe, so both packages write the same prototxt text
and the same caffemodel bytes for the same pipe.

Parity targets (ref src/caffepb.cc): ``cnet_fc_to_conv`` (:887 — InnerProduct
-> Convolution with reshaped weights, making the net fully convolutional for
dense multi-scale evaluation), ``cnet_resize_conv`` (:823 + filter resampling
:647-708), ``cnet_copy`` (:780 — read+rewrite prototxt/caffemodel).
"""

from __future__ import annotations

import numpy as np

from ..graph.pipe import ConvOp, ConvPipe
from ..utils.dims import NDA, Dims


def fc_to_conv(pipe: ConvPipe) -> list[str]:
    """Convert every InnerProduct with a 4D bottom into an equivalent
    Convolution (kern = bottom spatial size); later IPs become 1x1 convs.
    Returns the converted op names. Re-run calc_dims after."""
    converted = []
    for op_name in pipe.topo_op_order():
        op = pipe.ops[op_name]
        if op.type != "InnerProduct":
            continue
        bot_dims = pipe.must_dims(op.bots[0])
        w = pipe.weights[op.bots[1]]
        oc = w.dims["out_chan"]
        if "y" in bot_dims.names:
            c, ky, kx = bot_dims["chan"], bot_dims["y"], bot_dims["x"]
        else:
            c, ky, kx = bot_dims["chan"], 1, 1
        new_wd = Dims.of(out_chan=oc, in_chan=c, y=ky, x=kx, tn=w.dims.tn)
        pipe.weights[op.bots[1]] = NDA(new_wd, w.data.reshape(new_wd.shape))
        pipe.nodes[op.bots[1]].dims = new_wd
        op.type = "Convolution"
        op.params = {"kern_sz": (ky, kx), "stride": (1, 1), "pad": (0, 0),
                     "groups": 1}
        converted.append(op_name)
    # downstream nodes become 4D (img, chan, 1, 1): recompute all dims from
    # the inputs
    in_dims = {n: pipe.nodes[n].dims for n in pipe.bots()
               if pipe.nodes[n].dims is not None}
    for node in pipe.nodes.values():
        if node.name not in in_dims and node.name not in pipe.weights:
            node.dims = None
    for w, nda in pipe.weights.items():
        pipe.nodes[w].dims = nda.dims
    pipe.calc_dims(in_dims)
    pipe.calc_support_info()
    return converted


def resize_conv(pipe: ConvPipe, op_name: str, new_kern: tuple[int, int],
                preserve_sum: bool = True) -> None:
    """Bilinearly resample a Convolution's filters to a new spatial size
    (ref resample filters, caffepb.cc:647-708), preserving per-filter sums."""
    op = pipe.ops[op_name]
    if op.type != "Convolution":
        raise ValueError(f"resize_conv: op {op_name!r} is {op.type}, not Convolution")
    w = pipe.weights[op.bots[1]]
    oc, ic, ky, kx = w.dims.shape
    ny, nx = new_kern
    data = w.data.reshape(oc * ic, ky, kx)
    out = np.empty((oc * ic, ny, nx), np.float32)
    ys = np.linspace(0, ky - 1, ny)
    xs = np.linspace(0, kx - 1, nx)
    y0 = np.clip(np.floor(ys).astype(int), 0, ky - 1)
    y1 = np.clip(y0 + 1, 0, ky - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, kx - 1)
    x1 = np.clip(x0 + 1, 0, kx - 1)
    fy = (ys - y0).reshape(1, ny, 1)
    fx = (xs - x0).reshape(1, 1, nx)
    a = data[:, y0][:, :, x0]
    b = data[:, y0][:, :, x1]
    c = data[:, y1][:, :, x0]
    d = data[:, y1][:, :, x1]
    out = (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx +
           c * fy * (1 - fx) + d * fy * fx)
    if preserve_sum:
        old_sum = data.sum(axis=(1, 2), keepdims=True)
        new_sum = out.sum(axis=(1, 2), keepdims=True)
        ratio = np.where(np.abs(new_sum) > 1e-12, old_sum / new_sum, 1.0)
        out = out * ratio
    new_wd = Dims.of(out_chan=oc, in_chan=ic, y=ny, x=nx, tn=w.dims.tn)
    pipe.weights[op.bots[1]] = NDA(new_wd, out.reshape(new_wd.shape))
    pipe.nodes[op.bots[1]].dims = new_wd
    op.params["kern_sz"] = (ny, nx)


def upsample_2x_net(pipe: ConvPipe) -> str:
    """Make the net operate on a 2x-upsampled input with EXACTLY aligned
    outputs (ref make_upsamp_net / upsample weight fabrication,
    caffepb.cc:604,:795): the FIRST Convolution's filters are 2x
    nearest-repeated per axis and scaled by 1/4, stride and pad double.
    For nearest-2x-upsampled input, every w[k] tap then accumulates its
    original x[i+k] exactly (each of the 4 repeats sees the same pixel),
    so the whole downstream net is bit-compatible up to fp reassociation."""
    for op_name in pipe.topo_op_order():
        op = pipe.ops[op_name]
        if op.type == "Convolution":
            k = op.kern_sz()
            w = pipe.weights[op.bots[1]]
            up = np.repeat(np.repeat(w.data, 2, axis=2), 2, axis=3) * 0.25
            new_wd = Dims.of(out_chan=w.dims["out_chan"],
                             in_chan=w.dims["in_chan"],
                             y=k[0] * 2, x=k[1] * 2, tn=w.dims.tn)
            pipe.weights[op.bots[1]] = NDA(new_wd, up)
            pipe.nodes[op.bots[1]].dims = new_wd
            op.params["kern_sz"] = (k[0] * 2, k[1] * 2)
            op.params["stride"] = (op.stride()[0] * 2, op.stride()[1] * 2)
            op.params["pad"] = (op.pad()[0] * 2, op.pad()[1] * 2)
            return op_name
    raise ValueError("upsample_2x_net: no Convolution found")


# -- net writers (prototxt + caffemodel) ---------------------------------------------

def pipe_to_prototxt(pipe: ConvPipe) -> str:
    """Write a pipe back as a (new-style) prototxt (ref cnet_copy flow)."""
    out = [f'name: "{pipe.name}"']
    for inp in pipe.bots():
        if inp == "label":
            continue
        d = pipe.must_dims(inp)
        out.append(f'input: "{inp}"')
        dims = " ".join(f"dim: {s}" for s in d.shape)
        out.append(f"input_shape {{ {dims} }}")
    for op_name in pipe.topo_op_order():
        op = pipe.ops[op_name]
        if op.type in ("Bck", "GradAccum"):
            continue
        lines = [f'  name: "{op.name}"', f'  type: "{op.type}"']
        for b in op.bots:
            if not (b.endswith("__filts") or b.endswith("__biases") or
                    b.endswith("__means") or b.endswith("__vars") or
                    b.endswith("__sf") or b.endswith("__scales")):
                lines.append(f'  bottom: "{b.split("@")[0]}"')
        for t in op.tops:
            lines.append(f'  top: "{t.split("@")[0]}"')
        p = _param_block(pipe, op)
        if p:
            lines.append("  " + p)
        out.append("layer {\n" + "\n".join(lines) + "\n}")
    return "\n".join(out) + "\n"


def _param_block(pipe: ConvPipe, op: ConvOp) -> str:
    k, s, p = op.kern_sz(), op.stride(), op.pad()
    if op.type in ("Convolution", "Deconvolution"):
        w = pipe.weights[op.bots[1]]
        parts = [f"num_output: {w.dims['out_chan']}", f"kernel_size: {k[0]}"]
        if s != (1, 1):
            parts.append(f"stride: {s[0]}")
        if p != (0, 0):
            parts.append(f"pad: {p[0]}")
        g = int(op.p("groups", 1))
        if g != 1:
            parts.append(f"group: {g}")
        return "convolution_param { " + " ".join(parts) + " }"
    if op.type == "InnerProduct":
        w = pipe.weights[op.bots[1]]
        return f"inner_product_param {{ num_output: {w.dims['out_chan']} }}"
    if op.type == "Pooling":
        pool = "AVE" if op.p("avg_pool") else "MAX"
        parts = [f"pool: {pool}"]
        if op.p("global_pooling"):
            parts.append("global_pooling: true")
        else:
            parts.append(f"kernel_size: {k[0]}")
            if s != (1, 1):
                parts.append(f"stride: {s[0]}")
            if p != (0, 0):
                parts.append(f"pad: {p[0]}")
        return "pooling_param { " + " ".join(parts) + " }"
    if op.type == "LRN":
        return (f"lrn_param {{ local_size: {op.p('local_size', 5)} "
                f"alpha: {op.p('alpha', 1e-4)} beta: {op.p('beta', 0.75)} }}")
    if op.type == "Dropout":
        return f"dropout_param {{ dropout_ratio: {op.p('dropout_ratio', 0.5)} }}"
    return ""


def _varint(v: int) -> bytes:
    out = b""
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out += bytes([b | 0x80])
        else:
            return out + bytes([b])


def _ld(fno: int, data: bytes) -> bytes:
    return _varint((fno << 3) | 2) + _varint(len(data)) + data


def write_caffemodel(fn: str, pipe: ConvPipe) -> None:
    """Write weights as a binary NetParameter (new-style LayerParameter with
    name + blobs; readable by our reader and by Caffe-compatible tools)."""
    by_layer: dict[str, list[np.ndarray]] = {}
    for op_name in pipe.topo_op_order():
        op = pipe.ops[op_name]
        blobs = [pipe.weights[b].data for b in op.bots if b in pipe.weights]
        if blobs:
            by_layer[op_name] = blobs
    out = _ld(1, pipe.name.encode())
    for name, blobs in by_layer.items():
        lp = _ld(1, name.encode()) + _ld(2, b"Generated")
        for arr in blobs:
            shape = b"".join(_varint(8) + _varint(d) for d in arr.shape)
            blob = _ld(7, shape) + _ld(5, np.ascontiguousarray(
                arr, dtype="<f4").tobytes())
            lp += _ld(7, blob)
        out += _ld(100, lp)
    with open(fn, "wb") as f:
        f.write(out)
