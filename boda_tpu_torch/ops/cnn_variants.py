"""The NCHW route of the ``pallas`` engine: conv and fc on the hand kernels.

Counterpart of ``boda_tpu/ops/cnn_variants.py`` (``lower_op_pallas``), the
per-op variant choice of ``conv_fwd`` mode ``pallas`` under ``layout=nchw``
(ref ``add_cnn_codegen_annotations``, src/cnn_op.cc:16), with boda_tpu's
routing decisions and their info-log lines:

  * ``use_xla`` -> the logical rule (graph/lowering.py), no line;
  * InnerProduct -> K1 (``ops/kernels/sgemm.py:matmul``), ``ipmatmul``;
  * a 1x1 conv without pad -> K1 on the pixels, a strided one on its
    subsample, ``k1conv``;
  * a grouped conv, a strided k x k conv, and a conv that boda_tpu's block
    plan (:func:`conv_blocks`) refuses -> the logical rule, each with its
    line;
  * a stride-1 k x k conv -> K3 (``ops/kernels/conv.py:conv2d_nhwc``),
    ``pallas_conv``, with NHWC transposes around the call.

boda_tpu's route ignores a conv's dilation, and its Pallas conv has none,
so a dilated k x k conv would run undilated there; here it takes the
logical rule with a line of its own (``dilated conv -> xla``).

:func:`conv_blocks` is boda_tpu's Mosaic block plan (a lane-aligned channel
count, a VMEM budget): here it only decides the route and names the blocks
in the line, as boda_tpu's does; the Hopper kernels plan their own tiles.

The filters are turned to the kernels' layouts once, at upload (each
lowering returns its :class:`~..graph.lowering_nhwc.Prep`): (in, out) for
K1, HWIO for K3. Activations are turned NHWC and back with
``.contiguous()``, so that every kernel call sees the dense, aligned
operands it checks for. A lowering returns (fn, preps), or None for the
logical rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from ..graph.lowering import LowerCtx
from ..graph.lowering_nhwc import HWIO, Prep, _pallas_blocks
from ..graph.pipe import ConvOp, ConvPipe
from ..utils.dims import Dims
from .kernels.conv import conv2d_nhwc
from .kernels.sgemm import matmul
from .tune import OpTune

# boda_tpu's VMEM budget of a conv block (ops/kernels/conv.py:49)
_VMEM_BUDGET = 10 * 2 ** 20


@dataclass(frozen=True)
class ConvBlocks:
    boy: int   # output rows per block
    boc: int   # output channels per block

    def __str__(self):
        return f"boy={self.boy} boc={self.boc}"


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def conv_blocks(ind: Dims, fd: Dims, od: Dims, tune: OpTune) -> Optional[ConvBlocks]:
    """boda_tpu's block plan of its stride-1 Pallas conv
    (``ops/kernels/conv.py:conv_blocks``), or None where it refuses the
    shape: Mosaic wants the channels lane-aligned (c % 128 == 0, or c <= 128
    with ow % 8 == 0), and a block's input, output, accumulator and filters
    within 10 MiB."""
    kh, kw = fd["y"], fd["x"]
    c, oc = fd["in_chan"], fd["out_chan"]
    ow, oh = od["x"], od["y"]
    if c % 128 != 0 and not (c <= 128 and ow % 8 == 0):
        return None
    pw = ind["x"] + 2 * 8
    itemsize = 4 if ind.tn == "float32" else 2
    boc = min(_round_up(oc, 128), max(128, (tune.bn // 128) * 128))
    while _round_up(oc, 128) % boc:
        boc -= 128
    for boy in ((tune.chunk,) if tune.chunk else (32, 16, 8, 4, 2, 1)):
        if boy > oh and not tune.chunk:
            continue
        boy = min(boy, oh)
        x_blk = (boy + kh - 1) * pw * c * itemsize
        out_blk = boy * ow * boc * itemsize
        acc_blk = boy * ow * boc * 4
        w_blk = kh * kw * c * boc * itemsize
        if 2 * x_blk + 2 * out_blk + acc_blk + w_blk <= _VMEM_BUDGET:
            return ConvBlocks(boy=boy, boc=boc)
    return None


# fc filters (out_chan, in_feats) as K1's row-major B (in_feats, out_chan)
IO = Prep(lambda w: w.t().contiguous(), lambda g: g.t().contiguous(), 1, "IO")
# 1x1 conv filters (O, C, 1, 1) as K1's B (C, O)
K1X1 = Prep(lambda w: w.reshape(w.shape[0], -1).t().contiguous(),
            lambda g: g.t().contiguous().reshape(g.shape[1], g.shape[0], 1, 1), 1, "1x1-CO")


def lower_op_pallas(pipe: ConvPipe, op: ConvOp, ctx: LowerCtx, tune: OpTune,
                    info_log: list[str]) -> Optional[tuple[Callable, dict]]:
    if tune.use_xla:
        return None
    if op.type == "InnerProduct":
        return _lower_ip_pallas(pipe, op, tune, info_log)
    if op.type == "Convolution":
        k, s, p = op.kern_sz(), op.stride(), op.pad()
        if int(op.p("groups", 1)) != 1:
            info_log.append(f"{op.name}: grouped conv -> xla")
            return None
        if k == (1, 1) and p == (0, 0) and tune.use_k1conv:
            return _lower_k1conv(pipe, op, tune, info_log)
        if s != (1, 1):
            info_log.append(f"{op.name}: strided conv -> xla")
            return None
        if op.dilation() != (1, 1):
            info_log.append(f"{op.name}: dilated conv -> xla")
            return None
        return _lower_conv_pallas(pipe, op, tune, info_log)
    return None


def _lower_ip_pallas(pipe, op, tune, info_log):
    ind, fd = pipe.must_dims(op.bots[0]), pipe.must_dims(op.bots[1])
    bm, bn, bk = _pallas_blocks(ind["img"], fd["in_feats"], fd["out_chan"], tune, ind.tn)
    relu = bool(op.p("fused_relu", False))
    info_log.append(f"{op.name}: ipmatmul bm={bm} bn={bn} bk={bk}")

    def fn(x, w, b):  # w (in_feats, out_chan)
        return (matmul(x.reshape(x.shape[0], -1).contiguous(), w, b, relu=relu),)
    return fn, {op.bots[1]: IO}


def _lower_k1conv(pipe, op, tune, info_log):
    """A 1x1 conv as K1 over the (img*y*x, chan) pixels (ref k1conv,
    cnn_codegen.cc:625), a strided one on its subsample."""
    ind, fd, od = (pipe.must_dims(n) for n in (op.bots[0], op.bots[1], op.tops[0]))
    s = op.stride()
    bm, bn, bk = _pallas_blocks(od["img"] * od["y"] * od["x"], fd["in_chan"],
                                fd["out_chan"], tune, ind.tn)
    relu = bool(op.p("fused_relu", False))
    info_log.append(f"{op.name}: k1conv bm={bm} bn={bn} bk={bk}")

    def fn(x, w, b):  # w (in_chan, out_chan)
        if s != (1, 1):
            x = x[:, :, ::s[0], ::s[1]]
        n, c, y, xx = x.shape
        xf = x.permute(0, 2, 3, 1).contiguous().reshape(n * y * xx, c)
        out = matmul(xf, w, b, relu=relu)
        return (out.reshape(n, y, xx, -1).permute(0, 3, 1, 2).contiguous(),)
    return fn, {op.bots[1]: K1X1}


def _lower_conv_pallas(pipe, op, tune, info_log):
    """A stride-1 k x k conv as K3 on NHWC views of x, the filters HWIO."""
    ind, fd, od = (pipe.must_dims(n) for n in (op.bots[0], op.bots[1], op.tops[0]))
    p = op.pad()
    relu = bool(op.p("fused_relu", False))
    blocks = conv_blocks(ind, fd, od, tune)
    if blocks is None:
        info_log.append(f"{op.name}: conv doesn't fit pallas blocking -> xla")
        return None
    info_log.append(f"{op.name}: pallas_conv {blocks}")

    def fn(x, w, b):  # w HWIO
        out = conv2d_nhwc(x.permute(0, 2, 3, 1).contiguous(), w, b, pad=p, relu=relu)
        return (out.permute(0, 3, 1, 2).contiguous(),)
    return fn, {op.bots[1]: HWIO}
