"""Direct implicit-GEMM NHWC conv with a fused bias(+residual)(+ReLU) store:
the port of K2 and K3.

Counterparts of ``boda_tpu/ops/kernels/conv.py:pallas_conv2d_halo`` (K2) and
``pallas_conv2d_nhwc`` (K3). Both entry points keep their JAX signatures and
call one CUDA kernel, ``csrc/conv.cu`` on the GEMM core ``csrc/gemm.cuh``
that K1 shares: the K2/K3 split exists only because of Mosaic's DMA and
layout limits (c % 128, no bf16 stride, VMEM budgets), none of which binds
on Hopper. Each launch takes the core's tile plan for its implicit GEMM
(:func:`~.common.plan_gemm`: wgmma for C % 8 == 0, ``wgmma_narrow`` for the
C = 3 stems and every other C % 8 != 0, ``wgmma_edge`` for ssd300's
mbox_conf heads and every other even OC % 8 != 0 with C % 8 == 0, the
mma.sync loop for odd OC, both C and OC off 8, or a misaligned operand).
:func:`conv2d` launches the kernel for CUDA tensors and runs
:func:`conv2d_plain` for CPU tensors; there is no other fallback.

K4 (``space_to_depth_conv``, a strided conv folded into a stride-1 one)
is :func:`space_to_depth_conv`: the fold in PyTorch, as it is XLA in
boda_tpu, and the conv kernel on the fold.

Layouts are the JAX package's: x (N,H,W,C), w HWIO (KH,KW,C,OC), bias (OC),
residual and output (N,OH,OW,OC). w may be the ``[..., :OC]`` view of filters
whose rows are padded (:func:`~.common.pad_rows`, as the engine's HWIO prep
stores OC % 8 != 0); a wgmma plan on a dense w with OC % 8 != 0 launches on
a padded copy, counted in ``conv2d.pad_copies``. :func:`gen_conv` is the rtc ``conv`` op,
NCHW at its signature.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...rtc.compute import FuncInfo
from ...utils.dims import Dims
from ..op_base import Op
from ..registry import GenCtx, kernel_gen, tune_note
from ..tune import OpTune
from . import build
from .common import (PATH_CODES, WGMMA_PATHS, aligned16, check_operand, check_rows, epilogue,
                     kernel_dtype, kernel_entry, pad_rows, plan_gemm, ptr, sm_count,
                     splitk_workspace)
from .sgemm import matmul


def out_size(h: int, w: int, kh: int, kw: int, stride, pad) -> tuple[int, int]:
    return ((h + 2 * pad[0] - kh) // stride[0] + 1,
            (w + 2 * pad[1] - kw) // stride[1] + 1)


def conv2d_plain(x, w, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False,
                 residual=None):
    """The plain PyTorch version: f32 ``F.conv2d`` on the NCHW views plus the
    epilogue, output NHWC in x's dtype. (On the card, turn TF32 off first:
    cuDNN convs run TF32 by default.)"""
    acc = F.conv2d(x.float().permute(0, 3, 1, 2), w.float().permute(3, 2, 0, 1),
                   stride=tuple(stride), padding=tuple(pad))
    return epilogue(acc.permute(0, 2, 3, 1), bias, residual, relu, x.dtype) \
        .contiguous()


def conv2d(x, w, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False,
           residual=None):
    """x (N,H,W,C) * w (KH,KW,C,OC) + bias (+residual) (+ReLU) ->
    (N,OH,OW,OC); any stride and padding, groups 1, dilation 1."""
    if x.device.type == "cpu":
        return conv2d_plain(x, w, bias, stride=stride, pad=pad, relu=relu,
                            residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d: no kernel for device {x.device}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d: bad shapes x {tuple(x.shape)} w {tuple(w.shape)}")
    n, h, wd, c = x.shape
    kh, kw, _, oc = w.shape
    oh, ow = out_size(h, wd, kh, kw, stride, pad)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"conv2d: empty output {oh}x{ow}")
    dt = kernel_dtype(x)
    check_operand("x", x, x.device, x.dtype, (n, h, wd, c))
    ldb = check_rows("w", w, x.device, x.dtype, (kh, kw, c, oc))
    check_operand("bias", bias, x.device, x.dtype, (oc,))
    if residual is not None:
        check_operand("residual", residual, x.device, x.dtype, (n, oh, ow, oc))
    M = n * oh * ow
    # x need not be 16-byte aligned where C % 8 != 0: the narrow fill reads
    # it element by element
    plan = plan_gemm(M, oc, kh * kw * c, sm_count(x.device), x.dtype, conv_c=c,
                     aligned=aligned16(w, bias, residual) and (c % 8 != 0 or aligned16(x)))
    if plan.path in WGMMA_PATHS and ldb % 8:  # TMA reads B's rows 16 bytes apart
        w = pad_rows(w)
        ldb = w.stride(2)
        conv2d.pad_copies += 1
    out = torch.empty((n, oh, ow, oc), dtype=x.dtype, device=x.device)
    ws = splitk_workspace(plan, M, oc, x.device)
    kb = build.load()
    with torch.cuda.device(x.device):
        rc = kb.lib.boda_conv2d(x.data_ptr(), w.data_ptr(), bias.data_ptr(),
                                ptr(residual), out.data_ptr(), ptr(ws), n, h, wd, c,
                                oh, ow, oc, kh, kw, stride[0], stride[1], pad[0],
                                pad[1], int(relu), dt, PATH_CODES[plan.path], plan.bm,
                                plan.bn, plan.split, ldb, build.stream_ptr(x))
    if rc:
        build.check(rc, f"boda_conv2d {plan}")
    conv2d.launches += 1
    conv2d.paths[plan.path] += 1
    conv2d.last_plan = plan
    return out


# kernel launches, in all and per path of the plan (CPU plain-version calls
# do not count); a split-K launch (two kernels) counts once
conv2d.launches = 0
conv2d.paths = dict.fromkeys(PATH_CODES, 0)
conv2d.last_plan = None  # the plan of the latest launch
conv2d.pad_copies = 0  # launches on a padded copy of a dense w (OC % 8 != 0 on wgmma_edge)


@kernel_entry("K2", lambda: conv2d.last_plan)
def conv2d_halo(x, wt, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False,
                residual=None):
    """Entry point of K2 (``pallas_conv2d_halo``): the direct conv with the
    residual epilogue."""
    return conv2d(x, wt, bias, stride=stride, pad=pad, relu=relu,
                  residual=residual)


@kernel_entry("K3", lambda: conv2d.last_plan)
def conv2d_nhwc(x, w, bias, *, stride=(1, 1), pad=(0, 0), relu: bool = False):
    """Entry point of K3 (``pallas_conv2d_nhwc``): the direct conv without a
    residual. Unlike K3 it takes any stride."""
    out = conv2d(x, w, bias, stride=stride, pad=pad, relu=relu)
    if out.device.type == "cuda":  # the conv kernel ran through K3's entry
        conv2d_nhwc.launches += 1
    return out


conv2d_nhwc.launches = 0  # conv-kernel launches through K3's entry (dgrads, folds)


@kernel_entry("K4", lambda: conv2d.last_plan)
def space_to_depth_conv(x, w, bias, *, stride, pad, relu: bool = False):
    """Entry point of K4 (``space_to_depth_conv``): a strided conv as a
    stride-1 conv on the space-to-depth fold, on the conv kernel
    (:func:`conv2d_nhwc`).

    x (N,H,W,C), w (KH,KW,C,OC), stride (sy,sx) -> the stride-1 conv of
    x' (N,Hp/sy,Wp/sx,C*sy*sx) with w' (ceil(KH/sy),ceil(KW/sx),C*sy*sx,OC),
    cropped to the strided conv's (OH,OW). The input and the weights are
    folded per call, as boda_tpu folds them (conv.py:680-696)."""
    sy, sx = stride
    py, px = pad
    n, h, wd, c = x.shape
    kh, kw, _, oc = w.shape
    oh, ow = out_size(h, wd, kh, kw, stride, pad)
    khp, kwp = -(-kh // sy), -(-kw // sx)
    # conv padding + bottom/right so the folded view covers all taps, then
    # trimmed to whole stride cells
    need_h = (oh - 1 + (khp - 1)) * sy + sy
    need_w = (ow - 1 + (kwp - 1)) * sx + sx
    xp = F.pad(x, (0, 0, px, max(0, need_w - wd - px), py, max(0, need_h - h - py)))
    hp, wp = xp.shape[1] - xp.shape[1] % sy, xp.shape[2] - xp.shape[2] % sx
    xs = xp[:, :hp, :wp, :].reshape(n, hp // sy, sy, wp // sx, sx, c) \
        .permute(0, 1, 3, 2, 4, 5).reshape(n, hp // sy, wp // sx, sy * sx * c)
    # w'[ky',kx',(py,px,c),oc] = w[ky'*sy+py, kx'*sx+px, c, oc]
    wz = w.new_zeros((khp * sy, kwp * sx, c, oc))
    wz[:kh, :kw] = w
    wf = wz.reshape(khp, sy, kwp, sx, c, oc).permute(0, 2, 1, 3, 4, 5) \
        .reshape(khp, kwp, sy * sx * c, oc)
    # zero channels up to a multiple of 8 (the stem's 12 -> 16): the conv
    # kernel then takes its wgmma path, gathering 16 bytes at a time; zeros
    # add exact 0s
    cpad = -(sy * sx * c) % 8
    if cpad:
        xs = F.pad(xs, (0, cpad))
        wf = F.pad(wf, (0, 0, 0, cpad))
    out = conv2d_nhwc(xs.contiguous(), wf.contiguous(), bias, relu=relu)
    if out.device.type == "cuda":  # the conv kernel ran on the fold
        space_to_depth_conv.launches += 1
    return out[:, :oh, :ow, :].contiguous()


space_to_depth_conv.launches = 0  # conv-kernel launches on a fold


# -- standalone rtc-layer conv op -----------------------------------------------------
# signature: (type=conv,stride=S,pad=P,in=(img,chan,y,x),filts=(out_chan,in_chan,y,x),
#             biases=(out_chan),out=(img,chan,y,x))  [NCHW names; ref conv.cucl]

@kernel_gen("conv")
def gen_conv(op: Op, tune: OpTune, ctx: GenCtx) -> FuncInfo:
    """boda_tpu's ``gen_conv`` (conv.py:725). The signature stays NCHW/OIHW;
    the hand kernels' routes transpose to NHWC/HWIO inside ``fn``:

    * ``use_ref`` -> the plain f32 version;
    * ``use_xla`` -> ``F.conv2d`` (cuDNN, the library path). For 16-bit
      inputs it convolves their f32 values in TF32, which holds a bf16 or
      fp16 value exactly, so the products are exact and summed in f32, and
      bias and ReLU are applied before the one rounding to the output
      dtype: boda_tpu's XLA conv with ``preferred_element_type=float32``.
      cuDNN's own bf16 conv rounds before ATen adds the bias, and that
      second rounding breaks ops_prof's cross-tune check near cancellations;

    then the engine's own route (graph/lowering_nhwc.py:_nhwc_conv), so
    that the tunes are timed on the kernels the engine runs:

    * a 1x1 pad-0 conv under ``use_k1conv`` -> K1's ``matmul`` on the
      (N*OH*OW, C) rows, on the ``[:, ::s, ::s]`` subsample when strided;
    * a strided k > 1 conv with ``use_s2d`` -> ``space_to_depth_conv`` (K4);
    * stride 1 -> ``conv2d_nhwc`` (K3's entry; one kernel with K2's);
    * other strided convs -> ``conv2d``, which takes any stride.

    (boda_tpu's gen_conv sends a 1x1 to its direct conv, conv.py:735-741,
    where its engine runs the GEMM: the port does not copy that split.)"""
    ind, fd, od = op.dims("in"), op.dims("filts"), op.dims("out")
    s = (op.ival("stride", 1), op.ival("stride", 1))
    p = (op.ival("pad", 0), op.ival("pad", 0))
    relu = bool(op.ival("relu", 0))
    kh, kw = fd["y"], fd["x"]
    flops = 2.0 * od.num_elems() * fd["in_chan"] * kh * kw
    byts = float(ind.bytes_sz() + fd.bytes_sz() + od.bytes_sz())

    def nhwc(kernel, **kw_):
        def fn(x, w, b):
            out = kernel(x.permute(0, 2, 3, 1).contiguous(),
                         w.permute(2, 3, 1, 0).contiguous(), b, pad=p, relu=relu, **kw_)
            return out.permute(0, 3, 1, 2).contiguous()
        return fn

    if ctx.use_ref:
        fn = nhwc(conv2d_plain, stride=s)
        info = "ref:plain conv"
    elif tune.use_xla:
        def fn(x, w, b):
            from ...graph.lowering import lib_precision
            narrow = x.dtype != torch.float32  # TF32 holds its values exactly
            with lib_precision("default" if narrow else tune.precision):
                out = F.conv2d(x.float(), w.float(), b.float(), stride=s, padding=p)
            if relu:
                out = torch.relu(out)
            return out.to(x.dtype)
        info = "lib:F.conv2d (library path)"
    elif (kh, kw) == (1, 1) and p == (0, 0) and tune.use_k1conv:
        def fn(x, w, b):
            xs = x[:, :, ::s[0], ::s[1]]
            n, c, oy, ox = xs.shape
            a = xs.permute(0, 2, 3, 1).reshape(n * oy * ox, c).contiguous()
            out = matmul(a, w.reshape(w.shape[0], c).t().contiguous(), b, relu=relu)
            return out.reshape(n, oy, ox, -1).permute(0, 3, 1, 2).contiguous()
        info = f"cuda:matmul k1conv s={s}"
    elif s == (1, 1):
        fn = nhwc(conv2d_nhwc)
        info = "cuda:conv2d_nhwc s=1"
    elif tune.use_s2d and (kh, kw) != (1, 1):
        fn = nhwc(space_to_depth_conv, stride=s)
        info = f"cuda:s2d_conv s={s}"
    else:
        fn = nhwc(conv2d, stride=s)
        info = f"cuda:conv2d s={s}"

    return FuncInfo(name="", args=[("in", "in"), ("filts", "in"),
                                   ("biases", "in"), ("out", "out")],
                    fn=fn, flops=flops, bytes_accessed=byts, info=info + tune_note(tune),
                    in_dims=[ind, fd, Dims.of(out_chan=fd["out_chan"], tn=ind.tn)])
