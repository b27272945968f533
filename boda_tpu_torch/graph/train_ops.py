"""Training-side autograd Functions with explicit backwards, channels-last.

Counterpart of ``boda_tpu/graph/train_ops.py``: its three custom VJPs, which
are XLA there (no Pallas kernel), so plain PyTorch here:

1. :func:`make_maxpool_vjp` — a max pool whose forward emits the first-max
   argmax of each window beside the max, and whose backward spreads the
   gradient by that index (ref test/rtc/pool.cucl, the Spreading op). The
   index plane is int16 (int32 past 32767 taps), wide enough for any window:
   boda_tpu's int8 plane (train_ops.py:98) wraps once k*k > 127, and its
   backward then routes the gradient of later taps to the wrong input.
2. :func:`conv1x1_explicit` — a 1x1 conv (any stride, no pad) whose dgrad
   is the dense 1x1 product at the small (output) grid followed by
   zero-stuffing to the input grid, and whose wgrad is one product over
   (n, y, x).
3. :func:`make_bn_train` — train-mode BatchNorm with the fused two-phase
   backward: one pass for the two per-channel sums, one for dx.

All three are off by default, as in boda_tpu (measured there on a TPU, where
its compiler's own adjoints won): ``enabled()`` reads ``BODA_TRAIN_VJP``
(set and not "0" or "": on). The training step (parallel/train.py) reaches
them where boda_tpu's does: train-mode BN, max pools in training, and the
1x1 convs of the library policy.
"""

from __future__ import annotations

import functools
import os

import torch
import torch.nn.functional as F

from ..ops.kernels.train_conv import zero_stuff

_FLAG = False


def enabled() -> bool:
    env = os.environ.get("BODA_TRAIN_VJP")
    if env is not None:
        return env not in ("0", "")
    return _FLAG


# -- 1. maxpool with argmax + spreading backward ------------------------------


@functools.lru_cache(maxsize=None)
def make_maxpool_vjp(k, s, pad_y, pad_x, in_y, in_x, out_y, out_x):
    """fn(x_nhwc) -> pooled, with the Spreading backward.

    Forward: strided slices of the -inf-padded input, one per window offset
    j, folded into a running (max, first argmax): a later offset replaces
    the max only where it is strictly greater. Backward: the cotangent
    masked to ``idx == j`` is added at input rows ``o*s - pad + ky`` (a
    strided slice of a padded accumulator, cropped to the input), offsets in
    the forward's order."""
    ky_n, kx_n = k
    sy, sx = s
    idx_dtype = torch.int16 if ky_n * kx_n <= 2 ** 15 - 1 else torch.int32
    span_y, span_x = (out_y - 1) * sy + 1, (out_x - 1) * sx + 1

    def _max_idx(x):
        xp = F.pad(x, (0, 0, pad_x[0], pad_x[1], pad_y[0], pad_y[1]),
                   value=float("-inf"))
        best = idx = None
        j = 0
        for ky in range(ky_n):
            for kx in range(kx_n):
                sl = xp[:, ky:ky + span_y:sy, kx:kx + span_x:sx, :]
                if best is None:
                    best = sl
                    idx = torch.zeros(sl.shape, dtype=idx_dtype, device=x.device)
                else:
                    gt = sl > best  # strict: the FIRST max wins
                    best = torch.where(gt, sl, best)
                    idx = idx.masked_fill(gt, j)
                j += 1
        return best.contiguous(), idx

    class _MaxPool(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            best, idx = _max_idx(x)
            ctx.save_for_backward(idx)
            ctx.xshape = x.shape
            return best

        @staticmethod
        def backward(ctx, og):
            (idx,) = ctx.saved_tensors
            n, _, _, c = ctx.xshape
            acc = torch.zeros((n, in_y + pad_y[0] + pad_y[1], in_x + pad_x[0] + pad_x[1], c),
                              dtype=og.dtype, device=og.device)
            zero = torch.zeros((), dtype=og.dtype, device=og.device)
            j = 0
            for ky in range(ky_n):
                for kx in range(kx_n):
                    acc[:, ky:ky + span_y:sy, kx:kx + span_x:sx, :] += \
                        torch.where(idx == j, og, zero)
                    j += 1
            return acc[:, pad_y[0]:pad_y[0] + in_y, pad_x[0]:pad_x[0] + in_x, :].contiguous()

    return _MaxPool.apply


# -- 2. explicit 1x1-conv backward --------------------------------------------


@functools.lru_cache(maxsize=None)
def conv1x1_explicit(s):
    """fn(x_nhwc, w_hwio) -> the 1x1 conv (groups 1, pad 0) in f32, with the
    explicit backward: dgrad = the cotangent (cast to x's dtype) times w^T at
    the output grid, then zero-stuffed to the input grid; wgrad = one f32
    product of the subsampled x and the cotangent over (n, y, x), cast to
    w's dtype."""
    sy, sx = s

    class _Conv1x1(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w):
            xs = x[:, ::sy, ::sx, :] if (sy, sx) != (1, 1) else x
            n, oy, ox, c = xs.shape
            out = xs.reshape(-1, c).float() @ w.reshape(c, -1).float()
            ctx.save_for_backward(xs, w)
            ctx.xshape = x.shape
            return out.reshape(n, oy, ox, -1)

        @staticmethod
        def backward(ctx, ct):
            xs, w = ctx.saved_tensors
            og = ct.to(xs.dtype)
            n, oy, ox, kk = og.shape
            c = w.shape[2]
            og2 = og.reshape(-1, kk)
            t = (og2.float() @ w.reshape(c, kk).float().t()).to(xs.dtype)
            dx = zero_stuff(t.reshape(n, oy, ox, c), ctx.xshape, (sy, sx))
            dw = xs.reshape(-1, c).float().t() @ og2.float()
            return dx, dw.reshape(1, 1, c, kk).to(w.dtype)

    return _Conv1x1.apply


# -- the collectives of the data-parallel step --------------------------------


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """A copy of ``t`` summed over the process group's ranks. Every rank
    gets the same bits: the backend reduces in one order for all."""
    import torch.distributed as dist
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


def all_reduce_buckets(ts: list, group) -> list:
    """``ts`` summed over the group's ranks, one flat all-reduce per device
    and dtype (a tp-split weight's gradients lie on the devices of its
    shards), the buckets in the order of their first tensors: every rank
    holds its tensors alike. Each result keeps its tensor's memory layout
    (a weight gradient is a permuted view of the upload layout's), so that a
    reduction over it, the clip's norm, sums in the same order as over the
    tensor itself."""
    import torch.distributed as dist
    out = list(ts)
    buckets: dict = {}
    for i, t in enumerate(ts):
        buckets.setdefault((t.device, t.dtype), []).append(i)
    for ix in buckets.values():
        flat = torch.cat([ts[i].reshape(-1) for i in ix])
        dist.all_reduce(flat, group=group)
        for i, part in zip(ix, flat.split([ts[i].numel() for i in ix])):
            out[i] = torch.empty_like(ts[i]).copy_(part.view(ts[i].shape))
    return out


# -- 3. train-mode BatchNorm with the fused hand backward ---------------------


@functools.lru_cache(maxsize=None)
def make_bn_train(eps: float, group=None):
    """fn(x_nhwc) -> (xhat[x.dtype], batch_mean[f32], batch_var[f32]).

    Forward: the training step's math (f32 mean over (n, y, x), the biased
    two-pass f32 variance, rsqrt normalize, cast back). Backward, the fused
    BN adjoint:
      dx = r/B * (B*dy - sum(dy) - xhat * sum(dy*xhat))
    plus the mean/var outputs' cotangent terms dm/B + dv*2(x-m)/B (zero in
    the training step: the running-stat EMA reads them detached). With a
    process group (the data-parallel step's), B is the global batch: the
    forward's mean and variance are each rank's scaled by 1/world and
    summed, and the backward sums the two per-channel sums and dm, dv over
    the ranks in one all-reduce."""
    import torch.distributed as dist
    world = dist.get_world_size(group) if group is not None else 1

    def _global(t):
        return all_reduce_sum(t * (1.0 / world), group) if group is not None else t

    def _fwd_math(x):
        xf = x.float()
        m = _global(xf.mean(dim=(0, 1, 2)))
        xc = xf - m
        v = _global((xc * xc).mean(dim=(0, 1, 2)))
        return (xc * torch.rsqrt(v + eps)).to(x.dtype), m, v

    class _BnTrain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            out, m, v = _fwd_math(x)
            ctx.save_for_backward(x, m, v)
            return out, m, v

        @staticmethod
        def backward(ctx, dy, dm, dv):
            x, m, v = ctx.saved_tensors
            xc = x.float() - m
            dyf = dy.float()
            b_count = x.shape[0] * x.shape[1] * x.shape[2] * world
            r = torch.rsqrt(v + eps)
            # phase 1: one read of (dy, x) for both per-channel sums
            s_dy = dyf.sum(dim=(0, 1, 2))
            s_dyxc = (dyf * xc).sum(dim=(0, 1, 2))
            if group is not None:  # over the global batch
                s_dy, s_dyxc, dm, dv = all_reduce_sum(
                    torch.stack([s_dy, s_dyxc, dm.float(), dv.float()]), group).unbind(0)
            s_dyxh = s_dyxc * r  # sum(dy * xhat)
            # phase 2: one read of (dy, x) and one write of dx
            dx = (r / b_count) * (b_count * dyf - s_dy - (xc * r) * s_dyxh)
            dx = dx + (dm + dv * 2.0 * xc) / b_count
            return dx.to(x.dtype)

    return _BnTrain.apply
