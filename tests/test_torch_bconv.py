"""The port of the backward-conv kernels against boda_tpu's, on the CPU.

boda_tpu's Pallas kernels run in interpret mode (as its own tests run them);
the port's wrappers, given CPU tensors, run their plain versions. Inputs
are numpy from a seed. Gate: comp_vars(mrd_toler=1e-5, atol=1e-5 *
max|ref|): f32 accumulation in another order, nothing else.
"""

import jax.numpy as jnp
import numpy as np
import torch

from boda_tpu.ops.kernels.bconv import (bck_in_blocks, pallas_conv2d_bck_filts,
                                        pallas_conv2d_bck_in, pallas_matmul_atb)
from boda_tpu.ops.tune import OpTune
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import Dims
from boda_tpu_torch.ops.kernels.bconv import (atb_plan, conv2d_bck_filts,
                                              conv2d_bck_in, conv2d_bck_in_plain,
                                              matmul_atb, matmul_atb_plain)

# ragged against both packages' tiles (8x128 / 128x128x32 / 64x64x16)
_ATB_SHAPES = [(77, 19, 45), (300, 130, 9), (1000, 64, 200)]  # (K, M, N)
# (N, H, W, C, OC, k, pad) stride-1 convs: 1x1, 3x3 pad 1, 3x3 pad 0
_CONV_CASES = [(2, 8, 8, 16, 32, 1, 0), (2, 8, 8, 16, 32, 3, 1),
               (2, 8, 8, 24, 16, 3, 0)]


def _ok(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
    assert r.ok(), str(r)


def test_matmul_atb_f32_ragged():
    for K, M, N in _ATB_SHAPES:
        rng = np.random.RandomState(K + M + N)
        a = rng.randn(K, M).astype(np.float32)
        b = rng.randn(K, N).astype(np.float32)
        ref = pallas_matmul_atb(jnp.asarray(a), jnp.asarray(b), bm=8, bn=128,
                                bk=128, interpret=True)
        got = matmul_atb(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.float32
        _ok(ref, got.numpy())
        _ok(ref, matmul_atb_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy())


def test_matmul_atb_bf16_in_f32_out():
    K, M, N = 200, 48, 72
    rng = np.random.RandomState(3)
    a = rng.randn(K, M).astype(np.float32)
    b = rng.randn(K, N).astype(np.float32)
    ref = pallas_matmul_atb(jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16),
                            bm=16, bn=128, bk=128, out_dtype=jnp.float32,
                            interpret=True)
    got = matmul_atb(torch.from_numpy(a).bfloat16(), torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.float32
    _ok(ref, got.numpy())


def test_conv2d_bck_filts_matches():
    for n, h, w, c, oc, k, p in _CONV_CASES:
        rng = np.random.RandomState(n * h + c + oc + k + p)
        oh, ow = h + 2 * p - k + 1, w + 2 * p - k + 1
        x = rng.randn(n, h, w, c).astype(np.float32)
        dy = rng.randn(n, oh, ow, oc).astype(np.float32)
        ref = pallas_conv2d_bck_filts(jnp.asarray(x), jnp.asarray(dy), pad=(p, p),
                                      tune=OpTune(), interpret=True)
        got = conv2d_bck_filts(torch.from_numpy(x), torch.from_numpy(dy), pad=(p, p))
        assert tuple(got.shape) == (k, k, c, oc) and got.dtype == torch.float32
        _ok(ref, got.numpy())


def test_conv2d_bck_in_matches():
    for n, h, w, c, oc, k, p in _CONV_CASES:
        rng = np.random.RandomState(n * h + c + oc + k + p + 1)
        oh, ow = h + 2 * p - k + 1, w + 2 * p - k + 1
        wt = rng.randn(k, k, c, oc).astype(np.float32)
        dy = rng.randn(n, oh, ow, oc).astype(np.float32)
        blocks = bck_in_blocks(Dims.of(img=n, chan=oc, y=oh, x=ow),
                               Dims.of(out_chan=oc, in_chan=c, y=k, x=k),
                               Dims.of(img=n, chan=c, y=h, x=w), OpTune())
        assert blocks is not None
        ref = pallas_conv2d_bck_in(jnp.asarray(dy), jnp.asarray(wt), pad=(p, p),
                                   blocks=blocks, interpret=True)
        got = conv2d_bck_in(torch.from_numpy(dy), torch.from_numpy(wt), pad=(p, p))
        assert tuple(got.shape) == (n, h, w, c)
        _ok(ref, got.numpy())
        # the independent plain version (the conv's adjoint, no flip)
        _ok(ref, conv2d_bck_in_plain(torch.from_numpy(dy), torch.from_numpy(wt),
                                     pad=(p, p)).numpy())


def test_cpu_wrappers_launch_nothing():
    before = matmul_atb.launches
    x = torch.randn(1, 4, 4, 8)
    conv2d_bck_filts(x, torch.randn(1, 4, 4, 8), pad=(1, 1))
    matmul_atb(torch.randn(5, 3), torch.randn(5, 2))
    assert matmul_atb.launches == before


def test_atb_plan_covers_k_with_tiles():
    """The split-K plan: chunks are whole K tiles, no split is empty, the
    splits cover K, and small outputs over long K get many splits."""
    for dt, bk in ((torch.bfloat16, 32), (torch.float32, 16)):
        for M, N, K, taps in ((64, 64, 100352, 9), (2048, 512, 1568, 1),
                              (512, 512, 1568, 9), (3, 5, 7, 1), (130, 70, 4000, 4)):
            splits, chunk = atb_plan(M, N, K, taps, dt, sms=132)
            assert splits >= 1 and chunk % bk == 0
            assert (splits - 1) * chunk < K <= splits * chunk
            assert taps * splits <= 65535
    assert atb_plan(64, 64, 100352, 9, torch.bfloat16, 132)[0] >= 50
    assert atb_plan(3, 5, 7, 1, torch.float32, 132) == (1, 16)
