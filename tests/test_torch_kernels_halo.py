"""The port's conv2d_halo against boda_tpu's pallas_conv2d_halo (K2) in
interpret mode, at C=128, on the CPU (the port runs its plain version).
Tolerance (f32): max |out - ref| <= 1e-5 * max|ref| + 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.kernels.conv import conv_halo_blocks, pallas_conv2d_halo
from boda_tpu.ops.tune import OpTune
from boda_tpu.utils.dims import Dims
from boda_tpu_torch.ops.kernels.conv import conv2d_halo


def _close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max() + 1e-6, err


def _arrs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


def _conv_inputs(seed, n, h, c, k, oc, s, p, res):
    oh = (h + 2 * p - k) // s + 1
    x, w, b, r = _arrs(seed, (n, h, h, c), (k, k, c, oc), (oc,), (n, oh, oh, oc))
    w *= (k * k * c) ** -0.5
    b *= 0.1
    dims = (Dims.of(img=n, chan=c, y=h, x=h),
            Dims.of(out_chan=oc, in_chan=c, y=k, x=k),
            Dims.of(img=n, chan=oc, y=oh, x=oh))
    return x, w, b, (r if res else None), dims


@pytest.mark.parametrize("n,h,k,oc,s,p,res,relu", [
    (1, 8, 3, 128, 1, 1, True, True),    # residual + ReLU epilogue
    (2, 7, 3, 128, 1, 1, False, True),   # masked row tail
    (1, 9, 3, 128, 2, 1, False, False),  # strided (f32)
    (1, 6, 1, 128, 2, 0, True, False),   # 1x1 strided with residual
])
def test_conv2d_halo_vs_pallas(n, h, k, oc, s, p, res, relu):
    x, w, b, r, (ind, fd, od) = _conv_inputs(h * k + s, n, h, 128, k, oc, s, p, res)
    hb = conv_halo_blocks(ind, fd, od, (s, s), (p, p), OpTune())
    assert hb is not None
    ref = pallas_conv2d_halo(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             stride=(s, s), pad=(p, p), relu=relu, hb=hb,
                             interpret=True,
                             residual=None if r is None else jnp.asarray(r))
    out = conv2d_halo(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), stride=(s, s), pad=(p, p), relu=relu,
                      residual=None if r is None else torch.from_numpy(r))
    _close(out.numpy(), ref)
