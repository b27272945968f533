"""The port's conv2d_nhwc against boda_tpu's pallas_conv2d_nhwc (K3) in
interpret mode, at C=64 and below with conv_blocks feasible, on the CPU (the
port runs its plain version). Tolerance (f32): max |out - ref| <=
1e-5 * max|ref| + 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.kernels.conv import conv_blocks, pallas_conv2d_nhwc
from boda_tpu.ops.tune import OpTune
from boda_tpu.utils.dims import Dims
from boda_tpu_torch.ops.kernels.conv import conv2d, conv2d_nhwc


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


@pytest.mark.parametrize("n,h,c,k,oc,p,relu", [
    (2, 8, 64, 3, 64, 1, True),     # res2-like C=64
    (1, 16, 64, 3, 40, 1, False),   # OC below one lane block
    (1, 8, 3, 3, 16, 1, True),      # tiny C (mini_resnet's conv1)
    (1, 12, 64, 5, 32, 0, True),    # 5x5, no padding
])
def test_conv2d_nhwc_vs_pallas(n, h, c, k, oc, p, relu):
    x, w, b, _, (ind, fd, od) = _conv_inputs(h + c + k, n, h, c, k, oc, 1, p, False)
    blocks = conv_blocks(ind, fd, od, OpTune())
    assert blocks is not None
    ref = pallas_conv2d_nhwc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             pad=(p, p), relu=relu, blocks=blocks, interpret=True)
    before = conv2d.launches
    out = conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), pad=(p, p), relu=relu)
    assert conv2d.launches == before
    _close(out.numpy(), ref)
