"""The port's space-to-depth conv (K4) against boda_tpu's
``space_to_depth_conv``, on the CPU, f32.

boda_tpu runs the fold and then K3 in interpret mode where its block plan
takes the folded shape (``conv_blocks``: folded C <= 128 needs an output
width that is a multiple of 8, conv.py:63); elsewhere it runs the fold on
XLA, so the odd sizes below hold the fold's semantics (the bottom/right pad,
the ``hp -= hp % sy`` trim, the crop) rather than K3's. The port always runs
its conv kernel (here its plain version) on the fold. Gate: 1e-5 of
max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.kernels.conv import space_to_depth_conv as jspace_to_depth_conv
from boda_tpu.ops.tune import OpTune as JOpTune
from boda_tpu_torch.ops.kernels.conv import conv2d, conv2d_plain, space_to_depth_conv

# (n, h, w, c, oc, k, s, p): the ResNet stem geometry at 32x32 (output 16,
# K3 runs), then 225, 31 and 17x23 (odd: the fold pads and trims), a 3x3 s2
# and a 5x5 s3
_CASES = [(2, 32, 32, 3, 16, 7, 2, 3), (1, 225, 225, 3, 8, 7, 2, 3),
          (2, 31, 31, 3, 8, 7, 2, 3), (1, 17, 23, 5, 6, 3, 2, 1),
          (2, 19, 19, 4, 8, 5, 3, 2)]


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "n{}h{}w{}c{}oc{}k{}s{}p{}".format(*c))
def test_s2d_conv_matches_boda_tpu(case):
    n, h, w, c, oc, k, s, p = case
    rng = np.random.RandomState(h + w + k)
    x = rng.randn(n, h, w, c).astype(np.float32)
    wt = (rng.randn(k, k, c, oc) * (k * k * c) ** -0.5).astype(np.float32)
    b = (0.1 * rng.randn(oc)).astype(np.float32)
    ref = np.asarray(jspace_to_depth_conv(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), stride=(s, s), pad=(p, p),
        relu=True, tune=JOpTune(), interpret=True))
    tx, tw, tb = map(torch.from_numpy, (x, wt, b))
    got = space_to_depth_conv(tx, tw, tb, stride=(s, s), pad=(p, p), relu=True)
    assert got.shape == ref.shape and got.is_contiguous()
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)
    # and the strided conv it replaces
    direct = conv2d_plain(tx, tw, tb, stride=(s, s), pad=(p, p), relu=True)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0, atol=1e-5 * scale)
    assert conv2d.launches == 0  # CPU tensors never launch the kernel
