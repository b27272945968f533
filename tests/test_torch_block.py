"""The port's fused bottleneck (K6) against boda_tpu's ``pallas_bottleneck``,
on the CPU.

boda_tpu's kernel runs in interpret mode, as its own tests run it; the
port's wrapper takes its plain version on CPU tensors. Inputs come from a
numpy seed and are rounded to bf16 the same way (round to nearest even) on
both sides. Gates: f32 1e-5 of max|ref| (summation order only); bf16 1e-2
of max|ref| (h1, h2 and y are each rounded to bf16 once, at the same points
on both sides; one bf16 ulp is 2^-8 of a value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.kernels.block import block_fuse_ok as jblock_fuse_ok
from boda_tpu.ops.kernels.block import pallas_bottleneck
from boda_tpu.utils.dims import Dims as JDims
from boda_tpu_torch.ops.kernels.block import block_fuse_ok, bottleneck
from boda_tpu_torch.ops.kernels.conv import conv2d_plain
from boda_tpu_torch.ops.kernels.sgemm import matmul_plain
from boda_tpu_torch.utils.dims import Dims

_TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _operands(n, h, w, c, k, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(n, h, w, c).astype(np.float32),
            (rng.randn(c, k) * c ** -0.5).astype(np.float32),
            (0.1 * rng.randn(k)).astype(np.float32),
            (rng.randn(3, 3, k, k) * (9 * k) ** -0.5).astype(np.float32),
            (0.1 * rng.randn(k)).astype(np.float32),
            (rng.randn(k, c) * k ** -0.5).astype(np.float32),
            (0.1 * rng.randn(c)).astype(np.float32)]


# (dtype, (n, h, w, c, k)): boda_tpu's lane-friendly block, and a ragged one
# (C, K and the plane off every tile size) that only the port's gate admits
_CASES = [("float32", (2, 8, 8, 128, 32)), ("bfloat16", (2, 8, 8, 128, 32)),
          ("float32", (1, 5, 7, 20, 12)), ("bfloat16", (1, 9, 6, 24, 16))]


@pytest.mark.parametrize("dt,shape", _CASES, ids=[f"{d}-{'x'.join(map(str, s))}" for d, s in _CASES])
def test_bottleneck_matches_pallas(dt, shape):
    ops = _operands(*shape, seed=sum(shape))
    prec = "highest" if dt == "float32" else "default"
    ref = np.asarray(pallas_bottleneck(*(jnp.asarray(a, dtype=dt) for a in ops),
                                       precision=prec, interpret=True)).astype(np.float32)
    tdt = getattr(torch, dt)
    got = bottleneck(*(torch.from_numpy(a).to(tdt) for a in ops))
    assert got.dtype == tdt and got.shape == shape[:4]
    err = float(np.abs(got.float().numpy() - ref).max()) / float(np.abs(ref).max())
    assert err <= _TOL[dt], err
    assert bottleneck.launches == 0  # CPU tensors never launch the kernel


def test_bottleneck_is_the_three_convs():
    """The block equals its three convs run one by one through the other
    kernels' plain versions, the residual in the last one's epilogue."""
    x, w1, b1, w2, b2, w3, b3 = (torch.from_numpy(a) for a in _operands(2, 6, 5, 16, 8, 3))
    n, h, w, c = x.shape
    h1 = matmul_plain(x.reshape(-1, c), w1, b1, relu=True).reshape(n, h, w, -1)
    h2 = conv2d_plain(h1, w2, b2, pad=(1, 1), relu=True)
    y = matmul_plain(h2.reshape(-1, 8), w3, b3, relu=True, residual=x.reshape(-1, c))
    torch.testing.assert_close(bottleneck(x, w1, b1, w2, b2, w3, b3),
                               y.reshape(n, h, w, c), rtol=1e-5, atol=1e-5)


def test_block_fuse_ok_is_structural():
    """boda_tpu's structural conditions hold; its Mosaic gates (C % 128,
    K % 8, the VMEM budget) do not."""
    ok = dict(k=3, s=(1, 1), p=(1, 1), groups=1)
    for chan, cc, y in ((256, 64, 56), (96, 12, 5), (2048, 512, 224)):
        xd = Dims.of(img=32, chan=chan, y=y, x=y, tn="bfloat16")
        assert block_fuse_ok(xd, cc=cc, **ok)
    jxd = JDims.of(img=32, chan=96, y=5, x=5, tn="bfloat16")
    assert not jblock_fuse_ok(jxd, cc=12, **ok)  # boda_tpu's lane gate
    xd = Dims.of(img=1, chan=256, y=56, x=56)
    for bad in (dict(s=(2, 2)), dict(p=(0, 0)), dict(k=1), dict(groups=2),
                dict(dil=(2, 2))):
        assert not block_fuse_ok(xd, cc=64, **{**ok, **bad}), bad
