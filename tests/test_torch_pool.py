"""The port's pooling (K8) against boda_tpu's ``pallas_pool``, on the CPU.

boda_tpu's kernel runs in interpret mode, as its own tests run it
(tests/test_pool_pallas.py); the port's wrapper takes its plain version on
CPU tensors. Forward gate: 1e-6, tests/test_pool_pallas.py's bar. The
backward (the port's autograd Function) against JAX's custom VJP.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from boda_tpu.graph.lowering_nhwc import _avg_divisor
from boda_tpu.ops.kernels.pool import pallas_pool
from boda_tpu_torch.ops.kernels.pool import Pool2d, pool2d, pool2d_lib

# (iy, ix, c, k, s, p): tests/test_pool_pallas.py:35-37, then ResNet-50's
# pool1 (112 -> 56, 3x3 s2, the ceil-mode last window clipped) at C=16 and
# its pool5 (a 7x7 global window) at C=256
_GEOMS = [(14, 14, 8, (3, 3), (2, 2), (0, 0)),
          (12, 12, 16, (2, 2), (2, 2), (0, 0)),
          (9, 9, 8, (3, 3), (1, 1), (1, 1)),
          (112, 112, 16, (3, 3), (2, 2), (0, 0)),
          (7, 7, 256, (7, 7), (1, 1), (0, 0))]


def _geom(iy, ix, k, s, p):
    oy = -(-(iy + 2 * p[0] - k[0]) // s[0]) + 1
    ox = -(-(ix + 2 * p[1] - k[1]) // s[1]) + 1
    pad_y = (p[0], max(0, (oy - 1) * s[0] + k[0] - iy - p[0]))
    pad_x = (p[1], max(0, (ox - 1) * s[1] + k[1] - ix - p[1]))
    return pad_y, pad_x, oy, ox


@pytest.mark.parametrize("geom", _GEOMS, ids=lambda g: f"{g[0]}x{g[1]}x{g[2]}k{g[3][0]}s{g[4][0]}p{g[5][0]}")
def test_pool_matches_pallas(geom):
    iy, ix, c, k, s, p = geom
    pad_y, pad_x, oy, ox = _geom(iy, ix, k, s, p)
    x = np.random.RandomState(iy + c).randn(2, iy, ix, c).astype(np.float32)
    for avg in (False, True):
        ref = np.asarray(pallas_pool(jnp.asarray(x), k, s, pad_y, pad_x, oy, ox, avg,
                                     interpret=True))
        got = pool2d(torch.from_numpy(x), k, s, pad_y, pad_x, oy, ox, avg)
        assert got.shape == (2, oy, ox, c)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
        # the library pool (the engine's default, and the backward's function)
        lib = pool2d_lib(torch.from_numpy(x), k, s, pad_y, pad_x, oy, ox, avg)
        np.testing.assert_allclose(lib.numpy(), ref, rtol=1e-6, atol=1e-6)
    assert pool2d.launches == 0  # CPU tensors never launch the kernel


@pytest.mark.parametrize("avg", [False, True])
def test_pool_backward_matches_jax_vjp(avg):
    """The autograd Function's backward against JAX's gradient, on pool1's
    geometry class (ceil-mode clip): max through boda_tpu's custom VJP; avg
    through the function that VJP differentiates (reduce_window sum times
    the inverse divisor, pool.py:223-230), since the custom VJP's avg branch
    raises a broadcast error in boda_tpu (ROADMAP §3)."""
    iy, ix, c, k, s, p = 13, 13, 4, (3, 3), (2, 2), (0, 0)
    pad_y, pad_x, oy, ox = _geom(iy, ix, k, s, p)
    rng = np.random.RandomState(5 + avg)
    x = rng.randn(2, iy, ix, c).astype(np.float32)
    ct = rng.randn(2, oy, ox, c).astype(np.float32)
    inv = (1.0 / _avg_divisor(iy, ix, k, s, p, oy, ox)).reshape(1, oy, ox, 1)

    def f(a):
        if avg:
            out = lax.reduce_window(a, 0.0, lax.add, (1, *k, 1), (1, *s, 1),
                                    ((0, 0), pad_y, pad_x, (0, 0))) * inv
        else:
            out = pallas_pool(a, k, s, pad_y, pad_x, oy, ox, avg, interpret=True)
        return jnp.sum(out * ct)
    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (Pool2d.apply(xt, k, s, pad_y, pad_x, oy, ox, avg) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_cached_divisor_enters_autograd_after_inference_mode():
    """The avg divisor is cached per geometry; a first call under
    inference_mode (a forward engine) must not leave a value that a later
    autograd graph (a backward graph's pool) cannot use."""
    iy, ix, k, s, p = 11, 6, (3, 2), (2, 2), (1, 0)
    pad_y, pad_x, oy, ox = _geom(iy, ix, k, s, p)
    x = torch.from_numpy(np.random.RandomState(1).randn(1, iy, ix, 3).astype(np.float32))
    with torch.inference_mode():
        want = pool2d_lib(x, k, s, pad_y, pad_x, oy, ox, True)
    xt = x.clone().requires_grad_()
    got = Pool2d.apply(xt, k, s, pad_y, pad_x, oy, ox, True)
    got.sum().backward()
    torch.testing.assert_close(got.detach(), want)
    assert xt.grad.shape == x.shape and bool(torch.isfinite(xt.grad).all())
