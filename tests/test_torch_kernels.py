"""The port's GEMM entry point against boda_tpu's Pallas matmul (K1).

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels have no interpret mode; tests/test_torch_cuda.py holds them against
these plain versions on the card), and boda_tpu's Pallas kernels run in
interpret mode as its own tests run them. Same numpy inputs from a seed go
to both. Tolerance (f32): max |out - ref| <= 1e-5 * max|ref| + 1e-6, since
the two sum in different orders. The conv entry points are in
test_torch_kernels_halo.py and test_torch_kernels_nhwc.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.ops.kernels.sgemm import pallas_matmul
from boda_tpu_torch.ops.kernels.conv import conv2d
from boda_tpu_torch.ops.kernels.sgemm import matmul


def _close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max()
    assert err <= 1e-5 * np.abs(ref).max() + 1e-6, err


def _arrs(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("M,K,N,bias,res,relu", [
    (37, 150, 70, True, True, True),    # ragged M/N/K, full epilogue
    (37, 150, 70, True, False, True),
    (64, 128, 128, True, False, False),
    (20, 33, 9, False, False, False),   # no epilogue
    (50, 64, 200, False, False, True),  # ReLU without bias
])
def test_matmul_vs_pallas(M, K, N, bias, res, relu):
    a, b, bb, rr = _arrs(M * K + N, (M, K), (K, N), (N,), (M, N))
    b *= K ** -0.5
    ref = pallas_matmul(jnp.asarray(a), jnp.asarray(b),
                        jnp.asarray(bb) if bias else None, bm=16, bn=128,
                        bk=128, relu=relu, interpret=True,
                        residual=jnp.asarray(rr) if res else None)
    before = matmul.launches
    out = matmul(torch.from_numpy(a), torch.from_numpy(b),
                 torch.from_numpy(bb) if bias else None, relu=relu,
                 residual=torch.from_numpy(rr) if res else None)
    assert matmul.launches == before  # CPU tensors: plain version, no launch
    assert out.dtype == torch.float32
    _close(out.numpy(), ref)


def test_wrappers_refuse_other_devices():
    a = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError):
        matmul(a, a)
    x = torch.zeros(1, 4, 4, 4, device="meta")
    with pytest.raises(ValueError):
        conv2d(x, torch.zeros(3, 3, 4, 4, device="meta"),
               torch.zeros(4, device="meta"))
