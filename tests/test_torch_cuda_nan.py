"""NaN at ReLU and at max, as boda_tpu's ``jnp.maximum`` gives it, in the hand
kernels on the card: chip_smoke.py's nan phase, one case per kernel and path
(``chip_smoke.NAN_CASES``: K1 with ReLU and a residual, K2/K3 with ReLU, K6,
K7 and K8's max, each on every path it has), each asserting the path it took.

Each case plants NaN in small inputs from a seed and holds the kernel against
its plain version on CPU copies of the same inputs: the same isnan mask, and
the rest equal (max pools) or within 1e-2 of max|ref| in bf16 and 1e-5 in f32.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. Run them on
the machine with the card from the repo root with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_nan.py``.
"""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", chip_smoke.NAN_CASES)
def test_nan_as_the_plain_version(dev, name):
    ok, line = chip_smoke.nan_check(name, dev)
    assert ok, line
