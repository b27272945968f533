"""The port's gen_data pattern is bit-identical to boda_tpu's."""

import jax.numpy as jnp
import numpy as np
import pytest

from boda_tpu.ops.kernels.gen_data import gen_data_pattern as jax_pattern
from boda_tpu_torch.ops.kernels.gen_data import gen_data_pattern


@pytest.mark.parametrize("shape,tn,kw", [
    ((2, 3, 5, 7), "float32", {}),
    ((1, 3, 224, 224), "float32", {}),
    ((4, 17), "bfloat16", {}),
    ((3, 50), "float32", dict(mod=11, sub=4.5, mul=0.37, stride=5, offset=9)),
    ((3, 50), "bfloat16", dict(mod=7, sub=1.0, mul=0.3, stride=3, offset=2)),
])
def test_gen_data_pattern_bit_identical(shape, tn, kw):
    ref = np.asarray(jax_pattern(shape, tn, **kw).astype(jnp.float32))
    got = gen_data_pattern(shape, tn, **kw)
    assert str(got.dtype) == f"torch.{tn}"
    assert np.array_equal(got.float().numpy(), ref)
