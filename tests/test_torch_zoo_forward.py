"""The zoo's GoogLeNet, VGG, NiN, SqueezeNet and firenet forwards on the
port's engine against boda_tpu's, on the CPU, every node (AlexNet's runs on
the card only: its fc6 needs a 227 input, slow in boda_tpu's interpret
mode)."""

import numpy as np
import pytest

from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu.utils.dims import NDA as JNDA
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.utils.carry import weights_from_numpy
from boda_tpu_torch.utils.dims import NDA as TNDA
from boda_tpu_torch.utils.lexp import parse_lexp

# builder kwargs: a small input
_FWD = {"googlenet_conv": {"in_sz": 64}, "squeezenet": {"in_sz": 64},
        "firenet": {"in_sz": 48}, "nin_imagenet": {"in_sz": 64}, "vgg16": {"in_sz": 32}}


def _boda_tpu_forward(name):
    """The port's pipe (weights carried), the seeded input, the node set and
    boda_tpu's run of every node."""
    (jp, jd), (tp, td) = jbuild(name, img=2, **_FWD[name]), tbuild(name, img=2, **_FWD[name])
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    x = np.random.RandomState(3).randn(*jd["data"].shape).astype(np.float32)
    nodes = [n for n, nd in jp.nodes.items()
             if nd.dims is not None and n not in jp.weights and nd.top_for]
    je = jmake("conv_fwd", "pallas", kernel_policy="gen")
    je.init(jp)
    return tp, td, x, nodes, je.run_fwd({"data": JNDA(jd["data"], x)}, nodes)


@pytest.mark.parametrize("name", sorted(_FWD))
def test_forward_matches_boda_tpu(name):
    """The builder's f32 b2 forward, every node, on the port's engine
    (device=cpu: the kernels' plain versions; fused: fuse_block=1 and
    tune=(use_s2d=1,pool_pallas=1)) against boda_tpu's pallas engine under
    gen: comp_vars(mrd_toler=1e-5, atol=1e-5 * max|ref|), no element over."""
    tp, td, x, nodes, jr = _boda_tpu_forward(name)
    for policy, kw in (("gen", {}), ("fused", {"fuse_block": True, "tune": parse_lexp(
            "(use_s2d=1,pool_pallas=1)")})):
        te = tmake("conv_fwd", "cuda", device="cpu", **kw)
        te.init(tp)
        tr = te.run_fwd({"data": TNDA(td["data"], x)}, nodes)
        for n in nodes:
            a, b = jr[n].data, tr[n].data
            assert a.shape == b.shape, n
            r = comp_vars(a, b, mrd_toler=1e-5, atol=1e-5 * float(np.abs(a).max()))
            assert r.ok() and r.num_diff == 0, f"{policy} node {n}: {r}"
