"""Caffe nets on the card: the testdata nets (read by the port's frontend,
shapesnet{,2,3} with their trained caffemodels, tinynet seeded) and
GoogLeNet at b2 f32, 224x224, under gen on the card against the same engine
on the CPU (every kernel's plain version), every node within 1e-4 of
max|ref|; and each captured forward (GoogLeNet's four-branch Concats
included) replayed bit-equal to an eager forward, launching the same
kernels.

These tests need an NVIDIA GPU with nvcc; elsewhere they skip. On the
machine with the card, from the repo root:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_caffe.py``.
"""

import os

import numpy as np
import pytest
import torch

from boda_tpu_torch.config import make
from boda_tpu_torch.modes.cnet import gen_data_inputs, load_net
from boda_tpu_torch.ops.kernels import conv, pool, sgemm
from boda_tpu_torch.utils.lexp import parse_lexp

pytestmark = pytest.mark.cuda

NETS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "testdata", "nets")
# f32, every node, card vs CPU: the kernels run full f32 and the library's
# f32 ops are set to full f32 (precision=highest); sums differ in order only
TOL = 1e-4
_NETS = {"tinynet": "", "shapesnet": "shapesnet.caffemodel",
         "shapesnet2": "shapesnet2.caffemodel", "shapesnet3": "shapesnet3.caffemodel",
         "googlenet_conv": None}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def _nodes(pipe):
    return [n for n, nd in pipe.nodes.items()
            if nd.dims is not None and n not in pipe.weights and nd.top_for]


@pytest.mark.parametrize("name", sorted(_NETS))
def test_caffe_net_on_card(dev, name):
    for policy in ("gen", "fused"):
        _on_card(name, policy)


def _on_card(name, policy):
    cm = _NETS[name]
    if cm is None:
        pipe, dims = load_net(name, img=2)
    else:
        pipe, dims = load_net(ptt_fn=os.path.join(NETS, f"{name}.prototxt"),
                              weights_fn=os.path.join(NETS, cm) if cm else "", img=0)
    ins, nodes = gen_data_inputs(dims), _nodes(pipe)
    kw = {"fuse_block": True, "tune": parse_lexp("(use_s2d=1,pool_pallas=1)")} \
        if policy == "fused" else {}
    ref = make("conv_fwd", "cuda", device="cpu", **kw)
    ref.init(pipe)
    want = ref.run_fwd(ins, nodes)
    e = make("conv_fwd", "cuda", **kw)
    e.init(pipe)
    e.cuda_graph = False
    eager = e.run_fwd(ins, nodes)
    e.cuda_graph = True
    e.prepare(ins, nodes)
    counters = (sgemm.matmul, conv.conv2d, pool.pool2d)
    for f in counters:
        f.launches = 0
    got = e.run_fwd(ins, nodes)
    launches = [f.launches for f in counters]
    assert launches[0] + launches[1] > 0, launches
    if policy == "fused":
        assert launches[2] == sum(o.type == "Pooling" for o in pipe.ops.values())
    for n in nodes:
        a, b = want[n].data, got[n].data
        assert np.isfinite(b).all(), n
        err = float(np.abs(a - b).max()) / max(float(np.abs(a).max()), 1e-30)
        assert err <= TOL, f"{name} {policy} node {n}: {err:.3g}"
        assert np.array_equal(b, eager[n].data), f"{name} {policy} node {n}: replay != eager"
