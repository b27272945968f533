"""What a CUDA-graph capture of the forward needs, held on the CPU.

A capture records kernels and cannot copy a host value to the card, so
nothing in a forward may make a device tensor from a Python or numpy value
per call. Two places did: ``jax_maximum`` with a Python float (the ReLU
rule, every Bck recompute of a ReLU, SoftmaxWithLoss) and the avg pool's
divisor. Here their values, NaN and gradients are held against
``jnp.maximum`` and the divisor's cache against inference_mode; a CPU
engine under ``cuda_graph=1`` runs eagerly, since there is no card to
capture on (the capture itself is held on the card, in
tests/test_torch_cuda_graph.py and tests/test_torch_cuda_ssd.py); and the
ssd300 forward, the SSD head's constants included, makes no tensor from
host data and moves none between devices once the engine is built. Also
the int8 weight cache, which an in-place update of a weight (an optimizer
step) must not leave stale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.graph.lowering import jax_maximum
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.ops.kernels import pool
from boda_tpu_torch.modes.cnet import gen_data_inputs
from boda_tpu_torch.utils.dims import NDA as TNDA


def test_jax_maximum_with_a_float_keeps_value_nan_and_gradient():
    """jnp.maximum(x, 0.0): the same values (NaN propagates) and JAX's
    gradient, half the cotangent at a tie; the float stays a host scalar."""
    x = np.array([-2.0, -0.0, 0.0, 0.5, np.nan, 3.0, 0.0], np.float32)
    ct = np.arange(1, 8, dtype=np.float32)
    want = np.asarray(jnp.maximum(jnp.asarray(x), 0.0))
    want_g = np.asarray(jax.grad(lambda v: jnp.sum(jnp.maximum(v, 0.0) * ct))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = jax_maximum(xt, 0.0)
    np.testing.assert_array_equal(out.detach().numpy(), want)  # NaN == NaN here
    (out * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_array_equal(np.nan_to_num(xt.grad.numpy(), nan=-1.0),
                                  np.nan_to_num(want_g, nan=-1.0))
    with torch.no_grad():
        np.testing.assert_array_equal(jax_maximum(torch.from_numpy(x), 0.0).numpy(), want)


def test_avg_divisor_is_made_once_and_enters_autograd():
    """The divisor is one tensor per geometry and device, made outside
    inference_mode even when first asked for inside it, so a later autograd
    graph (the pool's backward) takes it."""
    geom = (9, 7, (3, 3), (2, 2), (1, 1), 5, 4)
    with torch.inference_mode():
        d1 = pool._divisor(torch.device("cpu"), *geom, True)
    assert not d1.is_inference() and d1.shape == (5, 4)
    assert pool._divisor(torch.device("cpu"), *geom, True) is d1
    np.testing.assert_array_equal(d1.numpy(), 1.0 / pool.avg_divisor(*geom))
    x = torch.randn(1, 9, 7, 4, requires_grad=True)
    pad_y, pad_x = (1, 1), (1, 1)
    y = pool.pool2d_lib(x, (3, 3), (2, 2), pad_y, pad_x, 5, 4, True)
    y.sum().backward()
    assert bool(torch.isfinite(x.grad).all()) and float(x.grad.abs().sum()) > 0


def test_cpu_engine_runs_eagerly_under_cuda_graph():
    """cuda_graph=1 (the default) on a CPU engine captures nothing and gives
    what cuda_graph=0 gives; init drops any graph."""
    pipe, dims = tbuild("mini_resnet", img=1, num_cls=8, in_sz=16)
    x = {"data": TNDA(dims["data"], np.random.RandomState(3).randn(
        *dims["data"].shape).astype(np.float32))}
    outs = []
    for cg in (True, False):
        eng = tmake("conv_fwd", "cuda", device="cpu", cuda_graph=cg)
        eng.init(pipe)
        outs.append(eng.run_fwd(x, ["prob"])["prob"].data)
        assert eng._graph is None
    np.testing.assert_array_equal(outs[0], outs[1])
    eng.prepare(x, ["prob"])  # compiles only: no warm-up off the card
    assert eng._warm_key is None


def test_ssd300_forward_makes_no_host_tensor(monkeypatch):
    """The whole ssd300 forward, Normalize, the PriorBox tables and
    DetectionOutput's NMS head included, run with the calls that would copy
    host data to the card spied on: ``torch.tensor`` of more than a scalar
    (a 0-dim host scalar is a kernel argument), ``torch.as_tensor``,
    ``torch.from_numpy``, and ``Tensor.to``/``.cuda`` with a device. None is
    made: the tables, labels and image ids were put on the device at init."""
    pipe, dims = tbuild("ssd300", img=2)
    eng = tmake("conv_fwd", "cuda", device="cpu")
    eng.init(pipe)
    outs = ["detection_out", "mbox_priorbox", "conv4_3_norm"]
    eng.compile_for(outs)
    ins = eng._put_inputs(gen_data_inputs(dims))
    seen = []

    def spy(name, f, bad):
        def wrapped(*a, **kw):
            if bad(a, kw):
                seen.append(name)
            return f(*a, **kw)
        return wrapped

    def dev_arg(a, kw):
        return "device" in kw or any(isinstance(v, (str, torch.device)) for v in a[1:])
    monkeypatch.setattr(torch, "tensor", spy("tensor", torch.tensor,
                                             lambda a, kw: np.ndim(a[0]) > 0))
    monkeypatch.setattr(torch, "as_tensor", spy("as_tensor", torch.as_tensor, lambda a, kw: True))
    monkeypatch.setattr(torch, "from_numpy", spy("from_numpy", torch.from_numpy,
                                                 lambda a, kw: True))
    monkeypatch.setattr(torch.Tensor, "to", spy("Tensor.to", torch.Tensor.to, dev_arg))
    monkeypatch.setattr(torch.Tensor, "cuda", spy("Tensor.cuda", torch.Tensor.cuda,
                                                  lambda a, kw: True))
    with eng._run_ctx():
        res = eng._fn(eng._weights_dev, ins)
    monkeypatch.undo()
    assert seen == []
    det = res["detection_out"].reshape(-1, 7)
    assert det.shape == (400, 7) and set(det[:, 0].tolist()) == {0.0, 1.0}
    assert int((det[:, 1] >= 0).sum()) > 0


def test_int8_weight_cache_follows_in_place_updates():
    """quant_weight's cache is keyed by the tensor and its version: after an
    in-place update the next call quantizes the new values; an unchanged
    tensor keeps its entry."""
    from boda_tpu_torch.ops import int8 as q8
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((3, 3, 5, 7)).astype(np.float32))
    cache = q8.weight_cache()
    wq0, _ = q8.quant_weight(w, (0, 1, 2), cache)
    assert q8.quant_weight(w, (0, 1, 2), cache)[0] is wq0
    step = torch.from_numpy(rng.standard_normal(w.shape).astype(np.float32))
    w.sub_(0.3 * step)  # an in-place SGD-style update
    wq1, ws1 = q8.quant_weight(w, (0, 1, 2), cache)
    fresh_q, fresh_s = q8.quant_weight(w.clone(), (0, 1, 2))
    assert not torch.equal(wq1, wq0)
    assert torch.equal(wq1, fresh_q) and torch.equal(ws1, fresh_s)
    assert q8.quant_weight(w, (0, 1, 2), cache)[0] is wq1
