"""The port's training step (boda_tpu_torch/parallel/train.py) against
boda_tpu's make_train_step, on the CPU.

mini_resnet b2 16x16 f32, boda_tpu's seeded weights carried into the port,
the batch and labels numpy from a seed; boda_tpu's step jitted. Both kernel
policies of the port (gen: the hand kernels' autograd Functions, here on
their plain versions; lib: autograd of the library rules). Gates: the loss
within 1e-5 relative; every weight, momentum and EMA statistic within 1e-5
of max|ref| after one step and 1e-4 after three (bf16 masters: 5e-2). A
bias ahead of train-mode BN has a zero gradient, so its step is rounding
noise: weights are held to the larger of max|ref| and the step's largest
update, momenta to the largest momentum.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.parallel.schedules import make_lr_schedule as jsched
from boda_tpu.parallel.train import make_train_step as jmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.parallel.schedules import make_lr_schedule as tsched
from boda_tpu_torch.parallel.train import make_train_step as tmake
from boda_tpu_torch.utils.carry import weights_from_numpy

CASES = {
    "plain": dict(lr=0.002),
    "mom_wd_clip": dict(lr=0.05, momentum=0.9, weight_decay=1e-3, clip_norm=1.0),
    "bn_train": dict(lr=0.05, clip_norm=1.0, bn_momentum=0.1),
    "bf16_masters": dict(lr=0.05, momentum=0.9, clip_norm=1.0, bn_momentum=0.1,
                         compute_dtype="bfloat16"),
    "cosine_warmup": dict(lr=0.05, momentum=0.9, clip_norm=1.0, schedule=True),
}


def _setup():
    jp = jbuild("mini_resnet", img=2, in_sz=16)[0]
    tp = tbuild("mini_resnet", img=2, in_sz=16)[0]
    W = {k: np.asarray(v.data, np.float32) for k, v in jp.weights.items()}
    weights_from_numpy(tp, W)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal((2, 3, 16, 16)).astype(np.float32) for _ in range(3)]
    ys = [rng.integers(0, 16, 2).astype(np.int32) for _ in range(3)]
    return jp, tp, W, xs, ys


def _jax_steps(jp, W, xs, ys, kw):
    kw = dict(kw)
    sched = kw.pop("schedule", False)
    if "compute_dtype" in kw:
        kw["compute_dtype"] = jnp.bfloat16
    if sched:
        kw["lr_schedule"] = jsched("cosine", kw["lr"], total_steps=4, warmup_steps=2)
    step = jax.jit(jmake(jp, "fc", **kw))
    w, m, out = {k: jnp.asarray(v) for k, v in W.items()}, None, []
    for i, (x, y) in enumerate(zip(xs, ys)):
        args = [w, {"data": jnp.asarray(x)}, jnp.asarray(y)]
        if kw.get("momentum"):
            args.append(m)
        r = step(*args, step=jnp.int32(i)) if sched else step(*args)
        loss, w = r[0], r[1]
        m = r[2] if kw.get("momentum") else None
        out.append((float(loss), {k: np.asarray(v, np.float32) for k, v in w.items()},
                    {k: np.asarray(v) for k, v in m.items()} if m else {}))
    return out


def _port_steps(tp, W, xs, ys, kw, policy, remat=""):
    kw = dict(kw)
    if kw.pop("schedule", False):
        kw["lr_schedule"] = tsched("cosine", kw["lr"], total_steps=4, warmup_steps=2)
    step = tmake(tp, "fc", kernel_policy=policy, remat=remat, **kw)
    w, m, out = {k: torch.from_numpy(v.copy()) for k, v in W.items()}, None, []
    for i, (x, y) in enumerate(zip(xs, ys)):
        args = [w, {"data": torch.from_numpy(x)}, torch.from_numpy(y)]
        if kw.get("momentum"):
            args.append(m)
        r = step(*args, step=i)
        loss, w = r[0], r[1]
        m = r[2] if kw.get("momentum") else None
        out.append((float(loss), {k: v.float().numpy() for k, v in w.items()},
                    {k: v.numpy() for k, v in m.items()} if m else {}))
    return out


def _close(got, ref, W, tol, what):
    """got/ref: (loss, weights, momentum) after one step."""
    (gl, gw, gm), (rl, rw, rm) = got, ref
    assert abs(gl - rl) <= tol * abs(rl), (what, gl, rl)
    upd = max(np.abs(rw[k] - W[k]).max() for k in W)
    for k in W:
        err = np.abs(gw[k] - rw[k]).max()
        assert err <= tol * max(np.abs(rw[k]).max(), upd), (what, k, err)
    mmax = max((np.abs(v).max() for v in rm.values()), default=0.0)
    assert set(gm) == set(rm)
    for k in rm:
        assert np.abs(gm[k] - rm[k]).max() <= tol * mmax, (what, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_boda_tpu(case):
    jp, tp, W, xs, ys = _setup()
    kw = CASES[case]
    ref = _jax_steps(jp, W, xs, ys, kw)
    bf16 = "compute_dtype" in kw
    for policy in ("gen", "lib"):
        got = _port_steps(tp, W, xs, ys, kw, policy)
        _close(got[0], ref[0], W, 5e-2 if bf16 else 1e-5, (case, policy, 1))
        _close(got[2], ref[2], W, 5e-2 if bf16 else 1e-4, (case, policy, 3))
        if "bn_momentum" in kw:  # the EMA moved the running stats, sf pinned to 1
            assert not np.array_equal(got[0][1]["bn1__means"], W["bn1__means"])
            assert np.all(got[0][1]["bn1__sf"] == 1)
        if bf16:  # f32 masters stay f32
            assert got[0][1]["conv1__filts"].dtype == np.float32


def test_remat_equals_no_remat():
    """seg (a checkpoint per spatial segment), full and dots recompute the
    same values: three steps bit-equal to no remat, both policies, with
    train-mode BN and momentum."""
    _, tp, W, xs, ys = _setup()
    kw = dict(lr=0.05, momentum=0.9, clip_norm=1.0, bn_momentum=0.1)
    for policy in ("gen", "lib"):
        base = _port_steps(tp, W, xs, ys, kw, policy)
        for remat in ("seg", "full", "dots"):
            got = _port_steps(tp, W, xs, ys, kw, policy, remat)
            for (gl, gw, gm), (bl, bw, bm) in zip(got, base):
                assert gl == bl, (policy, remat)
                assert all(np.array_equal(gw[k], bw[k]) for k in bw), (policy, remat)
                assert all(np.array_equal(gm[k], bm[k]) for k in bm), (policy, remat)
    with pytest.raises(ValueError, match="remat must be one of"):
        tmake(tp, "fc", remat="nope")


def _drop_net(NB, Dims):
    b = NB("dropnet")
    t = b.input("data")
    t = b.conv("conv1", t, 8, 3, pad=1, in_chans=3)
    t = b.relu("relu1", t)
    t = b.dropout("drop1", t, ratio=0.3)
    t = b.pool("pool1", t, kern=3, stride=2)
    t = b.conv("conv2", t, 16, 5, stride=2, pad=2, in_chans=8)
    t = b.relu("relu2", t)
    t = b.pool("pool2", t, kern=4, stride=4, avg=True)
    t = b.fc("fc1", t, 10, in_feats=16)
    t = b.dropout("drop2", t)
    b.softmax("prob", t)
    return b.done({"data": Dims.of(img=2, chan=3, y=16, x=16)})


def test_dropout_with_injected_jax_mask():
    """Train-mode Dropout on a 4D activation and on the fc output, with
    boda_tpu's jax.random masks injected through the port's hook (seed 42 +
    the op name's hash, the logical NCHW shape): the step equals boda_tpu's
    within 1e-5, and so does the engine's forward with ``train=1`` against
    boda_tpu's ``xla`` engine, before and after ``set_det_drop_seed``; the
    port's own masks are fixed per op and seed."""
    from boda_tpu.models.zoo import NetBuilder as JNB
    from boda_tpu.utils.dims import Dims as JDims
    from boda_tpu_torch.graph import lowering_nhwc
    from boda_tpu_torch.models.zoo import NetBuilder as TNB
    from boda_tpu_torch.utils.dims import Dims as TDims
    from boda_tpu_torch.utils.dims import stable_hash
    jp, tp = _drop_net(JNB, JDims), _drop_net(TNB, TDims)
    W = {k: np.asarray(v.data, np.float32) for k, v in jp.weights.items()}
    weights_from_numpy(tp, W)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    y = np.array([3, 7], np.int32)
    kw = dict(lr=0.05, momentum=0.9, clip_norm=1.0)
    logits = "drop2"  # the softmax's input
    jl, jw, jm = jax.jit(jmake(jp, logits, **kw))(
        {k: jnp.asarray(v) for k, v in W.items()}, {"data": jnp.asarray(x)}, jnp.asarray(y))
    seen = {}

    def hook(name, seed, shape, keep):
        seen.setdefault(name, (seed, shape))  # the step's, before the engine's
        return np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), keep, shape))
    old, lowering_nhwc.DROPOUT_MASK_HOOK = lowering_nhwc.DROPOUT_MASK_HOOK, hook
    try:
        for policy in ("gen", "lib"):
            tl, tw, tm = tmake(tp, logits, kernel_policy=policy, **kw)(
                {k: torch.from_numpy(v.copy()) for k, v in W.items()},
                {"data": torch.from_numpy(x)}, torch.from_numpy(y))
            _close((float(tl), {k: v.numpy() for k, v in tw.items()},
                    {k: v.numpy() for k, v in tm.items()}),
                   (float(jl), {k: np.asarray(v) for k, v in jw.items()},
                    {k: np.asarray(v) for k, v in jm.items()}), W, 1e-5, policy)
        from boda_tpu.config import make as jmk
        from boda_tpu.utils.dims import NDA as JNDA
        from boda_tpu_torch.config import make as tmk
        from boda_tpu_torch.utils.dims import NDA as TNDA
        d = jp.nodes["data"].dims
        je = jmk("conv_fwd", "xla", train=True, det_drop_seed=7)
        te = tmk("conv_fwd", "cuda", device="cpu", train=True, det_drop_seed=7)
        je.init(jp)
        te.init(tp)
        outs = []
        for seed in (7, 8):
            if seed == 8:
                je.set_det_drop_seed(8)
                te.set_det_drop_seed(8)
            jo = je.run_fwd({"data": JNDA(d, x)}, ["drop1", "drop2"])
            to = te.run_fwd({"data": TNDA(tp.nodes["data"].dims, x)}, ["drop1", "drop2"])
            for n in ("drop1", "drop2"):
                ref = jo[n].data
                assert np.abs(to[n].data - ref).max() <= 1e-5 * np.abs(ref).max(), (seed, n)
            outs.append(to["drop1"].data)
        assert not np.array_equal(outs[0], outs[1])
    finally:
        lowering_nhwc.DROPOUT_MASK_HOOK = old
    assert seen == {"drop1": (42 + (stable_hash("drop1") & 0xFFFF), (2, 8, 16, 16)),
                    "drop2": (42 + (stable_hash("drop2") & 0xFFFF), (2, 10))}
    m1 = lowering_nhwc.dropout_mask("drop1", 5, (2, 8, 4, 4), 0.7)
    assert torch.equal(m1, lowering_nhwc.dropout_mask("drop1", 5, (2, 8, 4, 4), 0.7))
    assert 0.5 < m1.float().mean() < 0.9
