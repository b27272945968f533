"""The compiled training step's body on the CPU (parallel/train.py:
CapturedStep): the static-buffer step that the card captures as one CUDA
graph, run eagerly here, against boda_tpu's step jitted with its weights and
momentum donated, as boda_tpu's train_lmdb runs it, and against the port's
eager step, bit for bit.

mini_resnet b2 16x16 f32 as tests/test_torch_train_step.py sets it up (its
five cases and tolerances: 1e-5 after one step, 1e-4 after three, 5e-2 for
bf16 masters). Then the donation contract (the returned weights and momenta
are the step's static tensors; a call with them copies nothing in; a foreign
state is copied in; the losses of a chain stay distinct), the learning rate
and decay held as 0-dim tensors, the eager steps under a gloo group or a
tp row over two cards saying why, and the key cache: a new batch shape
captures anew, a new ``step=`` does not.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from boda_tpu.parallel.schedules import make_lr_schedule as jsched
from boda_tpu.parallel.train import make_train_step as jmake
from boda_tpu_torch.parallel import train as ptrain
from boda_tpu_torch.parallel.schedules import make_lr_schedule as tsched
from boda_tpu_torch.parallel.train import make_train_step as tmake
from test_torch_train_step import CASES, _close, _setup


def _jax_donated(jp, W, xs, ys, kw):
    """boda_tpu's step under jax.jit(step, donate_argnums=(0, 3)) (boda_tpu/
    modes/train_lmdb.py), three steps: (loss, weights, momenta) per step."""
    kw = dict(kw)
    sched = kw.pop("schedule", False)
    if "compute_dtype" in kw:
        kw["compute_dtype"] = jnp.bfloat16
    if sched:
        kw["lr_schedule"] = jsched("cosine", kw["lr"], total_steps=4, warmup_steps=2)
    mom = bool(kw.get("momentum"))
    step = jax.jit(jmake(jp, "fc", **kw), donate_argnums=(0, 3) if mom else (0,))
    w, m, out = {k: jnp.asarray(v) for k, v in W.items()}, None, []
    for i, (x, y) in enumerate(zip(xs, ys)):
        args = [w, {"data": jnp.asarray(x)}, jnp.asarray(y)] + ([m] if mom else [])
        r = step(*args, step=jnp.int32(i)) if sched else step(*args)
        loss, w, m = r[0], r[1], (r[2] if mom else None)
        out.append((float(loss), {k: np.asarray(v, np.float32) for k, v in w.items()},
                    {k: np.asarray(v) for k, v in m.items()} if mom else {}))
    return out


def _runs(tp, W, xs, ys, kw, policy):
    """Three steps of the port's eager step and of its static-buffer body:
    per step (loss, weights, momenta) as tensors (the body's copied out of
    its static tensors)."""
    kw = dict(kw)
    if kw.pop("schedule", False):
        kw["lr_schedule"] = tsched("cosine", kw["lr"], total_steps=4, warmup_steps=2)
    step = tmake(tp, "fc", kernel_policy=policy, cuda_graph=True, **kw)
    out = []
    for fn in (step, step.captured):
        w, m, res = {k: torch.from_numpy(v.copy()) for k, v in W.items()}, None, []
        for i, (x, y) in enumerate(zip(xs, ys)):
            r = fn(w, {"data": torch.from_numpy(x)}, torch.from_numpy(y), m, step=i)
            w, m = r[1], (r[2] if len(r) > 2 else None)
            res.append((r[0], {k: v.clone() for k, v in w.items()},
                        {k: v.clone() for k, v in (m or {}).items()}))
        out.append(res)
    return out


def _np(r):
    loss, w, m = r
    return (float(loss), {k: v.float().numpy() for k, v in w.items()},
            {k: v.numpy() for k, v in m.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_step_matches_donated_jit(case):
    """The static-buffer body against boda_tpu's donated, jitted step after
    one and three steps, both kernel policies, and bit-equal to the port's
    eager step at every step (its learning rate and decay as 0-dim tensors
    against the eager step's floats)."""
    jp, tp, W, xs, ys = _setup()
    kw = CASES[case]
    ref = _jax_donated(jp, W, xs, ys, kw)
    bf16 = "compute_dtype" in kw
    for policy in ("gen", "lib"):
        eager, static = _runs(tp, W, xs, ys, kw, policy)
        _close(_np(static[0]), ref[0], W, 5e-2 if bf16 else 1e-5, (case, policy, 1))
        _close(_np(static[2]), ref[2], W, 5e-2 if bf16 else 1e-4, (case, policy, 3))
        for i, ((el, ew, em), (sl, sw, sm)) in enumerate(zip(eager, static)):
            assert torch.equal(el, sl), (case, policy, i)
            assert all(torch.equal(ew[k], sw[k]) and ew[k].dtype == sw[k].dtype
                       for k in ew), (case, policy, i)
            assert set(em) == set(sm) and all(torch.equal(em[k], sm[k]) for k in em)


def test_donation_and_rates():
    """The returned weights and momenta are the static tensors; a call with
    them copies nothing in, a foreign weight or momentum is copied in
    (``copies``); the losses kept over a chain are distinct values, each
    the eager step's; the lr and decay tensors hold the schedule's f32
    values, and after a reload from foreign state the body repeats the
    eager step bit for bit."""
    _, tp, W, xs, ys = _setup()
    kw = dict(lr=0.05, momentum=0.9, weight_decay=1e-3, clip_norm=1.0, bn_momentum=0.1,
              lr_schedule=tsched("cosine", 0.05, total_steps=4, warmup_steps=2))
    step = tmake(tp, "fc", cuda_graph=True, **kw)
    cap = step.captured
    w0 = {k: torch.from_numpy(v.copy()) for k, v in W.items()}
    feeds = [({"data": torch.from_numpy(x)}, torch.from_numpy(y)) for x, y in zip(xs, ys)]
    losses, w, m = [], w0, None
    for i, (x, y) in enumerate(feeds):
        loss, w, m = cap(w, x, y, m, step=i)
        assert all(w[k] is cap.w[k] for k in W) and all(m[k] is cap.m[k] for k in m)
        assert cap.copies == len(W)  # the first call's weights; zeros for None
        assert cap.lr.dtype == torch.float32 and cap.lr.dim() == 0
        assert float(cap.lr) == float(kw["lr_schedule"](i))
        assert float(cap.c) == float(np.float32(kw["lr_schedule"](i)) * np.float32(1e-3))
        losses.append(loss)
    ew, em, eager = w0, None, []
    for i, (x, y) in enumerate(feeds):
        loss, ew, em = step(ew, x, y, em, step=i)
        eager.append(loss)
    assert len({float(v) for v in losses}) == 3
    assert all(torch.equal(a, b) for a, b in zip(losses, eager))
    assert all(torch.equal(w[k], ew[k]) for k in W) and all(torch.equal(m[k], em[k]) for k in m)
    # a foreign state: every weight and momentum copied in, then the same step
    fw, fm = {k: v.clone() for k, v in ew.items()}, {k: v.clone() for k, v in em.items()}
    loss, w, m = cap(fw, *feeds[0], fm, step=3)
    assert cap.copies == 2 * len(W) + len(m)
    el, ew2, _ = step(fw, *feeds[0], fm, step=3)
    assert torch.equal(loss, el) and all(torch.equal(w[k], ew2[k]) for k in W)
    assert not torch.equal(fw["fc__filts"], w["fc__filts"])  # the foreign state untouched


def test_eager_under_mesh_or_group_and_key_cache(monkeypatch, tmp_path):
    """A step under a mesh whose tp row lies on one device keeps its body
    (``captured``) and says nothing; a row over two cards and a gloo group
    each keep the body too (the CPU tests run it) but stay eager on CUDA
    tensors, each saying why once in its info_log; a step on CPU tensors
    runs eagerly whatever ``cuda_graph`` says. The key cache, with the
    capture function spied on: the first call captures, a new ``step=``
    does not, a new batch shape does (and its results are the eager
    step's), and the remat modes' bodies are their eager steps."""
    import torch.distributed as dist
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.parallel.mesh import make_mesh
    _, tp, W, xs, ys = _setup()
    row = "eager on CUDA tensors: this rank's tp row spans 2 devices"
    gloo = "eager on CUDA tensors: the process group's backend is gloo"

    def count(step, line):
        return sum(ln.startswith(line) for ln in step.info_log)
    mstep = tmake(tp, "fc", mesh=make_mesh({"tp": 1}, kind="cpu"), cuda_graph=True)
    assert mstep.captured is not None and not any(ln.startswith("eager")
                                                  for ln in mstep.info_log)
    two = make_mesh({"tp": 2}, devices=["cuda:0", "cuda:1"])
    rstep = tmake(tp, "fc", mesh=two, cuda_graph=True)
    assert rstep.captured is not None and count(rstep, row) == 1
    assert count(tmake(tp, "fc", mesh=two), row) == 0
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", world_size=1, rank=0)
    try:
        gstep = tmake(tp, "fc", group=dist.group.WORLD, cuda_graph=True)
        assert gstep.captured is not None and count(gstep, gloo) == 1
        assert count(tmake(tp, "fc", group=dist.group.WORLD), gloo) == 0
    finally:
        dist.destroy_process_group()

    seen = []
    real = ptrain.capture_step

    def spy(body, warm, device):
        seen.append(device)
        return real(body, warm, device)
    monkeypatch.setattr(ptrain, "capture_step", spy)
    step = tmake(tp, "fc", lr=0.05, momentum=0.9, bn_momentum=0.1, cuda_graph=True,
                 lr_schedule=tsched("step", 0.05, step_size=1, gamma=0.5))
    w, m = {k: torch.from_numpy(v.copy()) for k, v in W.items()}, None
    step(w, {"data": torch.from_numpy(xs[0])}, torch.from_numpy(ys[0]), m, step=0)
    assert seen == []  # CPU tensors: the eager step
    for i in range(3):
        _, w, m = step.captured(w, {"data": torch.from_numpy(xs[i])}, torch.from_numpy(ys[i]),
                                m, step=i)
    assert seen == [torch.device("cpu")] and step.captured.captures == 1
    p4, d4 = build_model("mini_resnet", img=4, in_sz=16)
    x4 = torch.from_numpy(np.random.default_rng(5).standard_normal(d4["data"].shape)
                          .astype(np.float32))
    y4 = torch.tensor([1, 2, 3, 4])
    fw, fm = {k: v.clone() for k, v in w.items()}, {k: v.clone() for k, v in m.items()}
    cl, cw, _ = step.captured(fw, {"data": x4}, y4, fm, step=3)
    assert len(seen) == 2 and step.captured.captures == 2
    el, ew, _ = step(fw, {"data": x4}, y4, fm, step=3)
    assert torch.equal(cl, el) and all(torch.equal(cw[k], ew[k]) for k in ew)
    for remat in ("seg", "full", "dots"):
        rs = tmake(tp, "fc", lr=0.05, momentum=0.9, bn_momentum=0.1, remat=remat,
                   cuda_graph=True)
        a = rs(fw, {"data": x4}, y4, fm)
        b = rs.captured(fw, {"data": x4}, y4, fm)
        assert torch.equal(a[0], b[0]) and all(torch.equal(a[1][k], b[1][k]) for k in fw), remat


def test_bf16_weights_round_into_static():
    """Weights in bf16 (chip_smoke's and train_bench's ResNet-50 step):
    the body rounds each updated weight and running statistic straight
    into its static tensor, bit-equal to the eager step's ``to`` over three
    steps, and returns those tensors; ``make_train_step`` is eager unless
    ``cuda_graph`` is asked for (the modes' Field asks)."""
    _, tp, W, xs, ys = _setup()
    kw = dict(lr=0.05, momentum=0.9, clip_norm=1.0, bn_momentum=0.1)
    assert tmake(tp, "fc", **kw).captured is None
    step = tmake(tp, "fc", cuda_graph=True, **kw)
    cap = step.captured
    w0 = {k: torch.from_numpy(v.copy()).to(torch.bfloat16) for k, v in W.items()}
    ew, em, cw, cm = w0, None, w0, None
    for i, (x, y) in enumerate(zip(xs, ys)):
        el, ew, em = step(ew, {"data": torch.from_numpy(x)}, torch.from_numpy(y), em)
        cl, cw, cm = cap(cw, {"data": torch.from_numpy(x)}, torch.from_numpy(y), cm)
        assert torch.equal(el, cl), i
        assert all(cw[k] is cap.w[k] and cw[k].dtype == torch.bfloat16 and
                   torch.equal(ew[k], cw[k]) for k in W), i
        assert all(torch.equal(em[k], cm[k]) for k in em), i
    assert any(k.endswith("__means") for k in W) and cap.copies == len(W)


def test_failed_op_named():
    """An exception raised in an op of the net carries the note naming it,
    and one raised in the backward says so (a failed capture reports the
    notes, parallel/train.py:capture_step)."""
    _, tp, W, xs, ys = _setup()
    orig = ptrain._lower_train
    first = next(o for o in tp.topo_op_order() if tp.ops[o].type == "Convolution")
    w = {k: torch.from_numpy(v.copy()) for k, v in W.items()}
    args = ({"data": torch.from_numpy(xs[0])}, torch.from_numpy(ys[0]))

    def planted(where):
        def lower(p, op, ctx, gen, info_log):
            fn, preps = orig(p, op, ctx, gen, info_log)
            if op.name != first:
                return fn, preps

            class Fails(torch.autograd.Function):
                @staticmethod
                def forward(ctx, *a):
                    if where == "forward":
                        raise RuntimeError("planted")
                    return fn(*a)[0]

                @staticmethod
                def backward(ctx, g):
                    raise RuntimeError("planted")
            return (lambda *a: (Fails.apply(*a),)), preps
        return lower
    for where, notes in (("forward", [f"at op {first!r}"]), ("backward", ["in the backward"])):
        ptrain._lower_train = planted(where)
        try:
            step = tmake(tp, "fc", lr=0.05)
        finally:
            ptrain._lower_train = orig
        with pytest.raises(RuntimeError, match="planted") as ei:
            step(w, *args)
        assert ei.value.__notes__ == notes, where
