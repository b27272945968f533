"""Tensor parallelism in the port's training step (parallel/train.py with a
``mesh``) against boda_tpu's GSPMD-sharded step, on the CPU.

boda_tpu's side jits its step with the weights split over out_chan on tp
and the batch over dp (tests/test_parallel.py:44-73, the 8 virtual CPU
devices of tests/conftest.py); the port's holds the split weights as
``Shards`` on its tp row, every shard on the CPU, and runs each rank of dp
as a process of a gloo group (tests/test_torch_dist.py's way). mini_resnet
b8 16x16 f32, boda_tpu's seeded weights carried into the port, three
seeded batches, momentum 0.9, clip 1, train-mode BN, both kernel policies
(gen on the plain versions of the hand kernels). Gates: test_torch_train_step.py's
``_close`` at 1e-5 after one step and 1e-4 after three; remat=dots on
(dp=2,tp=4) against boda_tpu's test_remat_composes_with_sharding case at
1e-5; a (tp=1) mesh bit-equal to no mesh; the mesh errors; a sharded
checkpoint written as the unsharded one and restored onto the mesh.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.parallel import mesh as jmesh
from boda_tpu.parallel.train import make_train_step as jmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.parallel import mesh as tmesh
from boda_tpu_torch.parallel.checkpoint import load_checkpoint, save_checkpoint
from boda_tpu_torch.parallel.train import make_train_step as tmake
from boda_tpu_torch.utils.carry import weights_from_numpy
from test_torch_train_step import _close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMG, STEPS = 8, 3
KW = dict(lr=0.05, momentum=0.9, clip_norm=1.0, bn_momentum=0.1, precision="highest")
REMAT_KW = dict(lr=0.01, precision="highest")  # test_remat_composes_with_sharding's

# the port's steps on one rank of a (dp, tp) mesh of CPU devices, both
# policies; run in this process (dp 1) or in each rank's (dp > 1)
_PORT = """
import numpy as np, torch
from boda_tpu_torch.models.zoo import build_model
from boda_tpu_torch.parallel.mesh import gather_weights, make_mesh, shard_weights
from boda_tpu_torch.parallel.train import make_train_step
from boda_tpu_torch.utils.carry import weights_from_numpy


def port_run(rank, dp, tp, src, kw, remat, group):
    z = np.load(src)
    W = {k[2:]: z[k] for k in z.files if k.startswith("w_")}
    pipe = build_model("mini_resnet", img=z["xs"].shape[1] // dp, num_cls=16, in_sz=16)[0]
    weights_from_numpy(pipe, W)
    mesh = make_mesh({"dp": dp, "tp": tp}, devices=["cpu"] * (dp * tp))
    per = z["xs"].shape[1] // dp
    out = {}
    for pol in ("gen", "lib"):
        step = make_train_step(pipe, "fc", kernel_policy=pol, remat=remat, group=group,
                               mesh=mesh, **kw)
        w = shard_weights({k: torch.from_numpy(v.copy()) for k, v in W.items()}, pipe, mesh,
                          rank)
        m = None
        for i in range(z["xs"].shape[0]):
            x = torch.from_numpy(z["xs"][i, rank * per:(rank + 1) * per])
            y = torch.from_numpy(z["ys"][i, rank * per:(rank + 1) * per])
            r = step(w, {"data": x}, y, m) if kw.get("momentum") else step(w, {"data": x}, y)
            w, m = r[1], (r[2] if kw.get("momentum") else {})
            out[f"{pol}/{i}/loss"] = r[0].numpy()
            for k, v in gather_weights(w).items():
                out[f"{pol}/{i}/w/{k}"] = v.float().numpy()
            for k, v in gather_weights(m).items():
                out[f"{pol}/{i}/m/{k}"] = v.numpy()
    return out
"""

_RANK = _PORT + """
import json, sys
import torch.distributed as dist
rank, world, tp, port, src, out, kw, remat = sys.argv[1:9]
rank, world, tp = int(rank), int(world), int(tp)
dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                        world_size=world, rank=rank)
res = port_run(rank, world, tp, src, json.loads(kw), remat, dist.group.WORLD)
if rank == 0:
    np.savez(out, **res)
dist.destroy_process_group()
"""


def _setup(img=IMG, steps=STEPS):
    jp = jbuild("mini_resnet", img=img, num_cls=16, in_sz=16)[0]
    W = {k: np.asarray(v.data, np.float32) for k, v in jp.weights.items()}
    rng = np.random.default_rng(1)
    xs = rng.standard_normal((steps, img, 3, 16, 16)).astype(np.float32)
    ys = rng.integers(0, 16, (steps, img)).astype(np.int32)
    return jp, W, xs, ys


def _jax_sharded(jp, W, xs, ys, dp, tp, kw, remat=""):
    """boda_tpu's step jitted over the (dp, tp) mesh of the 8 CPU devices:
    weights (and momenta) split by weight_shardings, the batch over dp."""
    mesh = jmesh.make_mesh({"dp": dp, "tp": tp})
    w_sh = jmesh.weight_shardings(jp, mesh)
    d_sh = jmesh.input_shardings({"data": jp.nodes["data"].dims}, mesh)["data"]
    l_sh = jmesh.named_sharding(mesh, "dp")
    mom = bool(kw.get("momentum"))
    step = jmake(jp, "fc", remat=remat, **kw)
    m_sh = {k: w_sh[k] for k in W if not k.endswith(("__means", "__vars", "__sf"))}
    ins = (w_sh, {"data": d_sh}, l_sh) + ((m_sh,) if mom else ())
    outs = (jmesh.named_sharding(mesh), w_sh) + ((m_sh,) if mom else ())
    jstep = jax.jit(step, in_shardings=ins, out_shardings=outs)
    w = {k: jax.device_put(v, w_sh[k]) for k, v in W.items()}
    m = {k: jax.device_put(np.zeros_like(W[k]), m_sh[k]) for k in m_sh}
    res = []
    with mesh:
        for x, y in zip(xs, ys):
            args = (w, {"data": jax.device_put(x, d_sh)}, jax.device_put(y, l_sh))
            r = jstep(*args, m) if mom else jstep(*args)
            w, m = r[1], (r[2] if mom else {})
            res.append((float(r[0]), {k: np.asarray(v, np.float32) for k, v in w.items()},
                        {k: np.asarray(v) for k, v in m.items()}))
    return res


def _port(tmp_path, W, xs, ys, dp, tp, kw, remat=""):
    """The port's steps, gen and lib: {policy: [(loss, weights, momenta)] per step}."""
    import json
    src = tmp_path / "src.npz"
    np.savez(src, xs=xs, ys=ys, **{"w_" + k: v for k, v in W.items()})
    if dp == 1:
        ns: dict = {}
        exec(_PORT, ns)
        res = ns["port_run"](0, 1, tp, str(src), kw, remat, None)
    else:
        from boda_tpu_torch.modes.dist_modes import _free_port
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        port, out = str(_free_port()), tmp_path / "out.npz"
        procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), str(dp), str(tp), port,
                                   str(src), str(out), json.dumps(kw), remat],
                                  cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(dp)]
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log
        res = dict(np.load(out))
    got = {}
    for pol in ("gen", "lib"):
        got[pol] = []
        for i in range(len(xs)):
            def part(what):
                pre = f"{pol}/{i}/{what}/"
                return {k[len(pre):]: np.asarray(v) for k, v in res.items() if k.startswith(pre)}
            got[pol].append((float(res[f"{pol}/{i}/loss"]), part("w"), part("m")))
    return got


@pytest.mark.parametrize("dp,tp", [(2, 4), (8, 1), (1, 8)])
def test_tp_step_matches_boda_tpus_sharded_step(tmp_path, dp, tp):
    jp, W, xs, ys = _setup()
    ref = _jax_sharded(jp, W, xs, ys, dp, tp, KW)
    got = _port(tmp_path, W, xs, ys, dp, tp, KW)
    for pol in ("gen", "lib"):
        _close(got[pol][0], ref[0], W, 1e-5, (dp, tp, pol, 1))
        _close(got[pol][2], ref[2], W, 1e-4, (dp, tp, pol, 3))
        assert not np.array_equal(got[pol][0][1]["bn1__means"], W["bn1__means"])
    assert got["gen"][2][0] < got["gen"][0][0]  # learns on the batches


def test_remat_dots_on_dp2_tp4(tmp_path):
    """boda_tpu's test_remat_composes_with_sharding case (lr 0.01, plain SGD,
    remat=dots, (dp=2,tp=4)): the port's remat=dots step on the same mesh
    against boda_tpu's sharded remat step. Under the selective policy the
    kept values are the slices' own conv and matmul outputs."""
    jp, W, xs, ys = _setup(img=4, steps=1)
    ref = _jax_sharded(jp, W, xs, ys, 2, 4, REMAT_KW, remat="dots")
    got = _port(tmp_path, W, xs, ys, 2, 4, REMAT_KW, remat="dots")
    for pol in ("gen", "lib"):
        _close(got[pol][0], ref[0], W, 1e-5, ("dots", pol))


def test_tp1_is_the_step_without_a_mesh():
    """A (tp=1) mesh splits nothing: three steps bit-equal to no mesh, both
    policies, remat none and seg."""
    tp_ = tbuild("mini_resnet", img=4, num_cls=16, in_sz=16)[0]
    _, W, xs, ys = _setup()
    weights_from_numpy(tp_, W)
    mesh = tmesh.make_mesh({"tp": 1}, devices=["cpu"])
    assert all(not isinstance(v, tmesh.Shards)
               for v in tmesh.shard_weights({k: torch.from_numpy(v) for k, v in W.items()},
                                            tp_, mesh).values())
    for pol in ("gen", "lib"):
        for remat in ("", "seg"):
            runs = []
            for m in (None, mesh):
                step = tmake(tp_, "fc", kernel_policy=pol, remat=remat, mesh=m, **KW)
                w, mom, seen = {k: torch.from_numpy(v.copy()) for k, v in W.items()}, None, []
                for x, y in zip(xs[:, :4], ys[:, :4]):
                    loss, w, mom = step(w, {"data": torch.from_numpy(x)}, torch.from_numpy(y),
                                        mom)
                    seen.append(loss)
                runs.append((seen, w, mom))
            (la, wa, ma), (lb, wb, mb) = runs
            assert all(torch.equal(a, b) for a, b in zip(la, lb)), (pol, remat)
            assert all(torch.equal(wa[k], wb[k]) for k in wa), (pol, remat)
            assert all(torch.equal(ma[k], mb[k]) for k in ma), (pol, remat)


def test_mesh_errors():
    """boda_tpu's text where boda_tpu has the error (a mesh larger than the
    devices); the port's own where the port's step needs more than GSPMD
    (a dp that is not the group's size, an axis but dp and tp, weights not
    split as the mesh splits them)."""
    pipe = tbuild("mini_resnet", img=4, num_cls=16, in_sz=16)[0]
    for axes in ({"dp": 2, "tp": 8}, {"tp": 0}):
        with pytest.raises(ValueError) as t:
            tmesh.make_mesh(axes, kind="cpu")
        with pytest.raises(ValueError) as j:
            jmesh.make_mesh(axes)
        assert str(t.value) == str(j.value), axes
    with pytest.raises(tmesh.MeshError, match=r"mesh dp=2 needs as many ranks in the "
                                              r"process group, have 1"):
        tmake(pipe, "fc", mesh=tmesh.make_mesh({"dp": 2, "tp": 4}, kind="cpu"))
    with pytest.raises(tmesh.MeshError, match=r"mesh axes \['sp'\]: the training step "
                                              r"splits over dp and tp only"):
        tmake(pipe, "fc", mesh=tmesh.make_mesh({"tp": 2, "sp": 2}, kind="cpu"))
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    odd = tmesh.Mesh(np.array([[cpu, cpu], [cpu, cuda]], dtype=object), ("dp", "tp"))
    with pytest.raises(tmesh.MeshError, match="the tp rows repeat devices differently"):
        tmesh.train_row(odd, world=2)
    step = tmake(pipe, "fc", mesh=tmesh.make_mesh({"tp": 2}, kind="cpu"))
    w = {k: torch.from_numpy(np.ascontiguousarray(v.data)) for k, v in pipe.weights.items()}
    with pytest.raises(ValueError, match="weight 'conv1__filts' is split over tp by the "
                                         "mesh: pass the weights through"):
        step(w, {"data": torch.zeros(4, 3, 16, 16)}, torch.zeros(4, dtype=torch.int32))


def test_sharded_checkpoint_round_trip(tmp_path):
    """A (tp=4) step's weights and momenta saved as they are write the
    arrays and meta of the same state gathered first; restored onto the
    mesh they are the same shards, and the next step from either is the
    same bits."""
    pipe = tbuild("mini_resnet", img=4, num_cls=16, in_sz=16)[0]
    _, W, xs, ys = _setup()
    weights_from_numpy(pipe, W)
    mesh = tmesh.make_mesh({"tp": 4}, kind="cpu")
    step = tmake(pipe, "fc", mesh=mesh, **KW)
    batch = ({"data": torch.from_numpy(xs[0, :4])}, torch.from_numpy(ys[0, :4]))
    w = tmesh.shard_weights({k: torch.from_numpy(v.copy()) for k, v in W.items()}, pipe, mesh)
    _, w, m = step(w, *batch, None)
    split = [k for k, v in w.items() if isinstance(v, tmesh.Shards)]
    assert "conv1__filts" in split and "fc__filts" in split and "conv1__biases" not in split
    save_checkpoint(str(tmp_path / "sharded.npz"), 1, w, m)
    save_checkpoint(str(tmp_path / "whole.npz"), 1, tmesh.gather_weights(w),
                    tmesh.gather_weights(m))
    a, b = np.load(tmp_path / "sharded.npz"), np.load(tmp_path / "whole.npz")
    assert sorted(a.files) == sorted(b.files)
    assert all(np.array_equal(a[k], b[k]) for k in a.files)
    assert a["w/conv1__filts"].shape == W["conv1__filts"].shape
    s, w2, m2 = load_checkpoint(str(tmp_path / "sharded.npz"), pipe, mesh)
    assert s == 1
    for d, d2 in ((w, w2), (m, m2)):
        for k in d:
            assert isinstance(d2[k], tmesh.Shards) == isinstance(d[k], tmesh.Shards), k
            if isinstance(d[k], tmesh.Shards):
                assert d2[k].axis == d[k].axis and all(
                    torch.equal(p, q) for p, q in zip(d[k], d2[k])), k
            else:
                assert torch.equal(d[k], d2[k]), k
    batch = ({"data": torch.from_numpy(xs[1, :4])}, torch.from_numpy(ys[1, :4]))
    la, wa, _ = step(w, *batch, m)
    lb, wb, _ = step(w2, *batch, m2)
    assert torch.equal(la, lb)
    ga, gb = tmesh.gather_weights(wa), tmesh.gather_weights(wb)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)
