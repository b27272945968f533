"""The port's training modes on the CPU: train_bench's golden, train_lmdb's
checkpoints, resume and bn_freeze_at, test_lmdb --ckpt-fn on checkpoints of
either package, the LR schedules against boda_tpu's, and the mesh error."""

import re

import numpy as np
import pytest
import torch

from boda_tpu_torch.cli import main
from boda_tpu_torch.parallel.checkpoint import load_checkpoint, save_checkpoint

REC = "testdata/lmdb/cifar_mini.rec"
CPU = "--device=cpu"


def _losses(out: str) -> dict[int, float]:
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(r"step (\d+): loss ([\d.eE+-]+)", out)}


def test_train_bench_mini_golden(capsys):
    """testdata/test_cmds.xml's train_bench_mini through the port's CLI on
    the CPU: its golden line byte for byte."""
    rc = main(["train_bench", "--model=mini_resnet", "--img=2", "--chain=2", "--n_iters=2",
               "--n_best=1", "--compute_tn=", "--golden_out=1", "--lr=0.05", CPU])
    assert rc == 0
    want = open("testdata/good_tr/train_bench_mini/test_out.txt").read()
    assert capsys.readouterr().out == want


def test_kill_and_resume_reproduces_loss_curve(tmp_path, capsys):
    """3 steps with a checkpoint, then a resume to 6, against 6 straight
    (boda_tpu's tests/test_checkpoint.py:60-84): losses within 1e-5."""
    common = ["train_lmdb", f"--rec-fn={REC}", "--model=mini_resnet", "--img=4",
              "--lr-schedule=cosine", "--warmup-steps=2", CPU]
    assert main([*common, "--n-steps=6", f"--boda-output-dir={tmp_path / 'full'}"]) == 0
    full = _losses(capsys.readouterr().out)
    d = tmp_path / "split"
    assert main([*common, "--n-steps=3", "--ckpt-fn=ck.npz", f"--boda-output-dir={d}"]) == 0
    capsys.readouterr()
    assert main([*common, "--n-steps=6", "--ckpt-fn=ck.npz", "--resume=1",
                 f"--boda-output-dir={d}"]) == 0
    out = capsys.readouterr().out
    assert "resumed from ck.npz at step 3" in out
    resumed = _losses(out)
    assert set(resumed) == {3, 4, 5}
    for i in (3, 4, 5):
        assert full[i] == pytest.approx(resumed[i], rel=1e-5), (i, full[i], resumed[i])


def test_resume_past_end_keeps_checkpoint(tmp_path, capsys):
    """--resume at or past n_steps prints "nothing to do" and leaves the
    newer checkpoint as it is."""
    common = ["train_lmdb", f"--rec-fn={REC}", "--model=mini_resnet", "--img=4", CPU]
    d = tmp_path / "run"
    assert main([*common, "--n-steps=4", "--ckpt-fn=ck.npz", f"--boda-output-dir={d}"]) == 0
    capsys.readouterr()
    step0, w0, _ = load_checkpoint(str(d / "ck.npz"))
    assert step0 == 4
    assert main([*common, "--n-steps=2", "--ckpt-fn=ck.npz", "--resume=1",
                 f"--boda-output-dir={d}"]) == 0
    assert "train_lmdb: nothing to do (resumed at 4 >= n_steps 2)" in capsys.readouterr().out
    step1, w1, _ = load_checkpoint(str(d / "ck.npz"))
    assert step1 == 4 and all(torch.equal(w0[k], w1[k]) for k in w0)


def test_bn_freeze_at_and_curve(tmp_path, capsys):
    """bn_freeze_at switches to the inference-stats step at step 10 and the
    run keeps improving; curve_fn holds the logged losses at 3 significant
    figures."""
    rc = main(["train_lmdb", "--ptt-fn=testdata/nets/shapesnet2.prototxt",
               "--rec-fn=testdata/lmdb/shapes10_train.rec", "--img=8", "--n-steps=20",
               "--lr=0.05", "--bn-momentum=0.1", "--bn-freeze-at=10", "--log-every=5",
               "--curve-fn=curve.txt", f"--boda-output-dir={tmp_path}", CPU])
    out = capsys.readouterr().out
    assert rc == 0
    assert "step 10: BN frozen (inference running stats)" in out
    assert "wrote loss curve (4 points) to curve.txt" in out
    assert re.search(r"train_lmdb: 20 steps over \d+ records, loss \S+ -> \S+ \(improved\)",
                     out), out
    curve = (tmp_path / "curve.txt").read_text().splitlines()
    logged = _losses(out)
    assert [ln.split("\t")[0] for ln in curve] == ["0", "5", "10", "15"]
    assert all(float(ln.split("\t")[1]) == float(f"{logged[int(ln.split()[0])]:.3g}")
               for ln in curve)


def test_checkpoints_cross_packages(tmp_path, capsys):
    """A boda_tpu train_lmdb checkpoint read by the port's test_lmdb
    --ckpt-fn prints boda_tpu's top-1 line; checkpoints written by either
    package's save_checkpoint, bf16 included, load equal in the other."""
    import jax.numpy as jnp
    from boda_tpu.cli import main as jmain
    from boda_tpu.parallel.checkpoint import load_checkpoint as jload
    from boda_tpu.parallel.checkpoint import save_checkpoint as jsave
    net = ["--ptt-fn=testdata/nets/shapesnet.prototxt", "--img=8"]
    d = tmp_path / "j"
    assert jmain(["train_lmdb", *net, "--rec-fn=testdata/lmdb/shapes_train.rec",
                  "--n-steps=12", "--lr=0.02", "--ckpt-fn=ck.npz",
                  f"--boda-output-dir={d}"]) == 0
    capsys.readouterr()
    ev = [*net, "--rec-fn=testdata/lmdb/shapes_test.rec", f"--ckpt-fn={d}/ck.npz"]
    assert jmain(["test_lmdb", *ev]) == 0
    jlines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("test_lmdb:")]
    assert main(["test_lmdb", *ev, "--conv-fwd=(mode=cuda,device=cpu)"]) == 0
    tlines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("test_lmdb:")]
    assert tlines == jlines and "(step 12)" in tlines[0], (tlines, jlines)

    rng = np.random.default_rng(4)
    w = {"a__filts": rng.standard_normal((2, 3, 1, 1)).astype(np.float32),
         "b__biases": rng.standard_normal(5).astype(np.float32)}
    m = {"a__filts": rng.standard_normal((2, 3, 1, 1)).astype(np.float32)}
    bf = torch.from_numpy(rng.standard_normal(7).astype(np.float32)).to(torch.bfloat16)
    save_checkpoint(str(tmp_path / "t.npz"), 9,
                    {**{k: torch.from_numpy(v) for k, v in w.items()}, "c__bf": bf},
                    {k: torch.from_numpy(v) for k, v in m.items()})
    step, jw, jm = jload(str(tmp_path / "t.npz"))
    assert step == 9 and jw["c__bf"].dtype.name == "bfloat16"
    assert np.array_equal(jw["c__bf"].astype(np.float32), bf.float().numpy())
    assert all(np.array_equal(jw[k], w[k]) for k in w)
    assert np.array_equal(jm["a__filts"], m["a__filts"])
    jsave(str(tmp_path / "j.npz"), 5, {**w, "c__bf": np.asarray(jnp.asarray(bf.float().numpy(),
                                                                              jnp.bfloat16))})
    step, tw, tm = load_checkpoint(str(tmp_path / "j.npz"))
    assert step == 5 and tm is None and tw["c__bf"].dtype == torch.bfloat16
    assert torch.equal(tw["c__bf"], bf)
    assert all(np.array_equal(tw[k].numpy(), w[k]) for k in w)


def test_lr_schedules_match_boda_tpu():
    """Every kind at every step of a run within 1e-6 relative of boda_tpu's
    f32 jnp schedule; the same errors."""
    from boda_tpu.parallel.schedules import make_lr_schedule as jsched
    from boda_tpu_torch.parallel.schedules import make_lr_schedule as tsched
    kinds = [("const", 0.1), ("const", 0.01, 0, 5), ("step", 0.1, 0, 0, 0.5, 10),
             ("step", 0.05, 0, 3, 0.3, 7), ("cosine", 0.1, 100, 10),
             ("cosine", 0.02, 150, 20), ("cosine", 0.02, 150, 0)]
    for args in kinds:
        t, j = tsched(*args), jsched(*args)
        for s in range(160):
            ref = float(j(s))
            assert abs(float(t(s)) - ref) <= 1e-6 * abs(ref), (args, s)
            assert t(s).dtype == np.float32
    for bad in [("nope", 0.1), ("cosine", 0.1), ("step", 0.1)]:
        with pytest.raises(ValueError) as te:
            tsched(*bad)
        with pytest.raises(ValueError) as je:
            jsched(*bad)
        assert str(te.value) == str(je.value)


def test_mesh_and_device_errors(monkeypatch, capsys):
    """--mesh other than () is refused, naming boda_tpu's train_lmdb, which
    declares mesh and never reads it; device=cuda without a card raises;
    train_bench on the CPU needs golden_out."""
    common = ["train_lmdb", f"--rec-fn={REC}", "--model=mini_resnet", "--img=4"]
    assert main([*common, "--mesh=(dp=2)", CPU]) == 1
    assert "declares mesh and never reads it (boda_tpu/modes/train_lmdb.py:49)" in \
        capsys.readouterr().err
    assert main(["train_bench", "--model=mini_resnet", "--img=2", CPU]) == 1
    assert "--golden-out=1" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(common) == 1
    assert "device=cuda but torch finds no CUDA card" in capsys.readouterr().err
