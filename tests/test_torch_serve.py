"""Serving on the CPU (boda_tpu_torch/modes/serve_bench.py): the device
preprocess against boda_tpu's jax one, the served preprocess+net against
boda_tpu's serve_fn (serve_bench.py:67-71) with the weights carried across,
the two report_perf=0 goldens through the port's CLI, the report_perf=1 keys
against boda_tpu's, and the error without the native library. Engines run
with ``device=cpu`` (the kernels' plain versions); f32 tolerance 1e-5."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boda_tpu.apps.preproc import img_to_batch_jax
from boda_tpu.config import make as jmake
from boda_tpu.models.zoo import build_model as jbuild
from boda_tpu.utils.digest import comp_vars
from boda_tpu_torch import cli
from boda_tpu_torch.apps.preproc import img_to_batch_torch
from boda_tpu_torch.config import make as tmake
from boda_tpu_torch.models.zoo import build_model as tbuild
from boda_tpu_torch.modes.serve_bench import (ServedNet, Uploader, cached_batches,
                                              loader_batches, serve_batches)
from boda_tpu_torch.modes.test_cmds import diff_dirs
from boda_tpu_torch.utils import native
from boda_tpu_torch.utils.carry import weights_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TD = os.path.join(REPO, "testdata")
CPU = "--conv-fwd=(mode=cuda,device=cpu)"


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


@pytest.mark.parametrize("layout", ["nchw", "nhwc"])
def test_img_to_batch_torch_matches_jax(layout):
    u8 = _u8((3, 7, 5, 4), 1)
    for scale, dt, jdt in ((1.0, torch.float32, jnp.float32), (0.5, torch.float32, jnp.float32),
                           (1.0, torch.bfloat16, jnp.bfloat16)):
        got = img_to_batch_torch(torch.from_numpy(u8), scale=scale, out_dtype=dt,
                                 layout=layout)
        want = img_to_batch_jax(jnp.asarray(u8), scale=scale, out_dtype=jdt, layout=layout)
        want = np.asarray(want.astype(jnp.float32))
        assert got.dtype == dt and tuple(got.shape) == want.shape
        assert np.array_equal(got.float().numpy(), want), (layout, scale, dt)  # exact


class PoolLoader:
    """Stands in for utils/native.BatchLoader: ``next(out=)`` writes batch i,
    ``pool[i % len(pool)]``, into ``out``, for ``n`` batches."""

    def __init__(self, pool, n):
        self.pool, self.n, self.i = pool, n, 0

    def next(self, out):
        if self.i == self.n:
            return None
        out[...] = self.pool[self.i % len(self.pool)]
        self.i += 1
        return self.i - 1, out


def test_served_net_matches_serve_fn():
    """mini_resnet f32 b4: the served function on the CPU (and the pipelined
    loop around it) against boda_tpu's jitted preprocess+net."""
    jp, jd = jbuild("mini_resnet", img=4)
    tp, td = tbuild("mini_resnet", img=4)
    weights_from_numpy(tp, {k: w.data for k, w in jp.weights.items()})
    d = jd["data"]
    batches = [_u8((4, d["y"], d["x"], 4), s) for s in (2, 3)]
    je = jmake("conv_fwd", "pallas", kernel_policy="gen")
    je.init(jp)
    te = tmake("conv_fwd", "cuda", device="cpu")
    te.init(tp)
    for out in ("fc", "prob"):
        net_fn = je.build_raw_fn([out])

        def serve_fn(weights, rgba_u8, net_fn=net_fn, out=out):  # serve_bench.py:67-71
            x = img_to_batch_jax(rgba_u8, layout="nhwc", out_dtype=None)
            return net_fn(weights, {"data": x})[out]
        served_j = jax.jit(serve_fn)
        served = ServedNet(te, out, 4, d["y"], d["x"]).build()
        for b in batches:
            want = np.asarray(served_j(je._weights_dev, jnp.asarray(b)), np.float32)
            got = served.run(torch.from_numpy(b)).numpy()
            r = comp_vars(want, got, mrd_toler=1e-5, atol=1e-5 * float(np.abs(want).max()))
            assert r.num_diff == 0, f"{out}: {r}"
        # the serving loop: uploads, the ring of outputs, the last batch's
        up = Uploader((4, d["y"], d["x"], 4), torch.device("cpu"), 3)
        host = [torch.from_numpy(b) for b in batches]
        n, last = serve_batches(served, up, cached_batches(host, 5), 2)
        assert n == 5
        assert np.array_equal(last.numpy(), served.run(host[0]).numpy())
        # a loader writing into the host buffers: each batch served as written
        outs = []
        n, _ = serve_batches(served, up, loader_batches(PoolLoader(batches, 5), up), 2,
                             outs=outs)
        assert n == len(outs) == 5
        for i, o in enumerate(outs):
            assert np.array_equal(o.numpy(), served.run(host[i % 2]).numpy()), i


def _golden_argv(name):
    import xml.etree.ElementTree as ET

    from boda_tpu_torch.modes.test_cmds import _split_cli
    li = next(li for li in ET.parse(os.path.join(TD, "test_cmds.xml")).getroot().iter("li")
              if li.get("test_name") == name)
    return [a.replace("%(boda_test_dir)", TD) for a in _split_cli(li.get("cli_str"))]


@pytest.mark.parametrize("name", ["serve_bench_mini", "serve_stages_mini"])
def test_serve_goldens(name, tmp_path, capsys):
    if not native.native_available():
        pytest.skip(f"the native library did not build: {native.why_unavailable()}")
    out = tmp_path / name
    out.mkdir()
    assert cli.main(_golden_argv(name) + [CPU, f"--boda-output-dir={out}"]) == 0
    (out / "test_out.txt").write_text(capsys.readouterr().out)
    d = diff_dirs(os.path.join(TD, "good_tr", name), str(out))
    assert d == "", d


def test_report_perf_keys_match_reference(capsys):
    """report_perf=1: the same keys as boda_tpu's lines (its CLI on the CPU,
    its xla engine), for serve_bench's two forms and serve_stages."""
    if not native.native_available():
        pytest.skip(f"the native library did not build: {native.why_unavailable()}")
    from boda_tpu.cli import main as jmain
    from boda_tpu.config import default_cfg_init
    import boda_tpu.modes_all  # noqa: F401
    default_cfg_init(REPO)
    img = os.path.join(TD, "images", "test2.jpg")
    base = ["--model=mini_resnet", "--img=4", "--n-batches=2", f"--img-fns=(a={img})",
            "--report-perf=1"]
    for argv in (["serve_bench"], ["serve_bench", "--cache-batches=1"], ["serve_stages"]):
        assert jmain(argv + base + ["--conv-fwd=(mode=xla)"]) == 0
        # boda_tpu's CLI ends with its timer table where timings were left
        # in the process (an earlier test's xla engine)
        want = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                           if ln.startswith("{")][-1])
        assert cli.main(argv + base + [CPU]) == 0
        got = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert list(got) == list(want), (argv, list(got), list(want))
        assert {k: got[k] for k in ("mode", "net", "img", "batches")} == \
            {k: want[k] for k in ("mode", "net", "img", "batches")}


def test_no_native_library_error(monkeypatch, capsys):
    monkeypatch.setattr(native, "native_available", lambda: False)
    img = os.path.join(TD, "images", "test2.jpg")
    for name in ("serve_bench", "serve_stages"):
        rc = cli.main([name, "--model=mini_resnet", "--img=4", f"--img-fns=(a={img})", CPU])
        assert rc == 1
        assert capsys.readouterr().err == \
            f"error: {name} needs the native library (make -C native failed?)\n"
