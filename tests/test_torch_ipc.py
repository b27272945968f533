"""The ipc backend on the CPU: tests/test_ipc.py's cases with the worker on
the card's backend over the plain versions (``worker_be=(be=cuda,device=cpu)``),
bf16 on the wire as boda_tpu sends it, the message framing against
boda_tpu's byte for byte, and the worker's error at the master when its
default backend, the card, finds none."""

import io
import os
import socket
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest

import boda_tpu_torch.modes_all  # noqa: F401
from boda_tpu.rtc import stream_util as jstream
from boda_tpu_torch import cli
from boda_tpu_torch.config import make
from boda_tpu_torch.ops.op_base import Op
from boda_tpu_torch.ops.registry import Codegen
from boda_tpu_torch.ops.tune import OpTune
from boda_tpu_torch.rtc import stream_util as tstream
from boda_tpu_torch.rtc.compute import Call, RtcError
from boda_tpu_torch.rtc.ipc import to_wire
from boda_tpu_torch.utils.dims import NDA, Dims
from boda_tpu_torch.utils.lexp import parse_lexp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_BE = "(be=cuda,device=cpu)"


def _make_ipc(**kw):
    return make("be", "ipc", worker_be=parse_lexp(WORKER_BE), **kw)


def _sgemm(m=32, k=32, n=32, tn="float32"):
    return Op("sgemm", {}, {"a": Dims.of(M=m, K=k, tn=tn), "b": Dims.of(K=k, N=n, tn=tn),
                            "c": Dims.of(M=m, N=n, tn=tn)})


def test_ipc_var_roundtrip_and_errors():
    be = _make_ipc()
    try:
        assert be.get_plat_tag() == "ipc:cuda:cpu"
        d = Dims.of(y=3, x=5)
        rng = np.random.RandomState(0)
        a = rng.randn(3, 5).astype(np.float32)
        be.create_var_from_nda("v", NDA(d, a))
        assert be.var_exists("v") and be.get_var_dims("v") == d
        assert np.array_equal(be.copy_var_to_nda("v").data, a)
        be.set_var_to_zero("v")
        assert np.all(be.copy_var_to_nda("v").data == 0)
        # bf16: 2 bytes per element on the wire, boda_tpu's bytes, and back
        db = Dims.of(y=3, x=5, tn="bfloat16")
        ab = a.astype(ml_dtypes.bfloat16)
        nda = NDA(db, ab.astype(np.float32))
        assert to_wire(nda) == ab.tobytes()
        be.create_var_from_nda("w", nda)
        assert np.array_equal(be.copy_var_to_nda("w").data, ab.astype(np.float32))
        # remote errors surface as RtcError with the worker's message
        with pytest.raises(RtcError, match="no var named 'nope'"):
            be.copy_var_to_nda("nope")
        be.release_var("v")
        assert not be.var_exists("v")
    finally:
        be.shutdown()


def test_ipc_gen_run_sgemm_equals_in_process():
    """sgemm generated and run in the worker gives the in-process call's
    bits, f32 and bf16, and times over the proxy."""
    rng = np.random.RandomState(1)
    local = make("be", "cuda", device="cpu")
    be = _make_ipc()
    cgs = {id(b): Codegen(b) for b in (be, local)}
    try:
        for tn in ("float32", "bfloat16"):
            op = _sgemm(tn=tn)
            ins = {n: NDA(op.dims(n), rng.randn(*op.dims(n).shape).astype(np.float32))
                   for n in ("a", "b")}
            res = []
            for b in (be, local):
                cg = cgs[id(b)]
                fi = cg.gen_func(op)
                assert (fi.fn is None) == (b is be)  # a remote stub
                b.release_all_vars()
                for n, x in ins.items():
                    b.create_var_from_nda(n, x)
                b.create_var_with_dims("c", op.dims("c"))
                cg.compile()
                cg.run_func(fi, {"a": "a", "b": "b", "c": "c"})
                res.append(b.copy_var_to_nda("c").data)
            assert np.array_equal(res[0], res[1]), tn
            ref = ins["a"].data.astype(np.float64) @ ins["b"].data
            assert np.abs(res[0] - ref).max() <= 0.02 * np.abs(ref).max(), tn
        fi = cgs[id(be)].gen_func(op)
        secs = be.time_func(Call(fi.name, {"a": "a", "b": "b", "c": "c"}), n_iters=2, warmup=1)
        assert secs > 0
    finally:
        be.shutdown()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ipc_tcp_transport():
    port = _free_port()
    worker = subprocess.Popen(
        [sys.executable, "-m", "boda_tpu_torch", "ipc_compute_worker",
         f"--addr=tcp:127.0.0.1:{port}", "--listen=1"], cwd=REPO)
    try:
        deadline = time.time() + 60
        be = None
        while time.time() < deadline:
            try:
                be = _make_ipc(addr=f"tcp:127.0.0.1:{port}")
                break
            except OSError:
                time.sleep(0.3)
        assert be is not None, "could not connect to tcp worker"
        assert be.get_plat_tag().startswith("ipc:")
        be.create_var_with_dims("x", Dims.of(n=16))
        assert be.var_exists("x")
        be.shutdown()
    finally:
        worker.wait(timeout=30)
    assert worker.returncode == 0


def test_cs_test_master_mode(tmp_path, capsys):
    rc = cli.main(["cs_test_master", f"--worker-be={WORKER_BE}", "--n=1000",
                   f"--boda-output-dir={tmp_path}"])
    assert rc == 0
    assert "rtc_test be=ipc:cuda:cpu n=1000: PASS" in capsys.readouterr().out


def test_ipc_profile_op_ab_falls_back_to_chain():
    """ops_prof's A/B over an ipc backend: remote stubs have fn=None, so
    profile_op falls back to the proxied time_func (chain tier)."""
    from boda_tpu_torch.prof.opsprof import profile_op
    be = _make_ipc()
    try:
        tunes = [OpTune(), OpTune(bm=8, bn=128, bk=128)]
        wis = profile_op(be, Codegen(be), _sgemm(), tunes, n_iters=2, method="ab",
                         log=lambda *a: None)
        assert len(wis.runs) == 2 and all(r.method == "chain" for r in wis.runs)
    finally:
        be.shutdown()


def test_framing_matches_boda_tpu():
    """The same message framed by boda_tpu's ByteStream and the port's is the
    same bytes, and each reads the other's."""
    parts = ("create_var_from", "a", "(M=2,K=3,tn=bfloat16)", b"\x00\x01\xff", 7, -3,
             2.5, True)
    bufs = {}
    for name, mod in (("jax", jstream), ("torch", tstream)):
        w = io.BytesIO()
        mod.ByteStream(None, w).write_msg(*parts)
        bufs[name] = w.getvalue()
    assert bufs["jax"] == bufs["torch"]
    want = [*parts[:-1], 1]
    assert tstream.ByteStream(io.BytesIO(bufs["jax"]), None).read_msg() == want
    assert jstream.ByteStream(io.BytesIO(bufs["torch"]), None).read_msg() == want


def test_default_worker_without_card_raises_at_master(monkeypatch):
    """worker_be defaults to the card; a worker that finds none returns its
    backend's error, which the master raises, and exits."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    with pytest.raises(RtcError, match="ipc worker error in 'init': .*no CUDA card"):
        make("be", "ipc")
