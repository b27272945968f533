"""The port's zmq inference service (boda_tpu_torch/modes/zmq_modes.py,
apps/zmq_det.py) on the CPU: tests/test_streams.py's classification and
detection services, with the port's server in a process of its own
(``--conv-fwd=(mode=cuda,device=cpu)``) and boda_tpu's beside it; for the
same image the two servers' replies agree (classes, and probabilities,
scores and boxes within f32 rounding); the port's client talks to either."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from boda_tpu_torch.apps.zmq_det import Client
from boda_tpu_torch.utils.features import is_feature_enabled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMGS = os.path.join(REPO, "testdata", "images")
CPU = "--conv-fwd=(mode=cuda,device=cpu)"
P_TOL = 1e-5


@pytest.fixture
def zmq_ok():
    if not is_feature_enabled("zmq"):
        pytest.skip("pyzmq is not installed")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _servers(args, n_requests):
    """(port's endpoint, boda_tpu's endpoint, both processes)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    eps, procs = [], []
    for pkg, extra in (("boda_tpu_torch", [CPU]), ("boda_tpu", [])):
        ep = f"tcp://127.0.0.1:{_port()}"
        procs.append(subprocess.Popen(
            [sys.executable, "-m", pkg, "zmq_det_server", f"--endpoint={ep}", *args,
             *extra, f"--max-requests={n_requests}"],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        eps.append(ep)
    return eps, procs


def _finish(procs):
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        assert p.returncode == 0, out
        outs.append(out)
    return outs


def _same_top(a, b):
    """Two top-N replies agree: each class's p within P_TOL, and the same
    class at each rank except where neighbouring p lie within P_TOL."""
    pa, pb = {t["cls"]: t["p"] for t in a}, {t["cls"]: t["p"] for t in b}
    for k, (x, y) in enumerate(zip(a, b)):
        if x["cls"] != y["cls"]:
            near = [abs(x["p"] - a[j]["p"]) for j in (k - 1, k + 1) if 0 <= j < len(a)]
            assert min(near) <= P_TOL, (a, b)
    assert all(abs(pa[c] - pb[c]) <= P_TOL for c in set(pa) & set(pb)), (a, b)


def test_zmq_classification_service(zmq_ok):
    (ep_t, ep_j), procs = _servers(["--model=mini_resnet", "--in-sz=32"], 3)
    try:
        replies = []
        for ep in (ep_t, ep_j):
            c = Client(ep, timeout_ms=120000)
            try:
                res = c.predict_file(f"{IMGS}/test1.png")
                assert "top" in res and len(res["top"]) == 5
                assert all(0 <= t["p"] <= 1 for t in res["top"])
                with pytest.raises(RuntimeError, match="server error"):
                    c.predict_bytes(b"not an image")  # the error path: garbage image
                res2 = c.predict_file(f"{IMGS}/test2.jpg")
                replies.append((res, res2))
            finally:
                c.close()
    finally:
        outs = _finish(procs)
    (t1, t2), (j1, j2) = replies  # the port's server, boda_tpu's
    _same_top(t1["top"], j1["top"])
    _same_top(t2["top"], j2["top"])
    assert "zmq_det_server: served 3 requests" in outs[0]


def test_zmq_detection_service(zmq_ok):
    """A DetectionOutput-headed net serves boxes."""
    (ep_t, ep_j), procs = _servers(["--model=", "--ptt-fn=testdata/nets/tinyssd.prototxt",
                                    "--conf-thresh=0.3"], 1)
    try:
        dets = []
        for ep in (ep_t, ep_j):
            c = Client(ep, timeout_ms=120000)
            try:
                dets.append(c.predict_file(f"{IMGS}/test1.png"))
            finally:
                c.close()
    finally:
        _finish(procs)
    got, want = dets
    assert "dets" in got and got["dets"], got
    assert {"cls", "score", "box"} <= set(got["dets"][0]) and len(got["dets"][0]["box"]) == 4
    assert [d["cls"] for d in got["dets"]] == [d["cls"] for d in want["dets"]]
    assert np.allclose([d["score"] for d in got["dets"]], [d["score"] for d in want["dets"]],
                       rtol=0, atol=P_TOL)
    # pixels; the seeded tinyssd's decoded boxes reach 1e13, hence the rtol
    assert np.allclose([d["box"] for d in got["dets"]], [d["box"] for d in want["dets"]],
                       rtol=1e-5, atol=1e-3)
