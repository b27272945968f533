"""ZeroMQ REQ/REP inference service: images in, predictions out.

Counterpart of ``boda_tpu/apps/zmq_det.py`` (ref src/zmq-util.cc:15-156, the
``zmq-det`` modes, and ext/zmq-det-standalone.cc's client): a REQ/REP socket
service that accepts an image and replies with scored results. Protocol:
2-part request [json header, image bytes]; 1-part json reply. The wire
format is boda_tpu's, so either package's client talks to either server.
"""

from __future__ import annotations

import json

import numpy as np

from ..utils.features import is_feature_enabled


def _zmq():
    """The pyzmq module; without it the service's modes raise naming it."""
    if not is_feature_enabled("zmq"):
        raise RuntimeError(
            "zmq feature not enabled in this build (the pyzmq python module "
            "is not installed); the zmq_det service needs it")
    import zmq
    return zmq


def serve(endpoint: str, predict_fn, max_requests: int = 0, verbose=print):
    """Bind a REP socket; predict_fn(img_rgba_u8) -> json-able payload."""
    zmq = _zmq()
    ctx = zmq.Context.instance()
    sock = ctx.socket(zmq.REP)
    sock.bind(endpoint)
    verbose(f"zmq_det server listening on {endpoint}")
    n = 0
    try:
        while True:
            parts = sock.recv_multipart()
            try:
                hdr = json.loads(parts[0])
                if hdr.get("cmd") == "quit":
                    sock.send_json({"ok": True, "bye": True})
                    return n
                img = _decode_image(parts[1] if len(parts) > 1 else b"")
                out = predict_fn(img)
                sock.send_json({"ok": True, "result": out})
            except Exception as e:
                sock.send_json({"ok": False, "error": f"{type(e).__name__}: {e}"})
            n += 1
            if max_requests and n >= max_requests:
                return n
    finally:
        sock.close(0)


def _decode_image(data: bytes) -> np.ndarray:
    import io

    from ..utils.img_io import _pil_image
    Image = _pil_image()
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"))


class Client:
    """REQ client (ref standalone client, src/ext/zmq-det-standalone.cc)."""

    def __init__(self, endpoint: str, timeout_ms: int = 30000):
        zmq = _zmq()
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REQ)
        self._sock.setsockopt(zmq.RCVTIMEO, timeout_ms)
        self._sock.setsockopt(zmq.SNDTIMEO, timeout_ms)
        self._sock.setsockopt(zmq.LINGER, 0)
        self._sock.connect(endpoint)

    def predict_file(self, img_fn: str) -> dict:
        with open(img_fn, "rb") as f:
            return self.predict_bytes(f.read())

    def predict_bytes(self, img_bytes: bytes) -> dict:
        self._sock.send_multipart([json.dumps({"cmd": "predict"}).encode(),
                                   img_bytes])
        resp = json.loads(self._sock.recv())
        if not resp.get("ok"):
            raise RuntimeError(f"zmq_det server error: {resp.get('error')}")
        return resp["result"]

    def quit_server(self) -> None:
        self._sock.send_multipart([json.dumps({"cmd": "quit"}).encode()])
        self._sock.recv()

    def close(self) -> None:
        self._sock.close(0)
