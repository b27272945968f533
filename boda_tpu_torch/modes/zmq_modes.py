"""ZeroMQ inference-service modes (ref zmq-det-* mode family).

Counterpart of ``boda_tpu/modes/zmq_modes.py``, with its Fields, replies and
output lines; the net runs on the port's engine, on the card by default
(boda_tpu's default is its f32 ``xla`` engine). Each request is a batch of
one: the engine captures the forward at the first request and replays it
for every later one.
"""

from __future__ import annotations

import json

import numpy as np

from .. import graph  # noqa: F401
from ..config import Field, Mode, register
from ..utils.dims import NDA
from .cnet import load_net


@register("mode", "zmq_det_server", help="serve net predictions over zmq REQ/REP")
class ZmqDetServer(Mode):
    endpoint = Field(str, default="tcp://127.0.0.1:5677", help="zmq bind endpoint")
    model = Field(str, default="mini_resnet", help="zoo model")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    weights_fn = Field("filename", default="", help="caffemodel weights")
    in_sz = Field(int, default="0", help="input size override")
    conv_fwd = Field("conv_fwd", default="(mode=cuda)", help="engine")
    out_node_name = Field(str, default="prob", help="output node")
    top_n = Field(int, default="5", help="classes per reply")
    max_requests = Field(int, default="0", help="exit after N requests (0=forever)")

    conf_thresh = Field(float, default="0.1", help="min det score (detection nets)")

    def main(self) -> None:
        from ..apps.preproc import img_to_batch_np
        from ..apps.zmq_det import serve
        pipe, in_dims = load_net(self.model, self.ptt_fn, self.weights_fn,
                                 img=1, in_sz=self.in_sz)
        self.conv_fwd.init(pipe)
        d = in_dims["data"]
        # a net with a DetectionOutput head serves BOXES (the reference's
        # zmq service is a DETECTION service, ref zmq-util.cc:15-156);
        # classification nets serve top-N class probabilities
        det_ops = [op for op in pipe.ops.values()
                   if op.type == "DetectionOutput"]
        out_node = det_ops[-1].tops[0] if det_ops and \
            self.out_node_name == "prob" else self.out_node_name
        # the dets reply shape only applies when the SERVED node is a
        # detection head; --out-node-name may point elsewhere on an SSD net
        is_det_node = out_node in {op.tops[0] for op in det_ops}

        def predict(rgba: np.ndarray) -> dict:
            from ..utils.img_io import Img
            ih, iw = rgba.shape[0], rgba.shape[1]
            im = Img(rgba).resize(d["y"], d["x"])
            x = img_to_batch_np(im.data[None]).astype(np.float32)
            outs = self.conv_fwd.run_fwd({"data": NDA(d, x)}, [out_node])
            if is_det_node:
                recs = np.asarray(outs[out_node].data,
                                  np.float32).reshape(-1, 7)
                dets = []
                for _i, lab, score, x0, y0, x1, y1 in recs:
                    if lab < 0 or score < self.conf_thresh:
                        continue
                    dets.append({"cls": int(lab), "score": float(score),
                                 "box": [float(x0 * iw), float(y0 * ih),
                                         float(x1 * iw), float(y1 * ih)]})
                return {"dets": dets}
            prob = outs[out_node].data.reshape(-1)
            top = np.argsort(-prob)[: self.top_n]
            return {"top": [{"cls": int(c), "p": float(prob[c])} for c in top]}

        n = serve(self.endpoint, predict, max_requests=self.max_requests)
        print(f"zmq_det_server: served {n} requests")


@register("mode", "zmq_det_client", help="query a zmq prediction server")
class ZmqDetClient(Mode):
    endpoint = Field(str, default="tcp://127.0.0.1:5677", help="zmq endpoint")
    img_fns = Field((list, "filename"), req=True, help="images to classify")
    quit_server = Field(bool, default="0", help="send quit after queries")

    def main(self) -> None:
        from ..apps.zmq_det import Client
        c = Client(self.endpoint)
        try:
            for fn in self.img_fns:
                res = c.predict_file(fn)
                print(json.dumps({"img": fn, **res}))
            if self.quit_server:
                c.quit_server()
        finally:
            c.close()
