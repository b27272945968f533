#!/usr/bin/env python3
"""Which outputs of a gradient graph change between two eager passes, and
between an eager pass and the CUDA-graph replay, on the card.

mini_resnet (b2, 16x16, f32) with its backward ops (add_bck_ops) on the
cuda engine under kernel_policy=gen, once with cuDNN's default algorithms
and once with ``torch.backends.cudnn.deterministic``: two eager passes
(``cuda_graph=0``) and one replay (``cuda_graph=1``) of the same engine,
each gradient output compared bit for bit. Prints one line per setting.

    python3 scripts/torch_graph_determinism.py
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from boda_tpu_torch.config import make  # noqa: E402
from boda_tpu_torch.graph.autodiff import add_bck_ops  # noqa: E402
from boda_tpu_torch.models.zoo import build_model  # noqa: E402
from boda_tpu_torch.utils.dims import NDA  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_graph_determinism: needs a CUDA card", file=sys.stderr)
        return 1
    pipe, _ = build_model("mini_resnet", img=2, num_cls=8, in_sz=16)
    add_bck_ops(pipe)
    d = pipe.nodes["data"].dims
    ins = {"data": NDA(d, np.random.RandomState(5).randn(*d.shape).astype(np.float32)),
           "label": NDA(pipe.nodes["label"].dims, np.arange(2, dtype=np.float32))}
    want = ["prob_loss", "data__grad__p0"] + [
        n for n in pipe.nodes if pipe.nodes[n].dims is not None
        and any(n.startswith(w + "__grad") for w in pipe.weights)]
    for det in (False, True):
        torch.backends.cudnn.deterministic = det
        eng = make("conv_fwd", "cuda")
        eng.init(pipe)
        eng.cuda_graph = False
        e1, e2 = eng.run_fwd(ins, want), eng.run_fwd(ins, want)
        eng.cuda_graph = True
        g = eng.run_fwd(ins, want)
        ee = [n for n in want if not np.array_equal(e1[n].data, e2[n].data)]
        eg = [n for n in want if not np.array_equal(e1[n].data, g[n].data)]
        worst = max((float(np.abs(e1[n].data - g[n].data).max()) for n in eg), default=0.0)
        print(f"cudnn.deterministic={det}: of {len(want)} outputs, eager vs eager differ "
              f"in {len(ee)}, eager vs replay in {len(eg)} (max |diff| {worst:.3g}); "
              f"{torch.cuda.get_device_name()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
