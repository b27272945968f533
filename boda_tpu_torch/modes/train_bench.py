"""train_bench: steady-state training-step throughput.

Counterpart of ``boda_tpu/modes/train_bench.py``: the same Fields and JSON
line, plus ``device`` and ``kernel_policy``. ``chain`` steps run back to
back, each on the weights the last one returned, from the same starting
weights in every timed run. On the card, ``secs_per_step`` is the best of
``n_best`` medians of ``n_iters / chain`` runs, each timed between CUDA
events and divided by ``chain``; TF/s counts 3x the forward's FLOPs (the
forward, the input gradient and the weight gradient). With ``cuda_graph``
(the default) the card replays the step captured once (parallel/train.py:
CapturedStep), and each run's first step copies the starting weights and
momenta into the step's static tensors inside the timed window. The CPU runs
only for ``golden_out``, which drops the timing fields.
"""

from __future__ import annotations

import json
import statistics

import numpy as np
import torch

from .. import graph  # noqa: F401
from ..config import ConfigError, Field, Mode, register
from .cnet import load_net


@register("mode", "train_bench", help="training-step throughput benchmark")
class TrainBench(Mode):
    model = Field(str, default="resnet50", help="zoo model")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img = Field(int, default="32", help="batch size")
    lr = Field(float, default="0.01", help="SGD learning rate")
    clip_norm = Field(float, default="1.0", help="global-norm grad clip (0=off)")
    momentum = Field(float, default="0.0", help="SGD momentum (0=plain SGD)")
    weight_decay = Field(float, default="0.0", help="decoupled weight decay")
    bn_momentum = Field(float, default="0.0", help="train-mode BN EMA rate (0=inference-stats BN)")
    master_f32 = Field(bool, default="0", help="f32 master weights (compute in compute_tn)")
    remat = Field(str, default="", help="rematerialization: '' | seg | full | dots")
    compute_tn = Field(str, default="bfloat16", help="weight/activation dtype ('' = f32)")
    chain = Field(int, default="4", help="steps chained per timed run")
    n_iters = Field(int, default="12", help="steps timed per repeat")
    n_best = Field(int, default="3", help="best-of-N timing repeats")
    golden_out = Field(bool, default="0",
                       help="omit timing fields (deterministic golden output)")
    device = Field(str, default="cuda",
                   help="cuda (the card; raises without one) | cpu (golden_out only)")
    kernel_policy = Field(str, default="gen",
                          help="convs and fcs: gen (hand CUDA kernels) | lib (cuDNN/cuBLAS)")
    cuda_graph = Field(bool, default="1",
                       help="on the card: the step captured once as one CUDA graph and "
                            "replayed, its weights and momentum donated (0 = eager)")

    def main(self) -> None:
        from ..ops.kernels.gen_data import gen_data_pattern
        from ..parallel.train import (find_logits_node, is_trainable, make_train_step,
                                      train_device)
        from ..utils.dims import torch_dtype
        dev = train_device(self.device, "train_bench")
        if dev.type == "cpu" and not self.golden_out:
            raise ConfigError("train_bench times the card; on the CPU it runs only "
                              "with --golden-out=1")
        pipe, in_dims = load_net(self.model, self.ptt_fn, "", self.img, 0)
        logits = find_logits_node(pipe)
        cdt = torch_dtype(self.compute_tn) if self.compute_tn else torch.float32
        step = make_train_step(pipe, logits, lr=self.lr,
                               clip_norm=self.clip_norm,
                               momentum=self.momentum,
                               weight_decay=self.weight_decay,
                               bn_momentum=self.bn_momentum,
                               compute_dtype=(cdt if self.master_f32 and
                                              self.compute_tn else None),
                               remat=self.remat,
                               kernel_policy=self.kernel_policy,
                               cuda_graph=self.cuda_graph)
        d = in_dims["data"]
        # every weight in the compute dtype, or f32 masters under master_f32
        wdt = torch.float32 if self.master_f32 else cdt
        weights = {k: torch.from_numpy(np.asarray(w.data, np.float32)).to(dev, wdt)
                   for k, w in pipe.weights.items()}
        x = gen_data_pattern(d.shape, d.tn).to(dev, cdt)
        n_cls = int(np.prod(pipe.nodes[logits].dims.shape)) // self.img
        labels = (torch.arange(self.img) % n_cls).to(dev)
        use_mom = self.momentum > 0
        mom0 = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                for k, v in weights.items() if is_trainable(k)} if use_mom else None

        def chained():
            w, m, losses = weights, mom0, []
            for _ in range(self.chain):
                if use_mom:
                    loss, w, m = step(w, {"data": x}, labels, m)
                else:
                    loss, w = step(w, {"data": x}, labels)
                losses.append(loss)
            return losses

        losses = chained()  # warm-up and the losses
        l0, l1 = float(losses[0]), float(losses[-1])
        out = {"mode": "train_bench", "net": pipe.name, "img": self.img,
               "compute_tn": self.compute_tn or "float32"}
        if not self.golden_out:
            secs = min(self._median_secs(chained) for _ in range(self.n_best))
            step_fl = 3.0 * pipe.total_flops()
            out.update({"img_per_sec": round(self.img / secs, 1),
                        "secs_per_step": round(secs, 6),
                        "TF_per_s": round(step_fl / secs / 1e12, 1)})
        out.update({"loss_first": round(l0, 4), "loss_last": round(l1, 4),
                    "loss_decreased": bool(l1 < l0)})
        if self.golden_out:
            out["loss_first"] = round(l0, 2)
            out["loss_last"] = round(l1, 2)
        print(json.dumps(out))

    def _median_secs(self, chained) -> float:
        """The median over ``n_iters / chain`` runs of a chain's time between
        CUDA events, per step."""
        times = []
        for _ in range(max(1, self.n_iters // self.chain)):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            chained()
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1) / 1e3 / self.chain)
        return statistics.median(times)
