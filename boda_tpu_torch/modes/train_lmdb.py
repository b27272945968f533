"""train_lmdb: the training loop over datum records.

Counterpart of ``boda_tpu/modes/train_lmdb.py``, every Field of it plus
``device`` and ``kernel_policy``: read datum records (LMDB or the
block-stream container), batch and preprocess them as test_lmdb does, and
run optimizer steps (parallel/train.py: SGD, momentum, decoupled weight
decay, clip, train-mode BN with ``bn_freeze_at``, f32 masters under
``compute_tn``, LR schedules, remat), with atomic checkpoints and resume.
The steps run on the card unless ``--device=cpu``, each replayed from a
CUDA graph captured once (``cuda_graph``; ``bn_freeze_at`` captures the
frozen step as a second graph), the weights and momenta it returns being the
step's static tensors, which the checkpoints read before the next step
overwrites them. ``mesh`` is refused:
boda_tpu's train_lmdb declares it and never reads it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import graph  # noqa: F401
from ..config import ConfigError, Field, Mode, register
from .cnet import load_net
from .lmdb_modes import _iter_records


@register("mode", "train_lmdb", help="train a net over datum records")
class TrainLmdb(Mode):
    db_fn = Field("filename", default="", help="lmdb directory (needs lmdb)")
    rec_fn = Field("filename", default="", help="block-stream record file")
    model = Field(str, default="", help="zoo model")
    ptt_fn = Field("filename", default="", help="caffe prototxt")
    img = Field(int, default="4", help="batch size")
    in_sz = Field(int, default="0", help="input size override")
    n_steps = Field(int, default="10", help="optimizer steps")
    lr = Field(float, default="0.01", help="learning rate")
    momentum = Field(float, default="0.9", help="SGD momentum")
    weight_decay = Field(float, default="0.0", help="decoupled weight decay")
    clip_norm = Field(float, default="1.0", help="global-norm grad clip")
    bn_momentum = Field(float, default="0.1", help="train-mode BN EMA rate")
    # train-mode BN (batch stats + EMA) for the first N steps, then the
    # inference-stats BN step on the accumulated running statistics; 0 = never
    bn_freeze_at = Field(int, default="0",
                         help="switch BN to frozen running stats at this step (0=never)")
    compute_tn = Field(str, default="", help="bfloat16 = f32-master mixed precision")
    remat = Field(str, default="", help="rematerialization: '' | seg | full | dots")
    mesh = Field("lexp", default="()", help="refused: boda_tpu's train_lmdb declares it and never reads it")
    log_every = Field(int, default="1", help="print loss every N steps")
    # LR schedules (parallel/schedules.py): lr is the base rate
    lr_schedule = Field(str, default="const", help="const | step | cosine")
    warmup_steps = Field(int, default="0", help="linear LR warmup steps")
    lr_gamma = Field(float, default="0.1", help="step-schedule decay factor")
    lr_step_size = Field(int, default="0", help="step-schedule period")
    init_seed = Field(int, default="1234",
                      help="weight-init seed (prototxt nets; measures "
                           "train-variance for the learning gates)")
    # checkpoint/resume (parallel/checkpoint.py): atomic weights+momentum+
    # BN-stats+step snapshots; --resume=1 continues from ckpt_fn if present
    ckpt_fn = Field(str, default="", help="checkpoint file (enables saving)")
    ckpt_every = Field(int, default="0", help="save every N steps (0: at end only)")
    resume = Field(bool, default="0", help="resume from ckpt_fn if it exists")
    curve_fn = Field(str, default="",
                     help="write the loss curve (step<TAB>loss, 3 sig "
                          "figs) to this output file")
    device = Field(str, default="cuda",
                   help="cuda (the card; raises without one) | cpu (plain versions)")
    kernel_policy = Field(str, default="gen",
                          help="convs and fcs: gen (hand CUDA kernels) | lib (cuDNN/cuBLAS)")
    cuda_graph = Field(bool, default="1",
                       help="on the card: each step captured once as one CUDA graph and "
                            "replayed, its weights and momentum donated (0 = eager, launch "
                            "by launch: the fallback where a capture fails)")

    def main(self) -> None:
        from ..apps.preproc import img_to_batch_np
        from ..frontend.datum import parse_datum
        from ..parallel.checkpoint import load_checkpoint, save_checkpoint
        from ..parallel.schedules import make_lr_schedule
        from ..parallel.train import find_logits_node, make_train_step, train_device
        from ..utils.img_io import Img
        if self.mesh.kids or self.mesh.leaf_val:
            raise ConfigError("train_lmdb --mesh: boda_tpu's train_lmdb declares mesh "
                              "and never reads it (boda_tpu/modes/train_lmdb.py:49), so "
                              "the port refuses it rather than ignore it (ROADMAP §3)")
        dev = train_device(self.device, "train_lmdb")
        pipe, in_dims = load_net(self.model, self.ptt_fn, "", self.img,
                                 self.in_sz, init_seed=self.init_seed)
        logits = find_logits_node(pipe)
        sched = make_lr_schedule(self.lr_schedule, self.lr,
                                 total_steps=self.n_steps,
                                 warmup_steps=self.warmup_steps,
                                 gamma=self.lr_gamma,
                                 step_size=self.lr_step_size)

        def build_step(bn_m):
            return make_train_step(pipe, logits, lr=self.lr,
                                   clip_norm=self.clip_norm,
                                   momentum=self.momentum,
                                   weight_decay=self.weight_decay,
                                   bn_momentum=bn_m,
                                   compute_dtype=self.compute_tn or None,
                                   lr_schedule=sched,
                                   remat=self.remat,
                                   kernel_policy=self.kernel_policy,
                                   cuda_graph=self.cuda_graph)
        step_fn = build_step(self.bn_momentum)
        # bn_freeze_at: a second step with inference-stats BN; the running
        # stats the warmup accumulated live in `weights`, so only the step
        # changes (and a resume past the freeze point lands on it)
        step_frozen = None
        if self.bn_freeze_at > 0 and self.bn_momentum > 0:
            step_frozen = build_step(0.0)

        # all records at once (the committed fixtures are small)
        recs = []
        for _k, val in _iter_records(self.db_fn, self.rec_fn, 0):
            d = parse_datum(val)
            recs.append((d.to_rgb(), d.label))
        if not recs:
            raise ConfigError("no records found")
        dd = in_dims["data"]
        h, w = dd["y"], dd["x"]

        def batch_at(i):
            xs, ys = [], []
            for j in range(self.img):
                rgb, lab = recs[(i * self.img + j) % len(recs)]
                xs.append(Img.from_rgb(rgb).resize(h, w).data)
                ys.append(lab)
            x = img_to_batch_np(np.stack(xs)).astype(np.float32)
            return (torch.from_numpy(x).to(dev),
                    torch.from_numpy(np.asarray(ys, np.int64)).to(dev))

        weights = {k: torch.from_numpy(np.asarray(wv.data, np.float32)).to(dev)
                   for k, wv in pipe.weights.items()}
        mom = None
        start = 0
        ckpt = self.out_path(self.ckpt_fn) if self.ckpt_fn else ""
        if self.resume and ckpt and os.path.exists(ckpt):
            start, w_ck, m_ck = load_checkpoint(ckpt)
            weights = {k: v.to(dev) for k, v in w_ck.items()}
            mom = {k: v.to(dev) for k, v in m_ck.items()} if m_ck is not None else None
            print(f"resumed from {self.ckpt_fn} at step {start}")

        def save(i):
            save_checkpoint(ckpt, i, weights, mom)

        first = last = None
        curve: list[tuple[int, float]] = []
        for i in range(start, self.n_steps):
            x, labels = batch_at(i)
            sfn = step_fn
            if step_frozen is not None and i >= self.bn_freeze_at:
                if i == self.bn_freeze_at:
                    print(f"step {i}: BN frozen (inference running stats)")
                sfn = step_frozen
            if self.momentum > 0:
                loss, weights, mom = sfn(weights, {"data": x}, labels, mom, step=i)
            else:
                loss, weights = sfn(weights, {"data": x}, labels, step=i)
            loss = float(loss)
            if first is None:
                first = loss
            last = loss
            if i % max(1, self.log_every) == 0:
                print(f"step {i}: loss {loss:.3g}")
                curve.append((i, loss))
            if ckpt and self.ckpt_every and (i + 1) % self.ckpt_every == 0:
                save(i + 1)
        if first is None:  # resumed past the end: keep the existing (newer)
            # checkpoint; re-saving would relabel its step backwards
            print(f"train_lmdb: nothing to do (resumed at {start} "
                  f">= n_steps {self.n_steps})")
            return
        if ckpt:
            save(self.n_steps)
        if self.curve_fn:
            with open(self.out_path(self.curve_fn), "w") as f:
                for s_i, lv in curve:
                    f.write(f"{s_i}\t{lv:.3g}\n")
            print(f"wrote loss curve ({len(curve)} points) to "
                  f"{self.curve_fn}")
        print(f"train_lmdb: {self.n_steps - start} steps over {len(recs)} "
              f"records, loss {first:.3g} -> {last:.3g} "
              f"({'improved' if last < first else 'NOT improved'})")
