"""ResNet-50 in its Caffe form (He et al. 2015, arXiv:1512.03385;
KaimingHe/deep-residual-networks ResNet-50-deploy.prototxt): a 7x7/2 stem,
max pool 3x3/2, bottleneck blocks of (3, 4, 6, 3) with the stride on the
first 1x1 of a stage, each conv followed by BatchNorm and Scale, a global
average pool and fc1000. Plain float32 PyTorch; parameter names are the
prototxt's layer names with a ``__<blob>`` suffix.

``spec(cfg)`` lists every parameter with its shape and its seeded
initialisation, ``layers(cfg, batch)`` the conv and fc work of one forward,
``forward`` the net in deploy or train mode, ``train_steps`` the SGD steps
the benchmark's training cells run.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import common as C

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))


def _blocks():
    """(tag, bn tag, width, in channels, stride, has branch1) of each block."""
    in_c = 64
    for stage, (n, width) in enumerate(STAGES, start=2):
        for bi in range(n):
            tag = f"res{stage}{chr(ord('a') + bi)}"
            stride = 2 if (bi == 0 and stage > 2) else 1
            yield tag, f"bn{stage}{chr(ord('a') + bi)}", width, in_c, stride, bi == 0
            in_c = width * 4


def _convs():
    """(name, bn name, in, out, k, stride, pad) of every conv, in order."""
    out = [("conv1", "bn_conv1", 3, 64, 7, 2, 3)]
    for tag, bn, width, in_c, stride, b1 in _blocks():
        if b1:
            out.append((f"{tag}_branch1", f"{bn}_branch1", in_c, width * 4, 1, stride, 0))
        out += [(f"{tag}_branch2a", f"{bn}_branch2a", in_c, width, 1, stride, 0),
                (f"{tag}_branch2b", f"{bn}_branch2b", width, width, 3, 1, 1),
                (f"{tag}_branch2c", f"{bn}_branch2c", width, width * 4, 1, 1, 0)]
    return out


def spec(cfg) -> list:
    """[(name, shape, init)] of every parameter. init: ("he", fan_in, gain),
    ("normal", mean, std), ("uniform", lo, hi) or ("const", value)."""
    init = cfg["init"]
    out = []
    for name, bn, ci, co, k, _, _ in _convs():
        gain = init["first_conv_gain"] if name == "conv1" else 1.0
        out += [(f"{name}__filts", (co, ci, k, k), ("he", ci * k * k, gain)),
                (f"{name}__biases", (co,), ("normal", 0.0, init["bias_std"])),
                (f"{bn}__means", (co,), ("normal", 0.0, init["bn_mean_std"])),
                (f"{bn}__vars", (co,), ("uniform", 1.0, 1.0 + init["bn_var_spread"])),
                (f"{bn}__sf", (1,), ("const", 1.0)),
                (f"{bn}_scale__scales", (co,), ("uniform", 1.0, 1.0 + init["scale_spread"])),
                (f"{bn}_scale__biases", (co,), ("normal", 0.0, init["shift_std"]))]
    n_cls = cfg["num_classes"]
    out += [(f"fc{n_cls}__filts", (n_cls, 2048), ("he", 2048, 1.0)),
            (f"fc{n_cls}__biases", (n_cls,), ("normal", 0.0, init["bias_std"]))]
    return out


def layers(cfg, batch: int, size: int = 0) -> list:
    """The conv and fc work of one forward: dicts of name, kind ("conv" or
    "fc"), n, h, w, c, oc, k, stride, pad, dil, oh, ow and first (the conv
    on the input, whose input gradient no training step needs)."""
    out = []

    def add(name, ih, ci, co, k, s, p):
        oh = C.conv_out(ih, k, s, p)
        out.append(dict(name=name, kind="conv", n=batch, h=ih, w=ih, c=ci, oc=co, k=k,
                        stride=s, pad=p, dil=1, oh=oh, ow=oh, first=name == "conv1"))
        return oh

    h = add("conv1", size or cfg["image_size"], 3, 64, 7, 2, 3)
    h = C.pool_out_ceil(h, 3, 2)
    for tag, _, width, in_c, stride, b1 in _blocks():
        if b1:
            add(f"{tag}_branch1", h, in_c, width * 4, 1, stride, 0)
        h2 = add(f"{tag}_branch2a", h, in_c, width, 1, stride, 0)
        add(f"{tag}_branch2b", h2, width, width, 3, 1, 1)
        h = add(f"{tag}_branch2c", h2, width, width * 4, 1, 1, 0)
    n_cls = cfg["num_classes"]
    out.append(dict(name=f"fc{n_cls}", kind="fc", n=batch, h=1, w=1, c=2048, oc=n_cls, k=1,
                    stride=1, pad=0, dil=1, oh=1, ow=1, first=False))
    return out


def forward(p: dict, x: torch.Tensor, cfg, train: bool = False, quant=None,
            stats: dict | None = None) -> torch.Tensor:
    """Logits of the NCHW float32 batch x. Deploy mode normalises with the
    stored statistics; train mode with the batch's, and puts each BatchNorm's
    (batch mean, batch variance) into ``stats``."""
    def o(t):
        return C.out(t, quant)

    def cbs(t, name, bn, s, pad):
        t = o(C.conv(t, p[f"{name}__filts"], p[f"{name}__biases"], s, pad, quant=quant))
        if train:
            t, m, v = C.batchnorm_train(t)
            if stats is not None:
                stats[bn] = (m.detach(), v.detach())
        else:
            t = C.batchnorm_deploy(t, p[f"{bn}__means"], p[f"{bn}__vars"], p[f"{bn}__sf"])
        return o(C.scale(o(t), o(p[f"{bn}_scale__scales"]), o(p[f"{bn}_scale__biases"])))

    t = o(F.relu(cbs(x, "conv1", "bn_conv1", 2, 3)))
    t = C.maxpool_ceil(t, 3, 2)
    for tag, bn, width, in_c, stride, b1 in _blocks():
        sc = cbs(t, f"{tag}_branch1", f"{bn}_branch1", stride, 0) if b1 else t
        u = F.relu(cbs(t, f"{tag}_branch2a", f"{bn}_branch2a", stride, 0))
        u = F.relu(cbs(u, f"{tag}_branch2b", f"{bn}_branch2b", 1, 1))
        u = cbs(u, f"{tag}_branch2c", f"{bn}_branch2c", 1, 0)
        t = o(F.relu(sc + u))
    t = o(t.mean(dim=(2, 3)))
    n_cls = cfg["num_classes"]
    return o(C.fc(t, p[f"fc{n_cls}__filts"], p[f"fc{n_cls}__biases"], quant=quant))


def trainable(name: str) -> bool:
    return not name.endswith(("__means", "__vars", "__sf"))


def train_steps(p0: dict, batches: list, cfg, opt: dict, quant=None) -> dict:
    """SGD with momentum and decoupled weight decay from the parameters p0
    over the (x, labels) batches, one step each: the loss is the mean
    softmax cross-entropy of the logits; m <- momentum * m + g (m from 0);
    w <- w - lr * m - lr * weight_decay * w. Train-mode BatchNorm's running
    statistics are state too: each step, mean <- (1 - bn_momentum) * mean /
    sf + bn_momentum * the batch's mean, the same for the batch's biased
    variance, and sf <- 1. Returns each step's loss, the first step's
    gradient per trainable leaf, the running statistics after the first
    step, and every leaf after the last step."""
    w = {k: v.detach().clone().float() for k, v in p0.items()}
    names = [k for k in w if trainable(k)]
    m = {k: torch.zeros_like(w[k]) for k in names}
    mom = opt["bn_momentum"]
    losses, g1, stats1 = [], None, None
    for x, y in batches:
        leaves = {k: w[k].detach().requires_grad_() for k in names}
        stats: dict = {}
        with torch.enable_grad():
            logits = forward({**w, **leaves}, x, cfg, train=True, quant=quant, stats=stats)
            loss = F.cross_entropy(logits.float(), y.long())
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            if g1 is None:
                g1 = {k: g.detach().clone() for k, g in zip(names, grads)}
            for k, g in zip(names, grads):
                m[k] = opt["momentum"] * m[k] + g
                w[k] = w[k] - opt["lr"] * m[k] - opt["lr"] * opt["weight_decay"] * w[k]
            for bn, (bm, bv) in stats.items():
                sf = w[f"{bn}__sf"]
                inv = torch.where(sf != 0, 1.0 / sf, torch.ones_like(sf))
                w[f"{bn}__means"] = (1 - mom) * w[f"{bn}__means"] * inv + mom * bm
                w[f"{bn}__vars"] = (1 - mom) * w[f"{bn}__vars"] * inv + mom * bv
                w[f"{bn}__sf"] = torch.ones_like(sf)
            if stats1 is None:
                stats1 = {k: v.clone() for k, v in w.items() if k.endswith(("__means", "__vars"))}
    return {"losses": losses, "grad1": g1, "stats1": stats1, "weights": w}
