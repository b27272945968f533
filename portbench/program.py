"""The program under test, as the traffic drivers reach it: a zoo net of
boda_tpu_torch on the configuration's engine with the seed's weights, and
its served entry (modes/serve_bench.py: ``ServedNet``).
Everything of the program is imported inside these functions."""

from __future__ import annotations

import torch

from . import harness as H


def net_with_weights(r, batch: int, dtype):
    """(pipe, input dims, weights) of the configuration's zoo net at
    ``batch``: the weights drawn from the seed on the device in ``dtype``
    (the reference's spec, by the prototxt's names) and set in the pipe."""
    from boda_tpu_torch.models.zoo import build_model
    from boda_tpu_torch.utils.carry import weights_from_numpy
    pipe, in_dims = build_model(r.cfg["model"], img=batch, in_sz=r.size)
    spec = r.reference().spec(r.cfg)
    have = {k: tuple(w.dims.shape) for k, w in pipe.weights.items()}
    want = {k: tuple(s) for k, s, _ in spec}
    if have != want:
        raise H.BenchError(f"the reference's parameters differ from the zoo's "
                           f"{r.cfg['model']}: {sorted(set(have.items()) ^ set(want.items()))[:6]}")
    w = H.seeded_params(spec, r.seed, r.dev, dtype)
    weights_from_numpy(pipe, {k: v.float().cpu().numpy() for k, v in w.items()})
    return pipe, in_dims["data"], w


def served(eng, names: list, batch: int, y: int, x: int):
    """The program's ``ServedNet`` on ``names[0]``, built (captured on the
    card), whose net runs up to every node of ``names``: a graph cut there.
    Only ``names[0]``'s output is kept; the others' kernels run in the graph
    all the same."""
    from boda_tpu_torch.modes.serve_bench import ServedNet
    net = ServedNet(eng, names[0], batch, y, x)
    if len(names) > 1:
        net.net_fn = eng.build_raw_fn(list(names))
    return net.build()


def pinned_pool(images: torch.Tensor, n: int, batch: int, dev) -> list:
    """``n`` host batches of ``images`` (n * batch, y, x, 4), pinned on the
    card's host (the uploads read pinned memory), plain on the CPU."""
    out = []
    for i in range(n):
        b = images[i * batch:(i + 1) * batch]
        t = torch.empty(b.shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
        t.copy_(b)
        out.append(t)
    return out
