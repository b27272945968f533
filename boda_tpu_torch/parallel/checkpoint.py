"""Atomic training-state checkpoints: weights + momentum + step.

Counterpart of ``boda_tpu/parallel/checkpoint.py``, in its format: one .npz
with the weights under ``w/<name>``, the momentum under ``m/<name>`` and a
JSON ``__meta__`` (step, dtype manifest, has_mom), written to a temp file and
``os.replace``'d, so a killed run never leaves a truncated checkpoint.
bfloat16 arrays are stored as uint16 views named in the manifest. Arrays are
kept in boda_tpu's logical layouts (conv filters OIHW, fc (out, in)), so a
checkpoint written by either package loads in the other. Reading bf16 needs
no ml_dtypes: the uint16 view becomes a torch bfloat16 tensor. Weights and
momenta split over a mesh's tp row (parallel/mesh.py ``Shards``) are
written as their logical arrays, the file a step without a mesh writes;
``load_checkpoint`` with a pipe and a mesh splits them again.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .mesh import Shards, shard_weights


def _host(v) -> tuple[np.ndarray, bool]:
    """(numpy array, is bf16) of a tensor or an array; bf16 as uint16 bits."""
    if isinstance(v, Shards):
        v = v.gather(torch.device("cpu"))
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":  # an ml_dtypes array
        return a.view(np.uint16), True
    return a, False


def _pack(arrays: dict, prefix: str, out: dict, dtypes: dict) -> None:
    for k, v in arrays.items():
        a, bf16 = _host(v)
        key = prefix + k
        if bf16:
            dtypes[key] = "bfloat16"
        out[key] = a


def save_checkpoint(fn: str, step: int, weights: dict,
                    mom_state: dict | None = None) -> None:
    out: dict = {}
    dtypes: dict = {}
    _pack(weights, "w/", out, dtypes)
    if mom_state:
        _pack(mom_state, "m/", out, dtypes)
    out["__meta__"] = np.frombuffer(json.dumps(
        {"step": int(step), "dtypes": dtypes,
         "has_mom": bool(mom_state)}).encode(), dtype=np.uint8)
    tmp = fn + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **out)
    os.replace(tmp, fn)  # atomic: readers never see a partial file


def load_checkpoint(fn: str, pipe=None, mesh=None,
                    dp: int = 0) -> tuple[int, dict, dict | None]:
    """-> (step, weights, mom_state-or-None), as CPU torch tensors; given
    the pipe and a mesh, on dp slice ``dp``'s tp row as shard_weights
    places them."""
    z = np.load(fn)
    meta = json.loads(bytes(z["__meta__"]).decode())
    dtypes = meta["dtypes"]

    def unpack(prefix):
        out = {}
        for key in z.files:
            if not key.startswith(prefix):
                continue
            a = np.array(z[key])  # a writable copy
            if dtypes.get(key) == "bfloat16":
                out[key[len(prefix):]] = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            else:
                out[key[len(prefix):]] = torch.from_numpy(a)
        return out

    weights = unpack("w/")
    mom = unpack("m/") if meta["has_mom"] else None
    if mesh is not None:
        weights = shard_weights(weights, pipe, mesh, dp)
        mom = shard_weights(mom, pipe, mesh, dp) if mom is not None else None
    return meta["step"], weights, mom
