"""Learning-rate schedules for the training step.

Counterpart of ``boda_tpu/parallel/schedules.py``: the same kinds, errors
and warmup. boda_tpu traces its schedule into the jitted step as f32 jnp
math; the port's step runs eagerly, so the schedule is the same f32 math on
the host, in numpy float32 (every constant converted to f32 where jnp's weak
types would convert it).
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_F = np.float32


def make_lr_schedule(kind: str, base_lr: float, total_steps: int = 0,
                     warmup_steps: int = 0, gamma: float = 0.1,
                     step_size: int = 0) -> Callable:
    """fn(step) -> lr (a numpy float32). kinds: const | step (decay by gamma
    every step_size) | cosine (to 0 over total_steps). warmup_steps > 0
    prepends a linear warmup."""
    if kind not in ("const", "step", "cosine"):
        raise ValueError(f"unknown lr schedule {kind!r} "
                         "(const | step | cosine)")
    if kind == "step" and step_size <= 0:
        raise ValueError("step schedule needs step_size > 0")
    if kind == "cosine" and total_steps <= 0:
        raise ValueError("cosine schedule needs total_steps > 0")

    def sched(step) -> np.float32:
        s = _F(step)
        if kind == "const":
            lr = _F(base_lr)
        elif kind == "step":
            lr = _F(base_lr) * _F(gamma) ** np.floor(s / _F(step_size))
        else:  # cosine
            span = max(1, total_steps - warmup_steps)
            prog = np.clip((s - _F(warmup_steps)) / _F(span), _F(0), _F(1))
            lr = _F(base_lr * 0.5) * (_F(1) + np.cos(_F(np.pi) * prog))
        if warmup_steps > 0:
            lr = lr * np.minimum(_F(1), (s + _F(1)) / _F(warmup_steps))
        return _F(lr)

    return sched
