"""Kernel generation: op signature + tune -> compiled-function factory.

Counterpart of ``boda_tpu/ops/registry.py``. Parity target: ``rtc_codegen_t``
(ref src/rtc_func_gen.H:170) — the cache mapping op signatures to
generated-function instantiations with unique deterministic naming and
batched deferred compilation — and the per-op custom codegen hook
(``custom_codegen_t``, ref src/rtc_func_gen.H:37).

A "generator" is a python function building a callable over torch tensors
(a hand CUDA kernel's wrapper, a library op, or a plain version) from
(op, tune, ctx); there is no source-string templating. The cache is keyed on
exactly (op.key, tune.key).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..rtc.compute import Backend, Call, FuncInfo, RtcError
from .op_base import Op
from .tune import OpTune


@dataclass(frozen=True)
class GenCtx:
    use_ref: bool    # build the plain f32 version (the interp oracle)
    plain: bool      # the kernels' plain versions run (a CPU device)
    platform: str    # the torch device type: 'cuda' | 'cpu'
    device: str      # the torch device, for functions with no inputs


# op type -> generator(op, tune, ctx) -> FuncInfo (name filled in by Codegen)
_GENERATORS: dict[str, Callable[[Op, OpTune, GenCtx], FuncInfo]] = {}


def kernel_gen(op_type: str):
    def deco(fn):
        _GENERATORS[op_type] = fn
        return fn
    return deco


def has_generator(op_type: str) -> bool:
    return op_type in _GENERATORS


def tune_note(tune: OpTune) -> str:
    """The info-string tail naming the tune's knobs that do nothing here."""
    ne = tune.no_effect()
    return f" (no effect on the card: {','.join(ne)})" if ne else ""


class Codegen:
    """Per-backend function cache + unique naming + deferred compile."""

    def __init__(self, be: Backend):
        self.be = be
        self._cache: dict[tuple[str, str], FuncInfo] = {}
        self._n = 0

    def ctx(self) -> GenCtx:
        d = self.be.torch_device()
        return GenCtx(use_ref=self.be.use_ref_impl(), plain=self.be.plain_mode(),
                      platform=d.type, device=str(d))

    def gen_func(self, op: Op, tune: OpTune = OpTune()) -> FuncInfo:
        key = (op.key(), tune.key())
        fi = self._cache.get(key)
        if fi is not None:
            return fi
        if hasattr(self.be, "remote_gen_func"):
            # remote backends regenerate kernels worker-side from the signature
            fi = self.be.remote_gen_func(op, tune)
            self._cache[key] = fi
            return fi
        gen = _GENERATORS.get(op.type)
        if gen is None:
            raise RtcError(f"no kernel generator for op type {op.type!r}; "
                           f"have {sorted(_GENERATORS)}")
        fi = gen(op, tune, self.ctx())
        fi.name = f"{op.type}__{self._n}"
        self._n += 1
        self.be.add_func(fi)
        self._cache[key] = fi
        return fi

    def compile(self) -> None:
        self.be.compile()

    def run_func(self, fi: FuncInfo, arg_map: dict[str, str], call_tag: str = "") -> int:
        return self.be.run(Call(fi.name, arg_map, call_tag or fi.name))


# import kernel modules so their generators register (mirrors modes_all)
def _import_kernels() -> None:
    from .kernels import conv, elementwise, gen_data, sgemm  # noqa: F401


_import_kernels()
