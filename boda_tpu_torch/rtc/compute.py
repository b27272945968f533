"""The compute-runtime abstraction: named device vars + generated functions.

Counterpart of ``boda_tpu/rtc/compute.py`` with the same var and function
API. Parity target: ``rtc_compute_t`` (ref src/rtc_compute.H:35) — a
pluggable backend interface providing named device variables with ``Dims``,
batched compilation of generated functions, kernel launch by name with a
named arg map, sync, per-call timing, and host<->device copies. Backends are
selected at runtime by the ``be=`` type id (here: cuda/interp).

Port differences:
  * a "generated function" is a Python callable over torch tensors that
    launches the port's hand kernels (or runs a library or plain op);
    "compile" builds the kernel library once (``ops/kernels/build.load``).
  * functions are functional, as in boda_tpu: declared ``out`` args are
    returned and stored back into the var map by ``run``.
  * ``run`` times each call through :meth:`Backend._timed_call`: host
    seconds around the call and a sync here, device seconds between two CUDA
    events on the card (``backends.CudaBackend``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from ..config import Field, register_base
from ..utils.dims import NDA, Dims, np_dtype
from ..utils.timers import timer


@dataclass
class FuncInfo:
    """One generated function: metadata + a python callable over torch tensors.

    ``args`` lists (name, role) with role in {"in", "out"}; ``fn`` takes the
    "in" tensors positionally and returns a tuple of the "out" tensors.
    (The rtc_func_gen analog produces these; ref src/rtc_func_gen.H:147.)
    """

    name: str
    args: list[tuple[str, str]]
    fn: Callable
    flops: float = 0.0
    bytes_accessed: float = 0.0
    info: str = ""  # human-readable generation note (variant, tiles...)
    in_dims: Optional[list[Dims]] = None  # dims of the "in" args

    @property
    def in_names(self) -> list[str]:
        return [n for n, r in self.args if r == "in"]

    @property
    def out_names(self) -> list[str]:
        return [n for n, r in self.args if r == "out"]


@dataclass
class Call:
    """A function invocation: func name + param-name -> var-name map
    (ref rtc_func_call_t, src/rtc_compute.H:120)."""

    fn_name: str
    arg_map: dict[str, str] = field(default_factory=dict)
    call_tag: str = ""


class RtcError(RuntimeError):
    pass


@register_base("be", tid_vn="be")
class Backend:
    """Abstract compute backend. Concrete: cuda (the card), interp (oracle)."""

    show_compile_log = Field(bool, default="0", help="print per-func compile info")
    show_calls = Field(bool, default="0", help="print every run() call")

    def base_setup(self) -> None:
        self.vars: dict[str, tuple[Dims, object]] = {}
        self.funcs: dict[str, FuncInfo] = {}
        self._pending: list[FuncInfo] = []
        self._compiled: dict[str, Callable] = {}
        self._call_durs: list[tuple[str, float]] = []  # (tag, secs) per timed call
        self.init()

    # -- backend identity ------------------------------------------------------
    def init(self) -> None:
        raise NotImplementedError

    def get_plat_tag(self) -> str:
        raise NotImplementedError

    # kernel-generation context flags (consumed by ops/ generators)
    def use_ref_impl(self) -> bool:
        return False

    def plain_mode(self) -> bool:
        """True where the kernels' plain versions run (a CPU device)."""
        return False

    def torch_device(self):
        raise NotImplementedError

    # -- var management (ref rtc_compute.H:48-52) --------------------------------
    def create_var_with_dims(self, name: str, dims: Dims) -> None:
        if name in self.vars:
            raise RtcError(f"var {name!r} already exists")
        self.vars[name] = (dims, self._zeros(dims))

    def create_var_from_nda(self, name: str, nda: NDA) -> None:
        if name in self.vars:
            raise RtcError(f"var {name!r} already exists")
        self.vars[name] = (nda.dims, self._upload(nda))

    def copy_nda_to_var(self, name: str, nda: NDA) -> None:
        dims, _ = self._get(name)
        if not dims.matches(nda.dims, check_names=False):
            raise RtcError(f"copy to var {name!r}: dims mismatch {dims} vs {nda.dims}")
        self.vars[name] = (dims, self._upload(nda))

    def copy_var_to_nda(self, name: str) -> NDA:
        dims, arr = self._get(name)
        return NDA(dims, np.asarray(self._download(arr), dtype=np_dtype(dims.tn)))

    def release_var(self, name: str) -> None:
        self._get(name)
        del self.vars[name]

    def release_all_vars(self) -> None:
        self.vars.clear()

    def set_var_to_zero(self, name: str) -> None:
        dims, _ = self._get(name)
        self.vars[name] = (dims, self._zeros(dims))

    def get_var_dims(self, name: str) -> Dims:
        return self._get(name)[0]

    def var_exists(self, name: str) -> bool:
        return name in self.vars

    def get_var_raw(self, name: str):
        return self._get(name)[1]

    def set_var_raw(self, name: str, dims: Dims, arr) -> None:
        self.vars[name] = (dims, arr)

    def _get(self, name: str):
        if name not in self.vars:
            raise RtcError(f"no var named {name!r}; have {sorted(self.vars)}")
        return self.vars[name]

    # -- function management (ref rtc_compute.H:55-60) -----------------------------
    def add_func(self, fi: FuncInfo) -> None:
        if fi.name in self.funcs:
            raise RtcError(f"function {fi.name!r} already added")
        self.funcs[fi.name] = fi
        self._pending.append(fi)

    def compile(self) -> None:
        """Batch-compile all pending functions (ref deferred-compile model,
        src/rtc_func_gen.cc:636)."""
        for fi in self._pending:
            with timer("rtc_compile"):
                self._compiled[fi.name] = self._compile_one(fi)
            if self.show_compile_log:
                print(f"compiled {fi.name}: {fi.info}")
        self._pending.clear()

    def run(self, call: Call) -> int:
        """Execute a compiled function; returns a call id usable with get_dur."""
        fi = self.funcs.get(call.fn_name)
        if fi is None:
            raise RtcError(f"no function named {call.fn_name!r}")
        if fi.name not in self._compiled:
            raise RtcError(f"function {call.fn_name!r} not compiled yet (call compile())")
        ins = []
        for pname in fi.in_names:
            vn = call.arg_map.get(pname)
            if vn is None:
                raise RtcError(f"call {call.fn_name}: missing arg {pname!r}")
            ins.append(self._get(vn)[1])
        if self.show_calls:
            print(f"run {call.fn_name} {call.arg_map}")
        outs, dt = self._timed_call(self._compiled[fi.name], ins)
        if not isinstance(outs, (tuple, list)):
            outs = (outs,)
        in_vars = {call.arg_map[p] for p in fi.in_names}
        for pname, arr in zip(fi.out_names, outs):
            vn = call.arg_map.get(pname)
            if vn is None:
                raise RtcError(f"call {call.fn_name}: missing out arg {pname!r}")
            self._store_out(vn, self._get(vn)[0], arr, in_vars)
        self._call_durs.append((call.call_tag or call.fn_name, dt))
        return len(self._call_durs) - 1

    def finish_and_sync(self) -> None:
        for _, arr in self.vars.values():
            self._block_on((arr,))

    def get_dur(self, b: int, e: int) -> float:
        """Total seconds over calls [b, e] inclusive (ref rtc_compute.H:70)."""
        return sum(d for _, d in self._call_durs[b:e + 1])

    # -- backend-specific primitives ------------------------------------------------
    def _store_out(self, vn: str, dims: Dims, arr, in_vars: set) -> None:
        """Bind a call's output to its var (``in_vars``: the call's input
        vars, for a backend that may write into their buffers)."""
        self.vars[vn] = (dims, arr)

    def _timed_call(self, fn: Callable, ins: list):
        """(outs, secs) of one call: host seconds around the call and a sync."""
        t0 = time.perf_counter()
        outs = fn(*ins)
        self._block_on(outs if isinstance(outs, (tuple, list)) else (outs,))
        return outs, time.perf_counter() - t0

    def _zeros(self, dims: Dims):
        raise NotImplementedError

    def _upload(self, nda: NDA):
        raise NotImplementedError

    def _download(self, arr) -> np.ndarray:
        raise NotImplementedError

    def _compile_one(self, fi: FuncInfo) -> Callable:
        raise NotImplementedError

    def _block_on(self, arrs) -> None:
        pass
