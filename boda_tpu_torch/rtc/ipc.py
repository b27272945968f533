"""IPC/remote compute backend: the full backend interface proxied to a worker.

Counterpart of ``boda_tpu/rtc/ipc.py``, with its commands and its bytes on
the wire. Parity target: ``ipc_compute_t`` / ``ipc_compute_worker_t`` (ref
src/rtc_ipc.cc:82,:333): every backend operation crosses a byte-stream to a
worker process (spawned as a child or reached over TCP), with bulk tensors as
raw bytes. Where the reference ships kernel *source* strings, we ship
(op signature, tune) pairs and the worker regenerates the kernel locally.

The worker's backend defaults to the card (``worker_be=(be=cuda)``); a worker
whose backend cannot start (no card) returns its error to the master, which
raises it as :class:`RtcError`. A bf16 var travels as 2 bytes per element
(the upper half of its float32 bits, rounded to nearest even), as boda_tpu
sends its ``ml_dtypes`` bfloat16 arrays; the port's host arrays hold bf16 as
float32 (utils/dims.py), so the two packages' byte streams are the same.

Worker spawn: a child of this interpreter over an inherited socketpair
(``fds:``), any ``spawn_str``, or an already-listening TCP worker.
"""

from __future__ import annotations

import os
import shlex
import socket
import subprocess
import sys

import numpy as np
import torch

from ..config import Field, register
from ..utils.dims import NDA, Dims, np_dtype
from .compute import Backend, Call, FuncInfo, RtcError
from .stream_util import ByteStream, make_stream


def to_wire(nda: NDA) -> bytes:
    """A host array's bytes as they cross the stream: bf16 as 2 bytes per
    element, every other dtype as its numpy storage."""
    if nda.dims.tn == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(nda.data, dtype=np.float32))
        return t.to(torch.bfloat16).view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(nda.data, dtype=np_dtype(nda.dims.tn)).tobytes()


def from_wire(dims: Dims, raw: bytes) -> NDA:
    """The host array of a var received as ``raw`` (bf16 back to float32)."""
    if dims.tn == "bfloat16":
        i16 = torch.from_numpy(np.frombuffer(raw, dtype=np.int16).copy())
        return NDA(dims, i16.view(torch.bfloat16).float().numpy())
    return NDA(dims, np.frombuffer(raw, dtype=np_dtype(dims.tn)).copy())


@register("be", "ipc", help="remote backend: proxy all ops to a worker process")
class IpcBackend(Backend):
    addr = Field(str, default="", help="transport addr (empty: spawn child over fds:)")
    spawn_str = Field(str, default="", help="custom worker command (%(addr) expanded)")
    worker_be = Field("lexp", default="(be=cuda)", help="backend the worker uses")
    listen = Field(bool, default="0", help="listen+accept instead of connect (tcp)")

    def init(self) -> None:
        self._proc = None
        if self.addr:
            self._stream = make_stream(self.addr, listen=self.listen)
        else:
            self._stream = self._spawn_child()
        try:  # handshake: configure the worker's backend
            tag = self._rpc("init", str(self.worker_be))
        except RtcError:
            self.shutdown()
            raise
        self._plat = f"ipc:{tag[0]}"

    def _spawn_child(self) -> ByteStream:
        ours, theirs = socket.socketpair()
        ours.setblocking(True)
        fd = theirs.fileno()
        addr = f"fds:{fd}:{fd}"
        if self.spawn_str:
            cmd = shlex.split(self.spawn_str.replace("%(addr)", addr))
        else:
            cmd = [sys.executable, "-m", "boda_tpu_torch", "ipc_compute_worker",
                   f"--addr={addr}"]
        # the child imports this package from wherever the master runs
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH", "")) if p))
        self._proc = subprocess.Popen(cmd, pass_fds=(fd,), close_fds=True, env=env)
        theirs.close()
        return ByteStream(ours.makefile("rb", buffering=0),
                          ours.makefile("wb"), "fds:child")

    # -- rpc plumbing ------------------------------------------------------------
    def _rpc(self, cmd: str, *args):
        self._stream.write_msg(cmd, *args)
        resp = self._stream.read_msg()
        if resp and resp[0] == "err":
            raise RtcError(f"ipc worker error in {cmd!r}: {resp[1]}")
        return resp[1:]

    def get_plat_tag(self) -> str:
        return self._plat

    def torch_device(self):  # the tensors live in the worker
        raise RtcError("ipc backend has no local device")

    # -- var management (proxied) ---------------------------------------------------
    def create_var_with_dims(self, name: str, dims: Dims) -> None:
        self._rpc("create_var", name, str(dims))
        self.vars[name] = (dims, None)

    def create_var_from_nda(self, name: str, nda: NDA) -> None:
        self._rpc("create_var_from", name, str(nda.dims), to_wire(nda))
        self.vars[name] = (nda.dims, None)

    def copy_nda_to_var(self, name: str, nda: NDA) -> None:
        self._rpc("copy_to_var", name, str(nda.dims), to_wire(nda))

    def copy_var_to_nda(self, name: str) -> NDA:
        dims_s, raw = self._rpc("copy_from_var", name)
        return from_wire(Dims.parse(dims_s), raw)

    def release_var(self, name: str) -> None:
        self._rpc("release_var", name)
        self.vars.pop(name, None)

    def release_all_vars(self) -> None:
        self._rpc("release_all_vars")
        self.vars.clear()

    def set_var_to_zero(self, name: str) -> None:
        self._rpc("set_var_to_zero", name)

    def get_var_dims(self, name: str) -> Dims:
        return Dims.parse(self._rpc("get_var_dims", name)[0])

    def var_exists(self, name: str) -> bool:
        return bool(self._rpc("var_exists", name)[0])

    # -- codegen/run (proxied at the op-signature level) ------------------------------
    def remote_gen_func(self, op, tune) -> FuncInfo:
        name, nargs_s, flops, byts, info = self._rpc("gen_func", op.key(), tune.key())
        args = [tuple(a.split(":")) for a in nargs_s.split(",")]
        fi = FuncInfo(name=name, args=args, fn=None, flops=flops,
                      bytes_accessed=byts, info=f"ipc:{info}")
        self.funcs[name] = fi
        return fi

    def compile(self) -> None:
        self._rpc("compile")
        self._pending.clear()

    def run(self, call: Call) -> int:
        flat = []
        for k, v in call.arg_map.items():
            flat += [k, v]
        (dur,) = self._rpc("run", call.fn_name, *flat)
        self._call_durs.append((call.call_tag or call.fn_name, float(dur)))
        return len(self._call_durs) - 1

    def time_func(self, call: Call, n_iters: int = 20, warmup: int = 3) -> float:
        flat = []
        for k, v in call.arg_map.items():
            flat += [k, v]
        (secs,) = self._rpc("time_func", call.fn_name, n_iters, warmup, *flat)
        return float(secs)

    def finish_and_sync(self) -> None:
        self._rpc("finish_and_sync")

    def shutdown(self) -> None:
        try:
            self._stream.write_msg("quit")
            self._stream.close()
        except (OSError, ValueError):
            pass  # the worker is gone already
        if self._proc is not None:
            self._proc.wait(timeout=30)


def worker_loop(stream: ByteStream) -> None:
    """Serve backend RPCs until 'quit'/EOF (ref ipc_compute_worker_t::main)."""
    from ..config import instantiate
    from ..ops.op_base import Op
    from ..ops.registry import Codegen
    from ..ops.tune import OpTune
    from ..utils.lexp import parse_lexp
    be = None
    cg = None
    while True:
        try:
            msg = stream.read_msg()
        except Exception:
            return  # EOF: parent died (ref: worker-death detection via stream EOF)
        cmd, args = msg[0], msg[1:]
        try:
            if cmd == "quit":
                return  # no reply: master closes immediately after sending
            if cmd == "init":
                be = instantiate("be", parse_lexp(args[0]))
                cg = Codegen(be)
                stream.write_msg("ok", be.get_plat_tag())
                continue
            if be is None:
                raise RtcError("init not called")
            if cmd == "create_var":
                be.create_var_with_dims(args[0], Dims.parse(args[1]))
                out = []
            elif cmd == "create_var_from":
                be.create_var_from_nda(args[0], from_wire(Dims.parse(args[1]), args[2]))
                out = []
            elif cmd == "copy_to_var":
                be.copy_nda_to_var(args[0], from_wire(Dims.parse(args[1]), args[2]))
                out = []
            elif cmd == "copy_from_var":
                nda = be.copy_var_to_nda(args[0])
                out = [str(nda.dims), to_wire(nda)]
            elif cmd == "release_var":
                be.release_var(args[0])
                out = []
            elif cmd == "release_all_vars":
                be.release_all_vars()
                out = []
            elif cmd == "set_var_to_zero":
                be.set_var_to_zero(args[0])
                out = []
            elif cmd == "get_var_dims":
                out = [str(be.get_var_dims(args[0]))]
            elif cmd == "var_exists":
                out = [int(be.var_exists(args[0]))]
            elif cmd == "gen_func":
                fi = cg.gen_func(Op.parse(args[0]), OpTune.parse(args[1]))
                out = [fi.name, ",".join(f"{n}:{r}" for n, r in fi.args),
                       float(fi.flops), float(fi.bytes_accessed), fi.info]
            elif cmd == "compile":
                cg.compile()
                out = []
            elif cmd == "run":
                arg_map = dict(zip(args[1::2], args[2::2]))
                cid = be.run(Call(args[0], arg_map))
                out = [be.get_dur(cid, cid)]
            elif cmd == "time_func":
                arg_map = dict(zip(args[3::2], args[4::2]))
                out = [float(be.time_func(Call(args[0], arg_map), n_iters=int(args[1]),
                                          warmup=int(args[2])))]
            elif cmd == "finish_and_sync":
                be.finish_and_sync()
                out = []
            else:
                raise RtcError(f"unknown ipc command {cmd!r}")
            stream.write_msg("ok", *out)
        except Exception as e:  # report to the master, keep serving
            try:
                stream.write_msg("err", f"{type(e).__name__}: {e}")
            except OSError:
                return  # peer gone
