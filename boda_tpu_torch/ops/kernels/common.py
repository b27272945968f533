"""Shared helpers for the kernel wrappers, and the tile plan of the GEMM core
(``csrc/gemm.cuh``) that K1 (``sgemm.py``) and K2/K3 (``conv.py``) share; K5's
plan (``bconv.py:plan_atb``) ranks its tiles by the same cost model."""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, NamedTuple

import torch

KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the C side's dtype codes


def epilogue(acc: torch.Tensor, bias, residual, relu: bool, out_dtype):
    """The kernels' store epilogue on an f32 accumulator: +bias (+residual)
    (+ReLU), then cast (the order of sgemm.py:_matmul_bias_kernel)."""
    if bias is not None:
        acc = acc + bias.float()
    if residual is not None:
        acc = acc + residual.float()
    if relu:
        acc = torch.clamp_min(acc, 0.0)
    return acc.to(out_dtype)


# -- the kernels' calls, recorded on demand (the engine's gen_src plan) ----------

_record: list | None = None  # the calls while recording() is on
_depth = 0                   # entries in progress: a nested entry (a dgrad's conv) records once


class KernelCall(NamedTuple):
    kernel: str          # "K1" .. "K9", boda_tpu's kernel that the entry ports
    entry: str           # the wrapper's name
    plan: Any            # the plan it launched with, or "plain" for CPU tensors
    operands: list[str]  # dtype[shape] of each tensor argument, then of the result


def describe(t: torch.Tensor) -> str:
    dt = str(t.dtype).removeprefix("torch.")
    return f"{dt}[{','.join(map(str, t.shape))}]"


def kernel_entry(kernel: str, plan_of: Callable[[], Any]):
    """Decorator of a kernel's entry point: while :func:`recording` is on,
    each outermost call appends a :class:`KernelCall` (``plan_of()`` gives
    the plan of the launch just made; on CPU tensors the plain version ran).
    Off, it adds one test of a global."""
    def deco(fn):
        @functools.wraps(fn)
        def entry(*args, **kw):
            global _depth
            if _record is None:
                return fn(*args, **kw)
            _depth += 1
            try:
                out = fn(*args, **kw)
            finally:
                _depth -= 1
            if _depth == 0:
                ts = [a for a in args if isinstance(a, torch.Tensor)]
                on_card = bool(ts) and ts[0].device.type == "cuda"
                _record.append(KernelCall(kernel, fn.__name__,
                                          plan_of() if on_card else "plain",
                                          [describe(t) for t in ts + [out]]))
            return out
        return entry
    return deco


def in_kernel() -> bool:
    """A kernel entry is running (its plain version's PyTorch calls are
    the kernel's, not the library's)."""
    return _depth > 0


@contextlib.contextmanager
def recording():
    """Record the kernel entries' calls into the list it yields."""
    global _record
    prev, _record = _record, []
    try:
        yield _record
    finally:
        _record = prev


def _check_kind(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def check_operand(name: str, t: torch.Tensor, dev, dtype, shape) -> None:
    """What a launch needs of each operand: same card, same dtype, the shape
    the kernel indexes with, and dense row-major storage."""
    _check_kind(name, t, dev, dtype, shape)
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_rows(name: str, t: torch.Tensor, dev, dtype, shape) -> int:
    """:func:`check_operand` for an operand read as rows (the GEMM core's B:
    the GEMM's [K,N], the conv's HWIO filters as KH*KW*C rows of OC; the
    GEMM's A [M,K]; K5's B [K,N]): its rows of N elements may lie further
    apart than N, as in :func:`pad_rows`'s and :func:`copy_rows`' views, so
    long as every other dimension is dense over them. Returns the row stride
    (``ldb``, ``lda``) in elements (N for a contiguous operand)."""
    _check_kind(name, t, dev, dtype, shape)
    if t.is_contiguous():
        return shape[-1]
    ldb = next((t.stride(i) for i in range(t.dim() - 2, -1, -1) if t.shape[i] > 1),
               shape[-1])
    dense = [ldb]
    for n in reversed(shape[1:-1]):
        dense.insert(0, dense[0] * n)
    if (t.shape[-1] > 1 and t.stride(-1) != 1) or ldb < shape[-1] or any(
            n > 1 and st != want for n, st, want in zip(shape[:-1], t.stride()[:-1], dense)):
        raise ValueError(f"{name}: strides {t.stride()} are not rows of {shape[-1]} "
                         "elements at one stride")
    return ldb


def pad_rows(t: torch.Tensor) -> torch.Tensor:
    """t as the ``[..., :N]`` view of a zero-padded copy whose rows are a
    multiple of 8 elements (16 bytes of bf16): the layout in which the GEMM
    core's wgmma paths read a B with N % 8 != 0 by TMA. A contiguous copy of
    t where N % 8 == 0."""
    pad = -t.shape[-1] % 8
    if not pad:
        return t.contiguous()
    return torch.nn.functional.pad(t, (0, pad))[..., :t.shape[-1]]


def copy_rows(t: torch.Tensor, dtype) -> torch.Tensor:
    """t in ``dtype``, written once (one copy, as ``t.to(dtype).contiguous()``
    makes) into rows of a multiple of 8 elements where its last dimension is
    off 8, as the ``[..., :N]`` view: the layout in which the GEMM core's
    wgmma paths read a GEMM's A with K % 8 != 0, and K5's wgmma_edge its B,
    by TMA. The padding is not written: no kernel reads it (TMA reads the
    columns past the view as zeros, the other paths mask them)."""
    n = t.shape[-1]
    if n % 8 == 0:
        return t.to(dtype).contiguous()
    out = torch.empty(t.shape[:-1] + (cdiv(n, 8) * 8,), dtype=dtype, device=t.device)
    out = out[..., :n]
    out.copy_(t)
    return out


def kernel_dtype(t: torch.Tensor) -> int:
    code = KERNEL_DTYPES.get(t.dtype)
    if code is None:
        raise ValueError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return code


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def aligned16(*ts) -> bool:
    """Every given tensor starts on a 16-byte boundary (None counts as
    aligned)."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in ts)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev: torch.device) -> int:
    """The card's SM count (132 on an H100 SXM)."""
    return _sm_count(dev.index if dev.index is not None else torch.cuda.current_device())


# -- the GEMM core's tile plan ------------------------------------------------------

# the C side's path codes (gemm.cuh enum Path)
PATH_CODES = {"fma": 0, "mma": 1, "wgmma": 2, "wgmma_narrow": 3, "wgmma_edge": 4}
WGMMA_PATHS = ("wgmma", "wgmma_narrow", "wgmma_edge")  # B by TMA: 16-byte rows
WGMMA_CHUNK = 64     # K per ring stage (128 bytes of bf16)
SMEM_LIMIT = 232448  # shared memory one block may use on Hopper (227 KB)


class GemmPlan(NamedTuple):
    path: str   # "wgmma" | "wgmma_narrow" | "wgmma_edge" | "mma" | "fma"
    bm: int     # output tile rows
    bn: int     # output tile columns
    split: int  # K splits (1: none); divides the K chunks on the wgmma path
    ctas: int   # thread blocks of the main kernel (wgmma: persistent, at most one per SM)


def wgmma_stages(bm: int, bn: int) -> int:
    """Ring stages of a wgmma block (gemm.cuh RingLayout): as many as fit
    beside the bf16 output tile, at most 8."""
    free = SMEM_LIMIT - 1024 - 1536 - bm * bn * 2
    return min(8, free // (WGMMA_CHUNK * 2 * (bm + bn) + 16))


def wgmma_smem(bm: int, bn: int) -> int:
    """Bytes of dynamic shared memory of one wgmma block (gemm.cuh
    RingLayout): the ring, the output tile, the barriers, alignment."""
    stages = wgmma_stages(bm, bn)
    return stages * WGMMA_CHUNK * 2 * (bm + bn) + bm * bn * 2 + 16 * stages + 1024


# The plan's cost model, fitted to every plan's device time at the ResNet-50
# b32 forward's signatures (scripts/torch_gemm_plans.py on an H100 SXM;
# PERF.md §6): µs per 64-deep K chunk of one work item, by tile; the
# conv's cp.async gather per chunk, by tile rows; a work item's fixed cost
# (its epilogue writes the tile at ~25 GB/s, an SM's share of HBM); and a
# split's cost (the reduction's launch and its f32 partials, which stay in
# L2). Work items run in rounds of one per SM on the persistent grid. The
# narrow conv's plans are ranked by the same terms (its fill's cost per chunk
# changes no choice at the narrow shapes: scripts/torch_narrow_conv.py).
_CHUNK_US = {(128, 256): 0.77, (128, 128): 0.41, (128, 64): 0.47,
             (64, 256): 0.60, (64, 128): 0.30, (64, 64): 0.28}
_GATHER_US = {128: 0.41, 64: 0.25}
_MAX_SPLIT = 16


def plan_cost(M: int, N: int, K: int, sms: int, bm: int, bn: int, split: int,
              conv: bool, taps: int = 1, out_bytes: int = 2) -> float:
    """Predicted µs of one wgmma launch under the fitted model. ``conv``: A
    is gathered by cp.async; ``taps``: output tiles per (M, N) tile (the
    weight gradient's filter taps); ``out_bytes``: 2 for the bf16 epilogue,
    4 for the f32 modes. A split's chunks are those of the longest split."""
    items = cdiv(M, bm) * cdiv(N, bn) * taps * split
    chunk = _CHUNK_US[bm, bn] + (_GATHER_US[bm] if conv else 0.0)
    per_item = cdiv(cdiv(K, WGMMA_CHUNK), split) * chunk + 1.5 + bm * bn * out_bytes / 25e3
    t = cdiv(items, sms) * per_item
    if split > 1:
        t += 2.5 + 0.15 * split + (split + 1) * M * N * taps * 4 / 8e6
    return t


@functools.lru_cache(maxsize=4096)  # a pure function, called once per launch
def plan_gemm(M: int, N: int, K: int, sms: int, dtype, conv_c: int | None = None,
              aligned: bool = True, lda: int | None = None) -> GemmPlan:
    """The plan of one C[M,N] = A[M,K] . B[K,N] launch; ``conv_c`` is the
    conv's input channel count (A gathered from NHWC), None for the GEMM.
    ``aligned``: every operand that the wgmma paths read or write 16 bytes
    at a time starts on a 16-byte boundary (for a conv with C % 8 != 0 that
    is all but x, which its fill reads element by element). ``lda``: the
    GEMM's A row stride in elements (None: K, a dense A). A pure function
    of its arguments.

    * f32 -> the FMA path, 64x64 tiles.
    * bf16 with odd N, a GEMM whose A rows are off 16 bytes (lda % 8 != 0:
      a dense A with K % 8 != 0), a conv with both C % 8 != 0 and N % 8 !=
      0, or a misaligned operand -> the mma.sync loop, 128x128 tiles. A
      GEMM with K % 8 != 0 on rows padded to 16 bytes (fc1000's (tp=2)
      dgrad, K = 500 at lda = 504) takes the wgmma rows below, TMA reading
      the columns past K as zeros.
    * a bf16 conv with C % 8 != 0 (every C = 3 stem) -> ``wgmma_narrow``:
      the wgmma ring with A built element by element, 64-row tiles of 64 or
      128 columns.
    * bf16 with N % 8 != 0 and N even (ssd300's mbox_conf heads at N = 84
      and 126, fc1000's (tp=2) slice at 500) -> ``wgmma_edge``: the wgmma
      ring with B's rows padded to 16 bytes in memory and the output stored
      from the accumulators, masked at the N edge; tiles of 64 or 128 rows
      and columns.
    * other bf16 -> wgmma: the tile (64 or 128 rows; 64, 128 or 256 columns,
      no wider than N needs) and the K split (a divisor of the 64-deep
      chunks, at most 16) that :func:`plan_cost` ranks first among the plans
      whose work items give at least 2/3 of the SMs one each (or, where none
      does, among those with the most items). The grid is persistent:
      min(items, sms) blocks walk the work items. ``wgmma_narrow`` and
      ``wgmma_edge`` take their tiles and split the same way."""
    if dtype == torch.float32:
        return GemmPlan("fma", 64, 64, 1, cdiv(M, 64) * cdiv(N, 64))
    if dtype != torch.bfloat16:
        raise ValueError(f"kernels take float32 or bfloat16, got {dtype}")
    narrow = conv_c is not None and conv_c % 8 != 0
    edge = N % 8 != 0
    if N % 2 or (conv_c is None and (K if lda is None else lda) % 8) or (narrow and edge) \
            or not aligned:
        return GemmPlan("mma", 128, 128, 1, cdiv(M, 128) * cdiv(N, 128))
    chunks = cdiv(K, WGMMA_CHUNK)
    cands = []
    for bm in (64,) if narrow else (128, 64):
        for bn in (128, 64) if narrow or edge else (256, 128, 64):
            if bn > max(64, cdiv(N, 64) * 64):
                continue
            for split in range(1, min(_MAX_SPLIT, chunks) + 1):
                if chunks % split == 0:
                    items = cdiv(M, bm) * cdiv(N, bn) * split
                    cost = plan_cost(M, N, K, sms, bm, bn, split, conv_c is not None)
                    cands.append((min(items, -(-2 * sms // 3)), -cost, bm, bn, split, items))
    busy = max(c[0] for c in cands)
    _, _, bm, bn, split, items = max(c for c in cands if c[0] == busy)
    path = "wgmma_narrow" if narrow else "wgmma_edge" if edge else "wgmma"
    return GemmPlan(path, bm, bn, split, min(items, sms))


def splitk_workspace(plan: GemmPlan, M: int, N: int, dev) -> torch.Tensor | None:
    """The f32 partial sums of a split-K launch (the kernel allocates
    nothing)."""
    if plan.split == 1:
        return None
    return torch.empty((plan.split * M * N,), dtype=torch.float32, device=dev)
