"""Named-dimension ND-array shapes and host arrays.

Counterpart of ``boda_tpu/utils/dims.py``: every tensor flowing through the
framework carries *named* dimensions ("img", "chan", "y", "x", ...) plus a
dtype name. Port difference: ``bfloat16`` maps to ``torch.bfloat16`` (not
``ml_dtypes``). numpy has no bfloat16, so a bf16 node's *host* array (an
NDA's numpy storage) is float32; the device tensor is bf16.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch

_TORCH_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int32": torch.int32,
    "uint32": torch.uint32,
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "uint16": torch.uint16,
    "int64": torch.int64,
    "uint64": torch.uint64,
    "bool": torch.bool,
}


def stable_hash(s: str) -> int:
    """Deterministic 32-bit string hash (python's hash() is salted per-run)."""
    return zlib.crc32(s.encode())


def torch_dtype(tn: str) -> torch.dtype:
    d = _TORCH_DTYPES.get(tn)
    if d is None:
        raise ValueError(f"unknown dims_t type name {tn!r}")
    return d


def np_dtype(tn: str) -> np.dtype:
    """Host (numpy) storage dtype of a dims type name; bfloat16 is held as
    float32 on the host."""
    if tn == "bfloat16":
        return np.dtype(np.float32)
    torch_dtype(tn)  # validates the name
    return np.dtype(tn)


@dataclass(frozen=True)
class Dims:
    """Ordered named dims + dtype name. Immutable and hashable.

    ``Dims(img=8, chan=64, y=56, x=56)`` or ``Dims.make(("M","N"),(512,512))``.
    """

    names: tuple[str, ...]
    sizes: tuple[int, ...]
    tn: str = "float32"

    # -- constructors --------------------------------------------------------
    @staticmethod
    def make(names: Iterable[str], sizes: Iterable[int], tn: str = "float32") -> "Dims":
        names = tuple(names)
        sizes = tuple(int(s) for s in sizes)
        if len(names) != len(sizes):
            raise ValueError(f"Dims: {len(names)} names vs {len(sizes)} sizes")
        if len(set(names)) != len(names):
            raise ValueError(f"Dims: duplicate dim names in {names}")
        return Dims(names, sizes, tn)

    @staticmethod
    def of(tn: str = "float32", **kw: int) -> "Dims":
        return Dims.make(kw.keys(), kw.values(), tn)

    @staticmethod
    def parse(s: str) -> "Dims":
        """Parse the lexp surface form ``(img=8,chan=64,y=56,x=56,__tn__=float32)``."""
        from .lexp import parse_lexp
        l = parse_lexp(s)
        names, sizes, tn = [], [], "float32"
        for k, v in l.kids:
            if k == "__tn__":
                tn = v.leaf_val
            else:
                names.append(k)
                sizes.append(int(v.leaf_val))
        return Dims.make(names, sizes, tn)

    # -- access ---------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.names)

    def __contains__(self, name: str) -> bool:
        return name in self.names

    def size(self, name: str) -> int:
        try:
            return self.sizes[self.names.index(name)]
        except ValueError:
            raise KeyError(f"no dim named {name!r} in {self}") from None

    def index(self, name: str) -> int:
        return self.names.index(name)

    def __getitem__(self, key) -> int:
        if isinstance(key, str):
            return self.size(key)
        return self.sizes[key]

    @property
    def shape(self) -> tuple[int, ...]:
        return self.sizes

    def num_elems(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    def bytes_sz(self) -> int:
        """Bytes of the device tensor (bf16 counts 2 bytes)."""
        return self.num_elems() * torch_dtype(self.tn).itemsize

    def with_tn(self, tn: str) -> "Dims":
        return Dims(self.names, self.sizes, tn)

    def with_size(self, name: str, size: int) -> "Dims":
        i = self.index(name)
        return Dims(self.names, self.sizes[:i] + (int(size),) + self.sizes[i + 1:], self.tn)

    def drop(self, *names: str) -> "Dims":
        keep = [(n, s) for n, s in zip(self.names, self.sizes) if n not in names]
        return Dims.make((n for n, _ in keep), (s for _, s in keep), self.tn)

    def matches(self, o: "Dims", check_names: bool = True, check_tn: bool = True) -> bool:
        if self.sizes != o.sizes:
            return False
        if check_names and self.names != o.names:
            return False
        if check_tn and self.tn != o.tn:
            return False
        return True

    def __str__(self) -> str:
        body = ",".join(f"{n}={s}" for n, s in zip(self.names, self.sizes))
        tn = f",__tn__={self.tn}" if self.tn != "float32" else ""
        return f"({body}{tn})"


class NDA:
    """A host ND-array with named dims: numpy storage + a Dims."""

    __slots__ = ("dims", "data")

    def __init__(self, dims: Dims, data: Optional[np.ndarray] = None):
        self.dims = dims
        if data is None:
            data = np.zeros(dims.shape, dtype=np_dtype(dims.tn))
        else:
            data = np.asarray(data, dtype=np_dtype(dims.tn))
            if tuple(data.shape) != dims.shape:
                if data.size == dims.num_elems():
                    data = data.reshape(dims.shape)
                else:
                    raise ValueError(f"NDA: data shape {data.shape} != dims {dims}")
        self.data = data

    def __repr__(self) -> str:
        return f"NDA({self.dims}, mean={float(np.mean(self.data.astype(np.float64))):.6g})"
