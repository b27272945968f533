"""Tensor digests and full-tensor numeric comparison.

Counterpart of ``boda_tpu/utils/digest.py``, copied: it is pure numpy, on
the port's ``Dims`` and lexp. The stream format is the same byte for byte
(header ``boda_tpu digest stream v1``, one ``name digest-lexp`` line per
entry), so a stream written by either package loads in the other.

Parity targets:
  * ``nda_digest_t`` (ref src/boda_base.H:1058) — compact, storable summary of
    a tensor used as a known-good anchor in regression tests, with an
    MRD-tolerance comparison (``mrd_comp``).
  * ``comp_vars`` (ref src/comp_util.{H,cc}) — full-tensor diff producing
    sum-of-squared-diff stats and MRD (max relative difference), gated by a
    per-layer tolerance.

Digest contents: shape/dtype, elementwise stats (sum/sum_sq/min/max computed in
float64), a deterministic strided sample of values, and a sha256 of the raw
bytes (for exact self-comparison). Digests serialize to a single lexp line so
they can live in text digest streams.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np

from .dims import Dims
from .lexp import Lexp, parse_lexp

_N_SAMPLES = 64


@dataclass
class NdaDigest:
    dims: Dims
    sum: float
    sum_sq: float
    vmin: float
    vmax: float
    samples: np.ndarray  # float64, deterministic strided sample
    sha256: str

    @staticmethod
    def make(arr: np.ndarray, dims: Dims | None = None,
             tn: str | None = None) -> "NdaDigest":
        """``tn="bfloat16"`` digests a bf16 tensor held on the host as f32
        (numpy has no bf16) as boda_tpu digests the bf16 array itself: its
        dims name bfloat16 and the sha256 is of the 2-byte values."""
        a = np.ascontiguousarray(arr)
        raw = (a.view(np.uint32) >> 16).astype("<u2") \
            if tn == "bfloat16" and a.dtype == np.float32 else a  # exact: bf16 values
        if dims is None:
            dims = Dims.make([f"d{i}" for i in range(arr.ndim)], arr.shape,
                             tn or arr.dtype.name)
        flat = a.reshape(-1)
        f64 = flat.astype(np.float64)
        n = flat.size
        if n == 0:
            samples = np.zeros(0)
        else:
            idx = np.linspace(0, n - 1, num=min(_N_SAMPLES, n), dtype=np.int64)
            samples = f64[idx]
        return NdaDigest(
            dims=dims,
            sum=float(f64.sum()),
            sum_sq=float((f64 * f64).sum()),
            vmin=float(f64.min()) if n else 0.0,
            vmax=float(f64.max()) if n else 0.0,
            samples=samples,
            sha256=hashlib.sha256(raw.tobytes()).hexdigest(),
        )

    # -- comparison ----------------------------------------------------------
    def exact_eq(self, o: "NdaDigest") -> bool:
        return self.sha256 == o.sha256 and self.dims.matches(o.dims)

    def mrd_comp(self, o: "NdaDigest") -> float:
        """Approximate max-relative-difference between two digests (via stats+samples)."""
        if self.dims.shape != o.dims.shape:
            return float("inf")
        vals_a = np.concatenate([[self.sum, self.sum_sq, self.vmin, self.vmax], self.samples])
        vals_b = np.concatenate([[o.sum, o.sum_sq, o.vmin, o.vmax], o.samples])
        return float(np.max(rel_diff(vals_a, vals_b))) if vals_a.size else 0.0

    # -- text serialization ----------------------------------------------------
    def to_lexp_str(self) -> str:
        samp = ":".join(repr(float(s)) for s in self.samples)
        l = Lexp(kids=[])
        l.add("dims", str(self.dims))
        l.add("sum", repr(self.sum))
        l.add("sum_sq", repr(self.sum_sq))
        l.add("min", repr(self.vmin))
        l.add("max", repr(self.vmax))
        l.add("samples", samp)
        l.add("sha256", self.sha256)
        return str(l)

    @staticmethod
    def from_lexp_str(s: str) -> "NdaDigest":
        l = parse_lexp(s)
        g = {k: v.leaf_val for k, v in l.kids}
        samples = np.array([float(x) for x in g["samples"].split(":")] if g["samples"] else [])
        return NdaDigest(
            dims=Dims.parse(g["dims"]),
            sum=float(g["sum"]), sum_sq=float(g["sum_sq"]),
            vmin=float(g["min"]), vmax=float(g["max"]),
            samples=samples, sha256=g["sha256"],
        )


def rel_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise relative difference: |a-b| / max(|a|,|b|), 0 where both are 0."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    denom = np.maximum(np.abs(a), np.abs(b))
    with np.errstate(divide="ignore", invalid="ignore"):
        rd = np.abs(a - b) / denom
    return np.where(denom == 0.0, 0.0, rd)


@dataclass
class CompResult:
    mrd: float            # max relative difference
    mad: float            # max absolute difference
    num_diff: int         # elements whose rel diff exceeded the tolerance
    ssd: float            # sum of squared differences
    n: int

    def ok(self) -> bool:
        return self.num_diff == 0

    def __str__(self) -> str:
        return (f"mrd={self.mrd:.3g} mad={self.mad:.3g} ssd={self.ssd:.3g} "
                f"num_diff={self.num_diff}/{self.n}")


def comp_vars(a: np.ndarray, b: np.ndarray, mrd_toler: float = 5e-4,
              atol: float = 0.0) -> CompResult:
    """Full-tensor comparison (ref comp_util.H:13 semantics).

    An element counts as different when |a-b| > atol + mrd_toler*max(|a|,|b|);
    atol guards near-zero elements whose relative error is accumulation-order
    noise. atol=0 keeps the strict pure-relative gate.
    """
    if a.shape != b.shape:
        raise ValueError(f"comp_vars: shape mismatch {a.shape} vs {b.shape}")
    a64 = np.asarray(a, dtype=np.float64)
    b64 = np.asarray(b, dtype=np.float64)
    ad = np.abs(a64 - b64)
    rd = rel_diff(a64, b64)
    denom = np.maximum(np.abs(a64), np.abs(b64))
    eff = np.where(ad > atol + mrd_toler * denom, np.inf, 0.0)
    return CompResult(
        mrd=float(rd.max()) if rd.size else 0.0,
        mad=float(ad.max()) if ad.size else 0.0,
        num_diff=int((eff > mrd_toler).sum()),
        ssd=float((ad * ad).sum()),
        n=int(a64.size),
    )


class DigestStream:
    """Ordered (name, digest) stream, persisted as text lines ``name digest-lexp``.

    Plays the role of the reference's ``digest-caffe.boda`` known-good streams
    (ref src/test_compute.cc:268): regression runs compare live digests against
    a stored stream anchored to the oracle backend.
    """

    def __init__(self, entries: list[tuple[str, NdaDigest]] | None = None):
        self.entries: list[tuple[str, NdaDigest]] = entries or []

    def add(self, name: str, arr: np.ndarray, dims: Dims | None = None) -> None:
        self.entries.append((name, NdaDigest.make(arr, dims)))

    def save(self, fn: str) -> None:
        with open(fn, "w") as f:
            f.write("boda_tpu digest stream v1\n")
            for name, d in self.entries:
                f.write(f"{name} {d.to_lexp_str()}\n")

    @staticmethod
    def load(fn: str) -> "DigestStream":
        out = DigestStream()
        with open(fn) as f:
            header = f.readline()
            if not header.startswith("boda_tpu digest stream"):
                raise ValueError(f"{fn}: not a digest stream file")
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                name, rest = line.split(" ", 1)
                out.entries.append((name, NdaDigest.from_lexp_str(rest)))
        return out

    def as_dict(self) -> dict[str, NdaDigest]:
        return dict(self.entries)
