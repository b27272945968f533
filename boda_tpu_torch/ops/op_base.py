"""Canonical operation signatures.

A copy of ``boda_tpu/ops/op_base.py`` (pure Python, on the port's ``Dims``
and lexp), so a signature corpus or wisdom file keys the same in both
packages. Parity target: ``op_base_t`` (ref src/op_base.H:9) — an op signature is a type
string plus a map of string params plus a map of named-dims params, with a
total order so signatures can key kernel caches, wisdom files, and test
corpora. Surface form is a lexp line, e.g.::

    (type=sgemm,a=(M=512,K=256),b=(K=256,N=128),c=(M=512,N=128))
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..utils.dims import Dims
from ..utils.lexp import Lexp, parse_lexp


@dataclass
class Op:
    type: str
    str_vals: dict[str, str] = field(default_factory=dict)
    dims_vals: dict[str, Dims] = field(default_factory=dict)

    # -- accessors -------------------------------------------------------------
    def dims(self, name: str) -> Dims:
        try:
            return self.dims_vals[name]
        except KeyError:
            raise KeyError(f"op {self.type}: no dims arg {name!r}; "
                           f"have {sorted(self.dims_vals)}") from None

    def sval(self, name: str, default: str | None = None) -> str:
        if name in self.str_vals:
            return self.str_vals[name]
        if default is not None:
            return default
        raise KeyError(f"op {self.type}: no str val {name!r}")

    def ival(self, name: str, default: int | None = None) -> int:
        if name in self.str_vals:
            return int(self.str_vals[name])
        if default is not None:
            return default
        raise KeyError(f"op {self.type}: no int val {name!r}")

    def fval(self, name: str, default: float | None = None) -> float:
        if name in self.str_vals:
            return float(self.str_vals[name])
        if default is not None:
            return default
        raise KeyError(f"op {self.type}: no float val {name!r}")

    def has(self, name: str) -> bool:
        return name in self.str_vals or name in self.dims_vals

    # -- canonical form ---------------------------------------------------------
    def key(self) -> str:
        """Deterministic canonical string: sorted keys; keys caches/wisdom."""
        parts = [f"type={self.type}"]
        for k in sorted(self.str_vals):
            parts.append(f"{k}={Lexp(leaf_val=self.str_vals[k])}")
        for k in sorted(self.dims_vals):
            parts.append(f"{k}={self.dims_vals[k]}")
        return "(" + ",".join(parts) + ")"

    def __str__(self) -> str:
        return self.key()

    def __hash__(self) -> int:
        return hash(self.key())

    def __eq__(self, o) -> bool:
        return isinstance(o, Op) and self.key() == o.key()

    def copy(self) -> "Op":
        return Op(self.type, dict(self.str_vals), dict(self.dims_vals))

    # -- parsing ------------------------------------------------------------------
    @staticmethod
    def parse(s: str) -> "Op":
        l = parse_lexp(s)
        if l.is_leaf:
            raise ValueError(f"op signature must be a list lexp, got leaf {s!r}")
        typ = None
        sv: dict[str, str] = {}
        dv: dict[str, Dims] = {}
        for k, v in l.kids:
            if k == "type":
                typ = v.leaf_val
            elif v.is_leaf:
                sv[k] = v.leaf_val
            else:
                dv[k] = Dims.parse(str(v))
        if typ is None:
            raise ValueError(f"op signature missing type= in {s!r}")
        return Op(typ, sv, dv)


def load_op_sigs(fn: str) -> list[Op]:
    """Read an op-signature corpus: one op lexp per line, '#' comments."""
    out = []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            out.append(Op.parse(line))
    return out


def save_op_sigs(fn: str, ops: list[Op]) -> None:
    with open(fn, "w") as f:
        for op in ops:
            f.write(op.key() + "\n")
