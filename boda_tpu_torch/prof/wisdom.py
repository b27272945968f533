"""The wisdom store: persisted per-op autotuning results + known-good digests.

Counterpart of ``boda_tpu/prof/wisdom.py`` with the same text format byte for
byte, so either package reads the other's files (the platform tags differ:
``cuda:<card>`` here). Parity target: ``op_wisdom_t`` / ``op_tune_wisdom_t``
(ref src/op-tuner.H:37, :21; stream format op-tuner.cc:103-126): for every
op signature, a mergeable database of (tune, platform tag) -> runtime plus
embedded known-good output digests that anchor correctness across
machines/backends.

Text format (one record per line inside an ``op``..``end`` block)::

    boda_tpu wisdom v1
    op (type=sgemm,a=(M=512,K=512),...)
    kgd c (dims=(M=512,N=512),sum=...,sha256=...)
    run (bm=512,bk=512) tpu:TPU_v5_lite 0.00123
    end
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ops.op_base import Op
from ..utils.digest import NdaDigest


@dataclass
class OpRun:
    tune: str          # OpTune.key()
    plat: str          # backend plat tag
    secs: float
    # how the runtime was measured — the trust tier of the record:
    #   'ab'    paired A/B vs the incumbent (prof/abtime.ab_compare: both
    #           variants timed in turns in one process)
    #   'chain' standalone timing (backends time_func)
    #   ''      legacy/pre-tag record (assume 'chain')
    method: str = ""

    def line(self) -> str:
        tail = f" m={self.method}" if self.method else ""
        return f"run {self.tune} {self.plat} {self.secs!r}{tail}"


@dataclass
class OpWisdom:
    op: Op
    kg_digests: dict[str, NdaDigest] = field(default_factory=dict)
    runs: list[OpRun] = field(default_factory=list)

    def best(self, plat: str | None = None) -> OpRun | None:
        """Fastest run for plat, trusting tiers: ab-tier records (paired
        A/B) outrank chain/legacy ones regardless of their secs — an
        unpaired reading must not win the ranking over a paired one
        (boda_tpu measured ~2x jitter between unpaired TPU readings)."""
        cands = [r for r in self.runs if plat is None or r.plat == plat]
        ab = [r for r in cands if r.method == "ab"]
        if ab:
            cands = ab
        return min(cands, key=lambda r: r.secs) if cands else None

    def merge_from(self, o: "OpWisdom") -> None:
        assert o.op == self.op
        for k, d in o.kg_digests.items():
            mine = self.kg_digests.get(k)
            if mine is None:
                self.kg_digests[k] = d
            elif not mine.exact_eq(d) and mine.mrd_comp(d) > 1e-4:
                raise ValueError(f"wisdom merge: conflicting known-good digest "
                                 f"for {self.op.key()} out {k!r}")
        seen = {(r.tune, r.plat): i for i, r in enumerate(self.runs)}

        def tier(r: OpRun) -> int:  # 'ab' outranks 'chain'/legacy: a faster
            # reading from the jittery tier must not displace an A/B one
            return 1 if r.method == "ab" else 0
        for r in o.runs:
            i = seen.get((r.tune, r.plat))
            if i is None:
                seen[(r.tune, r.plat)] = len(self.runs)
                self.runs.append(r)
            elif (tier(r), -r.secs) > (tier(self.runs[i]), -self.runs[i].secs):
                self.runs[i] = r


_HEADER = "boda_tpu wisdom v1"


def _toolchain_tag() -> str:
    """One-line toolchain stamp (VERDICT r2 item 8): per-op runtimes are only
    comparable within one compiler generation, so persisted wisdom carries
    the torch and CUDA versions it was measured under."""
    import torch
    return f"# toolchain torch={torch.__version__} cuda={torch.version.cuda}"


def write_wisdom(fn: str, wis: list[OpWisdom]) -> None:
    with open(fn, "w") as f:
        f.write(_HEADER + "\n")
        f.write(_toolchain_tag() + "\n")
        for w in wis:
            f.write(f"op {w.op.key()}\n")
            for name in sorted(w.kg_digests):
                f.write(f"kgd {name} {w.kg_digests[name].to_lexp_str()}\n")
            for r in w.runs:
                f.write(r.line() + "\n")
            f.write("end\n")


def read_wisdom(fn: str) -> list[OpWisdom]:
    out: list[OpWisdom] = []
    cur: OpWisdom | None = None
    with open(fn) as f:
        header = f.readline().rstrip("\n")
        if header != _HEADER:
            raise ValueError(f"{fn}: bad wisdom header {header!r}")
        for ln, line in enumerate(f, start=2):
            line = line.rstrip("\n")
            if not line or line.startswith("#"):  # comment/toolchain tags
                continue
            kind, _, rest = line.partition(" ")
            if kind == "op":
                if cur is not None:
                    raise ValueError(f"{fn}:{ln}: nested op record")
                cur = OpWisdom(Op.parse(rest))
            elif kind == "kgd":
                name, _, dstr = rest.partition(" ")
                assert cur is not None, f"{fn}:{ln}: kgd outside op block"
                cur.kg_digests[name] = NdaDigest.from_lexp_str(dstr)
            elif kind == "run":
                method = ""
                if rest.rsplit(" ", 1)[-1].startswith("m="):
                    rest, mtok = rest.rsplit(" ", 1)
                    method = mtok[2:]
                tune, plat, secs = rest.rsplit(" ", 2)
                assert cur is not None, f"{fn}:{ln}: run outside op block"
                cur.runs.append(OpRun(tune, plat, float(secs), method))
            elif kind == "end":
                assert cur is not None
                out.append(cur)
                cur = None
            else:
                raise ValueError(f"{fn}:{ln}: unknown wisdom record {kind!r}")
    if cur is not None:
        raise ValueError(f"{fn}: truncated wisdom (missing end)")
    return out


def merge_wisdom(srcs: list[list[OpWisdom]]) -> list[OpWisdom]:
    by_op: dict[str, OpWisdom] = {}
    order: list[str] = []
    for ws in srcs:
        for w in ws:
            k = w.op.key()
            if k not in by_op:
                by_op[k] = OpWisdom(w.op)
                order.append(k)
            by_op[k].merge_from(w)
    return [by_op[k] for k in order]
