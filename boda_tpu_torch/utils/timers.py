"""Nestable wall timers with a global aggregated log.

A copy of ``boda_tpu/utils/timers.py`` (pure Python). Parity target:
reference ``src/timers.{H,cc}`` — RAII timer scopes aggregated into a
count/total/avg table printed at process exit. Here: context managers + an
explicit ``timer_log_str()``/``timer_log_finalize()``.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class _Agg:
    cnt: int = 0
    tot: float = 0.0

    @property
    def avg(self) -> float:
        return self.tot / self.cnt if self.cnt else 0.0


@dataclass
class TimerLog:
    aggs: "OrderedDict[str, _Agg]" = field(default_factory=OrderedDict)

    @contextmanager
    def scope(self, tag: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            a = self.aggs.setdefault(tag, _Agg())
            a.cnt += 1
            a.tot += dt

    def add(self, tag: str, secs: float, cnt: int = 1) -> None:
        a = self.aggs.setdefault(tag, _Agg())
        a.cnt += cnt
        a.tot += secs

    def table_str(self) -> str:
        if not self.aggs:
            return "TIMERS: (none)\n"
        rows = ["TIMERS:  CNT     TOT_DUR      AVG_DUR    TAG"]
        for tag, a in sorted(self.aggs.items(), key=lambda kv: -kv[1].tot):
            rows.append(f"      {a.cnt:6d} {fmt_secs(a.tot):>11s} {fmt_secs(a.avg):>12s}    {tag}")
        return "\n".join(rows) + "\n"

    def reset(self) -> None:
        self.aggs.clear()


def fmt_secs(s: float) -> str:
    if s >= 1.0:
        return f"{s:.3f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.3f}ms"
    return f"{s * 1e6:.1f}us"


GLOBAL_TIMER_LOG = TimerLog()


def timer(tag: str):
    """Context manager recording into the global timer log."""
    return GLOBAL_TIMER_LOG.scope(tag)


def timer_log_str() -> str:
    return GLOBAL_TIMER_LOG.table_str()


def timer_log_finalize(print_fn=print) -> None:
    if GLOBAL_TIMER_LOG.aggs:
        print_fn(GLOBAL_TIMER_LOG.table_str(), end="")
    GLOBAL_TIMER_LOG.reset()
