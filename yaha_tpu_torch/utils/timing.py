"""Per-stage timing (Timing.inl analog).

The port's copy of StageTimers from yaha_tpu/utils/timing.py: accumulating
wall-clock stage timers with the reference's percentage report
(Query.c:510-516).
"""
from __future__ import annotations

import contextlib
import time


class StageTimers:
    """Accumulating named timers; print_report mirrors the reference's
    per-phase percentage summary (Query.c:510-516)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self._start = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = (self.totals.get(name, 0.0) +
                                 time.perf_counter() - t0)

    def print_report(self, out=None) -> None:
        import sys
        out = out or sys.stderr
        total = time.perf_counter() - self._start
        for name, secs in self.totals.items():
            pct = 100.0 * secs / total if total > 0 else 0.0
            print("%-42s %8.3fs (%5.1f%%)" % (name + " took:", secs, pct),
                  file=out)
        print("%-42s %8.3fs" % ("total:", total), file=out)
