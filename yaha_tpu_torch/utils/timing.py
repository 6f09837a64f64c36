"""Per-stage timing (Timing.inl analog) and the --trace profiler.

The port's copy of StageTimers from yaha_tpu/utils/timing.py: accumulating
wall-clock stage timers with the reference's percentage report
(Query.c:510-516); and device_trace, the counterpart of that module's
jax.profiler wrapper (timing.py:43) in torch.profiler.
"""
from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """torch.profiler trace of the block: the CPU ops of every thread
    (of the calling thread only where this PyTorch lacks the profiler's
    profile_all_threads option), and with a CUDA `device` the card's
    kernels and copies from every thread; on exit written to log_dir as
    a Chrome trace (yaha_trace_<pid>.json).  Does nothing when log_dir is
    None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts, **kw) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, "yaha_trace_%d.json" % os.getpid()))
