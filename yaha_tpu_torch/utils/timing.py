"""The port's span recorder and the --trace profiler.

RECORDER is one process-wide recorder of spans: a span is a named stretch
of one thread's time, opened with `RECORDER.span(name, **counts)` as a
context manager.  A thread-local stack gives each span its parent (the
innermost span open on the same thread) and its batch id (the parent's,
unless given: the CLI loop's `align` span carries the batch's sequence
number, and every span under it inherits it).  Counts ride on the span:
given at opening, added by `span.add(...)` or, from code that does not
hold it, by `RECORDER.count(...)` on the innermost open span.

The recorder records while it is enabled (`enable()`: --trace DIR, the
tools) and while a torch.profiler profile is open in the process (the
benchmark's traced window), so that its spans exist where a trace can
place them.  Then each span is a tuple appended in memory: (id, name,
batch, parent id, native thread id, start ns, end ns, counts), start
and end on time.perf_counter_ns.  It keeps the spans of its latest
recording: the first span after it was found off starts a new one.  When
it is off, `span()` returns one shared do-nothing object: nothing is
recorded or allocated.

The always-on sums of the program (StagedAligner.stats, DeviceSeeder.stats,
the -v report) need their clock reads whether or not spans are recorded.
`t0 = sp.start()` and `seconds = sp.stop(t0)` give them those reads, on
perf_counter_ns; when the recorder is on, the same reads are the span's
start and end, so a sum and the spans of one batch agree to the
nanosecond.  `sp.lap(t0)` reads the seconds without ending the span.

A recording starts with one anchor pair (perf_counter_ns, time_ns),
which places its spans on a torch.profiler Chrome trace's clock
(`chrome_events`): a trace's CPU event at `ts` (us) happened at
ts * 1000 + baseTimeNanoseconds on time_ns.  device_trace writes them
into its trace file beside the profiler's own events.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time

_perf_ns = time.perf_counter_ns


def _profiler_open():
    """True while a torch.profiler (or autograd profiler) profile is open
    in this process, on any thread; False where torch is not imported."""
    mod = sys.modules.get("torch.autograd.profiler")
    return mod is not None and getattr(mod, "_is_profiler_enabled", False)


class _Off:
    """The span of a recorder that is off: no state, no record."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def start():
        return _perf_ns()

    @staticmethod
    def stop(t0):
        return (_perf_ns() - t0) * 1e-9

    lap = stop

    def add(self, **counts):
        pass


OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "batch", "counts", "id", "parent", "t0",
                 "t1")

    def __init__(self, rec, name, batch, counts):
        self.rec = rec
        self.name = name
        self.batch = batch
        self.counts = counts
        self.t1 = 0

    def __enter__(self):
        stack = self.rec._stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else 0
        if self.batch is None and up is not None:
            self.batch = up.batch
        self.id = next(self.rec._ids)
        stack.append(self)
        self.t0 = _perf_ns()
        return self

    def start(self):
        """Moves the span's start here; returns it (perf_counter ns)."""
        self.t0 = _perf_ns()
        return self.t0

    def stop(self, t0):
        """Ends the span here; returns the seconds since `t0`."""
        self.t1 = _perf_ns()
        return (self.t1 - t0) * 1e-9

    @staticmethod
    def lap(t0):
        """The seconds since `t0`; the span goes on."""
        return (_perf_ns() - t0) * 1e-9

    def add(self, **counts):
        c = self.counts
        for k, v in counts.items():
            c[k] = c.get(k, 0) + v

    def __exit__(self, *exc):
        t1 = self.t1 or _perf_ns()
        rec = self.rec
        rec._stack().pop()
        tid = threading.get_native_id()
        if tid not in rec.threads:
            rec.threads[tid] = threading.current_thread().name
        rec._spans.append((self.id, self.name, self.batch, self.parent, tid,
                           self.t0, t1, self.counts))
        return False


class Recorder:
    """Spans of the port's layers (the module docstring)."""

    def __init__(self):
        self._enabled = False
        self._on = False
        self._lock = threading.Lock()
        self._spans = []
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self.threads = {}
        self.anchor = None

    def _stack(self):
        try:
            return self._tls.stack
        except AttributeError:
            self._tls.stack = []
            return self._tls.stack

    def _begin(self):
        """A new recording: no spans yet, a new clock anchor."""
        with self._lock:
            if not self._on:
                self.clear()
                self.anchor = (_perf_ns(), time.time_ns())
                self._on = True

    def enable(self):
        """Starts a recording that lasts until disable()."""
        self._on = False
        self._begin()
        self._enabled = True

    def disable(self):
        self._enabled = False

    def recording(self) -> bool:
        """Whether spans opened now are recorded."""
        if self._enabled or _profiler_open():
            if not self._on:
                self._begin()
            return True
        self._on = False
        return False

    def span(self, name, batch=None, **counts):
        """A context manager: the span `name` on this thread (the module
        docstring); OFF when the recorder is off."""
        if not self.recording():
            return OFF
        return _Span(self, name, batch, counts)

    def count(self, **counts):
        """Adds `counts` to the innermost span open on this thread."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            stack[-1].add(**counts)

    def spans(self):
        """The spans recorded so far, in the order they ended."""
        return list(self._spans)

    def clear(self):
        self._spans = []
        self.threads = {}

    def chrome_events(self, base_ns: int) -> list:
        """The spans as Chrome trace "X" events on a torch.profiler trace
        whose baseTimeNanoseconds is `base_ns`: one tid a thread (the
        profiler's own, the native thread id), batch, id, parent and
        counts in args."""
        if self.anchor is None:
            return []
        pc0, unix0 = self.anchor
        pid = os.getpid()
        out = []
        for sid, name, batch, parent, tid, t0, t1, counts in self._spans:
            args = {"id": sid, "parent": parent}
            if batch is not None:
                args["batch"] = batch
            args.update(counts)
            out.append({"ph": "X", "cat": "yaha", "name": name, "pid": pid,
                        "tid": tid,
                        "ts": (unix0 + (t0 - pc0) - base_ns) / 1000.0,
                        "dur": (t1 - t0) / 1000.0, "args": args})
        for tid, tname in self.threads.items():
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": tname}})
        return out


RECORDER = Recorder()


def span(name, batch=None, **counts):
    """RECORDER.span."""
    return RECORDER.span(name, batch, **counts)


@contextlib.contextmanager
def device_trace(log_dir, device=None):
    """torch.profiler trace of the block: the CPU ops of every thread
    (of the calling thread only where this PyTorch lacks the profiler's
    profile_all_threads option), and with a CUDA `device` the card's
    kernels and copies from every thread; with the recorder enabled for
    the block.  On exit the trace, the recorder's spans among its events,
    is written to log_dir as a Chrome trace (yaha_trace_<pid>.json).  Does
    nothing when log_dir is None."""
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
    path = os.path.join(log_dir, "yaha_trace_%d.json" % os.getpid())
    RECORDER.enable()
    try:
        with profile(activities=acts, **kw) as prof:
            yield
    finally:
        RECORDER.disable()
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"] += RECORDER.chrome_events(
        int(trace.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(trace, f)
