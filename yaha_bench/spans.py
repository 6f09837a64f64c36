"""The program's own spans in the traced window: the stall, and the
card's idle time by the spans open across it.

The port records spans (yaha_tpu_torch.utils.timing.RECORDER) while a
torch.profiler profile is open in its process, so the traced run's window
leaves one recording of them, tuples (id, name, batch, parent id, thread
id, start ns, end ns, counts) on perf_counter_ns, the harness's own clock.
A program without the recorder leaves none, and every function here that
reads them gives None.

The harness's traced run prints, on standard error, the idle-by-span
table: for each stretch of the window in which the card ran nothing, the
innermost program span open on each thread, summed by combination, the
top 10 by seconds, and the share of the idle seconds that some program
span covers and the share under a worker's phase span (a span below
`align`).
"""
from __future__ import annotations

import re
import sys

TOP = 10
ALIGN = "align"


def program_spans(ctx=None):
    """The recorded spans of the window: ctx["program_spans"] where the
    harness hands them over, else the port's recorder's; None where the
    program has no recorder or recorded nothing."""
    if ctx is not None and ctx.get("program_spans") is not None:
        return ctx["program_spans"] or None
    timing = sys.modules.get("yaha_tpu_torch.utils.timing")
    rec = getattr(timing, "RECORDER", None)
    if rec is None:
        return None
    return rec.spans() or None


def thread_names() -> dict:
    """{thread id: name} of the recorder's threads ({} when unknown)."""
    timing = sys.modules.get("yaha_tpu_torch.utils.timing")
    rec = getattr(timing, "RECORDER", None)
    return dict(getattr(rec, "threads", {}) or {})


def total_s(spans, name) -> float | None:
    """Seconds of the spans called `name`, summed over threads; None when
    there is none."""
    ds = [t1 - t0 for _, n, _, _, _, t0, t1, _ in spans if n == name]
    return sum(ds) * 1e-9 if ds else None


def union_s(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def stall_s(spans, window_s) -> float | None:
    """Window seconds during which no `align` span is open on any thread:
    the CLI loop has no batch in the aligner (reading, parsing, waiting on
    the writer).  Every span of the recording lies in the window."""
    aligns = [(t0, t1) for _, n, _, _, _, t0, t1, _ in spans if n == ALIGN]
    if not aligns:
        return None
    return max(0.0, window_s - union_s(aligns) * 1e-9)


def thread_role(name: str) -> str:
    """A thread's part in the CLI loop, from its name: the loop's own
    thread, the writer, or an aligner worker of the prefetch."""
    if name == "MainThread":
        return "main"
    if "_writer" in name:
        return "writer"
    if "ThreadPoolExecutor" in name:
        return "worker"
    return re.sub(r"\d+", "", name) or "thread"


def idle_by_span(idle, spans, roles):
    """Idle stretches [(a, b)] (any clock) attributed to the program's
    spans [(tid, name, a, b)] on the same clock: for each piece of idle
    time, the innermost span open on each thread (spans of one thread
    nest), as a sorted tuple of "role:name".  Returns ({combination:
    seconds-of-the-clock}, covered, total); the empty tuple is idle time
    with no span open."""
    # At one instant, ends before starts, and the longer (outer) of two
    # spans that start together first.
    events = []
    for k, (tid, name, a, b) in enumerate(spans):
        if b > a:
            events.append((a, 1, -b, k))
            events.append((b, 0, 0, k))
    events.sort()
    idle = sorted((a, b) for a, b in idle if b > a)
    open_by = {}
    out = {}
    j = 0
    for i, (t, kind, _, k) in enumerate(events):
        tid = spans[k][0]
        st = open_by.setdefault(tid, [])
        if kind:
            st.append(k)
        elif k in st:
            st.remove(k)
        t_next = events[i + 1][0] if i + 1 < len(events) else None
        if t_next is None or t_next <= t:
            continue
        while j < len(idle) and idle[j][1] <= t:
            j += 1
        combo = None
        q = j
        while q < len(idle) and idle[q][0] < t_next:
            a, b = max(idle[q][0], t), min(idle[q][1], t_next)
            if b > a:
                if combo is None:
                    combo = tuple(sorted(
                        "%s:%s" % (roles.get(d, "thread"), spans[s[-1]][1])
                        for d, s in open_by.items() if s))
                out[combo] = out.get(combo, 0.0) + (b - a)
            q += 1
    total = sum(b - a for a, b in idle)
    covered_in = sum(v for c, v in out.items() if c)
    # idle time outside every span's extent (before the first event or
    # after the last) is uncovered
    out[()] = out.get((), 0.0) + max(0.0, total - sum(out.values()))
    return out, covered_in, total


def idle_table(trace_path, spans, threads, t_window0):
    """The idle-by-span table of a traced run: the device's idle
    stretches in the window of the Chrome trace at `trace_path`
    (trace.py's window and device operations), the spans placed on the
    trace's clock by the window's start as the harness places its own.
    Returns {"rows": [[combination, seconds]], "idle_s", "covered_pct"}."""
    import json

    from yaha_bench.trace import DEVICE_CATS, _union
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    mark = next(e for e in events if e.get("name") == "bench.window"
                and "dur" in e)
    w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    busy = _union([(max(float(e["ts"]), w0),
                    min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in events if e.get("cat") in DEVICE_CATS
                   and "dur" in e])
    busy = [(a, b) for a, b in busy if b > a]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]

    def us(t_ns):
        return (t_ns * 1e-9 - t_window0) * 1e6 + w0
    placed = [(tid, name, us(t0), us(t1))
              for _, name, _, _, tid, t0, t1, _ in spans]
    roles = {tid: thread_role(n) for tid, n in threads.items()}
    combos, covered, total = idle_by_span(idle, placed, roles)
    rows = sorted(((" + ".join(c) if c else "(no program span)", v / 1e6)
                   for c, v in combos.items()), key=lambda r: -r[1])
    phase = sum(v for c, v in combos.items() if phase_open(c))
    return {"rows": [list(r) for r in rows[:TOP]], "idle_s": total / 1e6,
            "covered_pct": 100.0 * covered / total if total > 0 else 0.0,
            "phase_pct": 100.0 * phase / total if total > 0 else 0.0}


def phase_open(combo) -> bool:
    """Whether a combination has a worker inside a named phase: a span
    below `align` (the main thread's stream.wait covers any batch in
    flight, so it says nothing of where the time goes)."""
    return any(x.startswith("worker:") and x != "worker:" + ALIGN
               for x in combo)


def print_table(table, out=sys.stderr):
    print("idle by span: %.3f s of device idle time in the window, %.2f %% "
          "of it under a program span, %.2f %% under a worker's phase span "
          "(below align)" % (table["idle_s"], table["covered_pct"],
                             table["phase_pct"]), file=out)
    for combo, secs in table["rows"]:
        print("  %10.3f s  %s" % (secs, combo), file=out)
