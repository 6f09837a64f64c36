"""The traced run's device timeline, from torch.profiler's Chrome trace.

The window is the span of the harness's "bench.window" annotation (the
main thread's CPU activity, in the trace's own clock); device operations
are the trace's kernels, copies and fills, clipped to it.  The harness's
host spans (perf_counter seconds) are placed on the trace's clock by the
window's start, so each idle gap of the card is named by what the host
was doing then: inside a call of the aligner (align_fn), in the CLI loop
outside one (parse, emit, the queue), or between two passes of the loop.
"""
from __future__ import annotations

import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _union(intervals):
    """Merged (start, end) intervals, ascending."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _covers(spans, t):
    return any(a <= t <= b for a, b in spans)


def summarize(path: str, align_spans, pass_spans, t_window0: float) -> dict:
    """busy_s, window_s, device time by operation name, the top device
    operations and the longest idle gaps, from the trace at `path`.
    `align_spans` / `pass_spans`: (start, end) host perf_counter seconds;
    `t_window0`: the host time at the window annotation's start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    mark = next(e for e in events if e.get("name") == "bench.window"
                and "dur" in e)
    w0, w1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    by_name = {}
    ivals = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e["dur"]), w1)
        if b <= a:
            continue
        ivals.append((a, b))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + (b - a) / 1e6
    busy = _union(ivals)
    busy_us = sum(b - a for a, b in busy)

    def to_trace(spans):
        return [((a - t_window0) * 1e6 + w0, (b - t_window0) * 1e6 + w0)
                for a, b in spans]
    aligns, passes = to_trace(align_spans), to_trace(pass_spans)
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = ("align_fn (staged host phases)" if _covers(aligns, mid)
                 else "CLI loop outside align_fn (parse, emit, queue)"
                 if _covers(passes, mid) else "between passes of the loop")
        gaps.append((b - a, label))
    gaps.sort(reverse=True)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
            "device_s_by_name": by_name,
            "device_ops": [[n, s] for n, s in top_ops],
            "idle_gaps": [[lab, us / 1e6] for us, lab in gaps[:TOP]]}


def device_seconds(by_name: dict, pattern) -> float:
    """Device seconds of the operations whose name `pattern` (a compiled
    regex) finds."""
    return sum(s for n, s in by_name.items() if pattern.search(n))
