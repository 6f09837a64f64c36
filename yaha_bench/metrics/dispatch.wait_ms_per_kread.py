"""dispatch.wait_ms_per_kread (ms): the program's dispatch.wait spans
over the window per 1,000 reads: the DP dispatch blocked in its fetches
(a device-to-host copy that waits for the kernels queued before it),
summed over the aligner's threads.  A part of dispatch.ms_per_kread;
nothing where the program records no spans."""
from yaha_bench import spans


def read(ctx):
    sp = spans.program_spans(ctx)
    if sp is None or ctx["reads"] <= 0:
        return None
    s = spans.total_s(sp, "dispatch.wait")
    return None if s is None else s * 1e6 / ctx["reads"]
