"""stream.stall_ms_per_kread (ms): window time during which no `align`
span of the program (the CLI loop's root span of a batch, opened on the
thread that aligns it) is open on any thread, per 1,000 reads: the loop
has nothing in the aligner while it reads and parses the query file or
waits on the writer.  Nothing where the program records no spans."""
from yaha_bench import spans


def read(ctx):
    sp = spans.program_spans(ctx)
    if sp is None or ctx["reads"] <= 0:
        return None
    stall = spans.stall_s(sp, ctx["window_s"])
    return None if stall is None else stall * 1e6 / ctx["reads"]
