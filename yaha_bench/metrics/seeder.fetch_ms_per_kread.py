"""seeder.fetch_ms_per_kread (ms): the program's seeder.fetch spans over
the window per 1,000 reads: the device seed phase blocked in its fetches
(each tier's totals, the hit rows, the phantom rows), summed over the
aligner's threads.  Nothing where the seed scan stays on the host or the
program records no spans."""
from yaha_bench import spans


def read(ctx):
    sp = spans.program_spans(ctx)
    if sp is None or ctx["reads"] <= 0:
        return None
    s = spans.total_s(sp, "seeder.fetch")
    return None if s is None else s * 1e6 / ctx["reads"]
