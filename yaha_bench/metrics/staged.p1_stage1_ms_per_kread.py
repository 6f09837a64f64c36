"""staged.p1_stage1_ms_per_kread (ms): StagedAligner.stats' p1_stage1_s
over the window per 1,000 reads: phase 1's thread-seconds, summed over
its native threads, of the clumps' stage-1 alignment (perfect
extensions, match runs, the gap cascade with its small DPs inline). The
program adds them only while its recorder is on (the traced window);
nothing where it has no such sum or recorded no spans."""
from yaha_bench import spans


def read(ctx):
    v = ctx["stats"].get("p1_stage1_s")
    if v is None or ctx["reads"] <= 0 or spans.program_spans(ctx) is None:
        return None
    return v * 1e6 / ctx["reads"]
