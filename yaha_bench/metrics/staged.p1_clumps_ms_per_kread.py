"""staged.p1_clumps_ms_per_kread (ms): StagedAligner.stats' p1_clumps_s
over the window per 1,000 reads: phase 1's thread-seconds, summed over
its native threads, of the hit sort and coalesce and the fragments-to-
clumps stage, of the host scan's strands and of the device seeder's hit
rows. The program adds them only while its recorder is on (the traced
window); nothing where it has no such sum or recorded no spans."""
from yaha_bench import spans


def read(ctx):
    v = ctx["stats"].get("p1_clumps_s")
    if v is None or ctx["reads"] <= 0 or spans.program_spans(ctx) is None:
        return None
    return v * 1e6 / ctx["reads"]
