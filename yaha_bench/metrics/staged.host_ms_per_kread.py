"""staged.host_ms_per_kread (ms): the staged driver's host phases after
phase 1 (gap, phase 2, extension and finish, as the host runs them) per
1,000 reads: the align_fn calls' walls, from the harness's spans, less
StagedAligner.stats' begin_s and device_s and the seeder's seed_device_s
over the window.  Each of those is a sum over the calls, so the rest is
the other phases' sum whatever the prefetch interleaves; the program's
own gap_host_s / ext_host_s subtract a shared device_s and read wrong
while two batches run at once."""


def read(ctx):
    if ctx["reads"] <= 0 or not ctx["align_spans"]:
        return None
    st, sd = ctx["stats"], ctx["seed_stats"]
    walls = sum(b - a for a, b in ctx["align_spans"])
    rest = walls - st["begin_s"] - st["device_s"] - (
        sd["seed_device_s"] if sd else 0.0)
    return rest * 1e6 / ctx["reads"]
