"""staged.phase1_ms_per_kread (ms): StagedAligner.stats' begin_s over the
window (native phase 1: parse, seed scan, chain, clumps) per 1,000 reads.
A sum of host-clock spans; under the prefetch two batches add at once."""


def read(ctx):
    if ctx["reads"] <= 0:
        return None
    return ctx["stats"]["begin_s"] * 1e6 / ctx["reads"]
