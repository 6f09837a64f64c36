"""dispatch.ms_per_kread (ms): StagedAligner.stats' device_s over the
window per 1,000 reads: the host's time in the DP dispatch (launches,
transfers and the waits on the card mixed), not device time."""


def read(ctx):
    if ctx["reads"] <= 0:
        return None
    return ctx["stats"]["device_s"] * 1e6 / ctx["reads"]
