"""dispatch.launches_per_batch (launches): StagedAligner.stats'
dp_launches over the window per batch (align_fn call)."""


def read(ctx):
    if ctx["batches"] <= 0:
        return None
    return ctx["stats"]["dp_launches"] / ctx["batches"]
