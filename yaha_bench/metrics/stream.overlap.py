"""stream.overlap (x): the align_fn calls' walls summed over the window's
length, from the harness's spans around align_fn.  Above 1, the CLI
loop's prefetch runs two batches at once."""


def read(ctx):
    if ctx["window_s"] <= 0 or not ctx["align_spans"]:
        return None
    return sum(b - a for a, b in ctx["align_spans"]) / ctx["window_s"]
