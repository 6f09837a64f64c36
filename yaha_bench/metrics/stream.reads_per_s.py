"""stream.reads_per_s (reads/s): reads_per_s, as the untraced run takes it
(the reads the CLI loop emitted in the window over the window's length),
in the cells where the host's speed spreads it too widely for a bound
(devidx.1kb_mixed); here from the traced run."""


def read(ctx):
    if ctx["reads"] <= 0 or ctx["window_s"] <= 0:
        return None
    return ctx["reads"] / ctx["window_s"]
