"""setup.index_build_s (s): the port's index builder (index/build.py)
in set-up, its stats summed: the host's window scan, the device passes
(CUDA events), the host's sampling pass and the fetch of SO and ROA."""


def read(ctx):
    return ctx["setup"]["index_build_s"]
