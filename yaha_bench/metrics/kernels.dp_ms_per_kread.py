"""kernels.dp_ms_per_kread (ms): the device time of the DP phase's
hand-written kernels (extension, anchored gap fill, gather, walk:
csrc/ext*_kernels.cu, anch_kernels.cu, gather_kernels.cu,
decode_kernels.cu) in the traced window, per 1,000 reads aligned in it.
A faster kernel, or one that evaluates fewer cells, lowers it; nothing
where no such kernel ran."""


def read(ctx):
    t = ctx["timeline"]
    if t is None or ctx["reads"] <= 0:
        return None
    device_s = ctx["device_seconds"](t["device_s_by_name"], ctx["dp_kernels"])
    if device_s <= 0:
        return None
    return device_s * 1e6 / ctx["reads"]
