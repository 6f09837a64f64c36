"""kernels.seed_roofline (%): the device seed phase's least time over the
device time of seed_hash_kernel and expand_sort_kernel
(csrc/seed_kernels.cu) in the traced window.  The least time is the
phase's bytes (roofline.seed_bytes: the reads' codes, each clean window's
SO run, each hit's ROA read and row out, counted by roofline.seed_work on
the reference's own index) over the card's byte rate; nothing where the
seed scan stays on the host."""


def read(ctx):
    t, work = ctx["timeline"], ctx["seed_work"]
    if t is None or work is None:
        return None
    rl = ctx["roofline"]
    device_s = ctx["device_seconds"](t["device_s_by_name"],
                                     ctx["seed_kernels"])
    bound = rl.seed_bytes(*work) / rl.HBM_BYTES_S
    ctx["seed_count"] = {"bases": work[0], "clean_windows": work[1],
                         "hits": work[2], "bound_s": bound,
                         "device_s": device_s}
    return rl.share_pct(bound, device_s)
