"""seeder.ms_per_kread (ms): DeviceSeeder.stats' seed_device_s over the
window (the device seed phase's host-clock wall) per 1,000 reads; nothing
where the seed scan stays on the host."""


def read(ctx):
    if ctx["seed_stats"] is None or ctx["reads"] <= 0:
        return None
    return ctx["seed_stats"]["seed_device_s"] * 1e6 / ctx["reads"]
