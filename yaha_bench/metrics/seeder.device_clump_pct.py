"""seeder.device_clump_pct (%): the strand rows whose clumps the device
seeder's clump kernel made (DeviceSeeder.stats' clump_rows) over the
strand rows the seeder served in the window (clump_rows plus
clump_host_rows, the rows whose hits went to the host: phantom rows and
the kernel's overflow).  Nothing where the seed scan stays on the host or
the seeder keeps no such counts."""


def read(ctx):
    s = ctx["seed_stats"]
    if s is None or "clump_rows" not in s or "clump_host_rows" not in s:
        return None
    served = s["clump_rows"] + s["clump_host_rows"]
    return None if served <= 0 else 100.0 * s["clump_rows"] / served
