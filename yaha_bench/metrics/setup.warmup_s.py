"""setup.warmup_s (s): from the aligner's construction (the seeder's
index upload, the genome's upload, the kernels' load) to the end of the
warm-up, one pass of the CLI loop over the cell's pool, by the harness's
own clock."""


def read(ctx):
    return ctx["setup"]["warmup_s"]
