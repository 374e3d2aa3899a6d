"""Process start to the first timed batch or request: imports, the seeded
weights, the program's transform, warm-up and graph capture (and, in a
checkout's first run, the kernels' build)."""


def read(ctx):
    return ctx.setup_s
