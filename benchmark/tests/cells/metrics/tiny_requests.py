"""Test-only per-layer metric: the requests or images a run attempted."""


def read(ctx):
    return ctx.attempted
