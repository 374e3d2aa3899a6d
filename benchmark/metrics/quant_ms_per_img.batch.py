"""Device time of the quantizer kernels (Q1, Q2, Q3 and K4's row
quantize, by the program's kernel names) in the traced window, per
image.  A time and not a share of a bound: a tensor warm in L2 reads
faster than the bytes bound allows."""


def read(ctx):
    t = ctx.trace
    if t is None or "latencies_ms" in vars(ctx) or not ctx.images:
        return None
    keys = sum((ctx.counts.KERNELS[k] for k in ("Q1", "Q2", "Q3", "K4 (a)")),
               ())
    if not t.launches(keys):
        return None
    return t.kernel_s(keys) * 1e3 / ctx.images
