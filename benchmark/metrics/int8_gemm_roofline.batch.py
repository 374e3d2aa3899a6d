"""The per-channel int8 GEMMs' share of their bound: the bound of every
block linear's K4 (b) and K3 calls in a generation, counted from the
configuration's shapes (``benchmark/counts.py``), times the traced
generations, over the device time of those kernels in the trace, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or "latencies_ms" in vars(ctx) or not ctx.images:
        return None
    keys = ctx.counts.KERNELS["K4 (b)"] + ctx.counts.KERNELS["K3"]
    busy = t.kernel_s(keys)
    if not busy:
        return None
    gens = ctx.images / ctx.batch
    bound = ctx.counts.int8_gemm_bound_s(ctx.spec["model"], ctx.batch) * gens
    return 100.0 * bound / busy
