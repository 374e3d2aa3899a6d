"""Device time of the kernels that the trace ties to each generation's
second CUDA graph launch (the VQVAE decode graph), per image.  The
launches come in (steps, decode) pairs; nothing is read where the trace
carries no correlation ids or the pairs do not show."""


def read(ctx):
    t = ctx.trace
    if t is None or "latencies_ms" in vars(ctx):
        return None
    groups = t.graph_launches()
    if not groups or len(groups) % 2:
        return None
    steps, decode = groups[0::2], groups[1::2]
    if any(len(d) >= len(s) for s, d in zip(steps, decode)):
        return None
    ns = sum(e[2] - e[1] for g in decode for e in g)
    return ns * 1e-6 / (len(decode) * ctx.batch)
