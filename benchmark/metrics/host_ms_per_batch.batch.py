"""Host time inside ``VARGenerator.generate`` per call, over all of the
window's calls (a host span around each call)."""


def read(ctx):
    s = ctx.gen_host_s
    if "latencies_ms" in vars(ctx) or not s:
        return None
    return 1e3 * sum(s) / len(s)
