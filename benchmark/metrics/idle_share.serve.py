"""The share of the traced serving window that no device operation covers
(the union of their intervals), in %."""


def read(ctx):
    t = ctx.trace
    if t is None or "latencies_ms" not in vars(ctx) or not t.window_s():
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
