"""Requests served over the rows the server generated: ``served /
(batches * max_batch)`` from ``GenerationServer.stats()``, in %."""


def read(ctx):
    s = vars(ctx).get("server")
    if not s or not s["batches"]:
        return None
    return 100.0 * s["served"] / (s["batches"] * ctx.mix["max_batch"])
