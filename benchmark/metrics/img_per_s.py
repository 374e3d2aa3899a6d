"""Images completed over the measured window (host clock): from the first
timed batch queued to the completion of the last batch queued, where
nothing more is queued once a batch completes at or after ``--seconds``;
whole batches only."""


def read(ctx):
    if "latencies_ms" in vars(ctx) or not ctx.window_s:
        return None
    return ctx.images / ctx.window_s
