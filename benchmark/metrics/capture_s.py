"""The generator's warm-up generation plus its two graphs' capture
(``VARGenerator.capture_stats``)."""


def read(ctx):
    c = ctx.capture
    if not c:
        return None
    return c["warmup_s"] + c["capture_s"]
