"""The median, over the server batches of the traced window, of the
program's ``server.collect`` span: from a batch's first request taken
off the queue to the batch closed (at most ``max_wait_ms`` by design)."""
import numpy as np


def read(ctx):
    from benchmark import program_spans as ps

    if "latencies_ms" not in vars(ctx):
        return None
    spans = ps.in_window(ctx, "server.collect")
    if not spans:
        return None
    return float(np.median([ps.ms(s) for s in spans]))
