"""The median, over the window's requests, of the time from a request's
due time to the start of the ``generate`` call that took it (a host span
the benchmark puts around the generator it hands to the server)."""
import numpy as np


def read(ctx):
    q = vars(ctx).get("queue_ms")
    if not q:
        return None
    return float(np.median(np.asarray(q, dtype=np.float64)))
