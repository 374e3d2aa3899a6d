"""The 95th percentile of every request due in the window, each from its
scheduled send time to its image on the host; a request that failed or
was not done by the end of the drain counts at the drain's end."""
import numpy as np


def read(ctx):
    lat = vars(ctx).get("latencies_ms")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, dtype=np.float64), 95))
