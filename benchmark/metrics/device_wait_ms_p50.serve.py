"""The median, over the server batches of the traced window, of how long
a batch waits on the card behind its predecessor: from the end of its
``engine.launch`` span (host clock) to the first event of its steps graph
in the device trace (the profiler's clock, converted to the same Unix
time), batches matched to steps-graph launches in order.  Negative where
the card started a batch before the host had finished launching it."""
import numpy as np


def read(ctx):
    from benchmark import program_spans as ps

    if "latencies_ms" not in vars(ctx):
        return None
    dispatch = {s.id for s in ps.in_window(ctx, "server.dispatch")}
    calls = {s.id for s in ps.in_window(ctx, "engine.generate")
             if s.parent in dispatch}
    launches = [s for s in ps.in_window(ctx, "engine.launch")
                if s.parent in calls]
    graphs = ps.steps_graphs(ctx.trace)
    if not launches or len(launches) != len(graphs):
        return None
    return float(np.median([(g[0][1] - s.end_ns) * 1e-6
                            for s, g in zip(launches, graphs)]))
