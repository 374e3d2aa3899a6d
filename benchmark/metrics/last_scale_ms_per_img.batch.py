"""Device time of each generation's last scale, per image: in every
launch of the steps graph, from the start of the last scale's stage
marker (the second to last marker) to the end of the graph's last event,
summed over the launches and divided by their images."""


def read(ctx):
    from benchmark import program_spans as ps

    if "latencies_ms" in vars(ctx):
        return None
    graphs = ps.steps_graphs(ctx.trace)
    if not graphs:
        return None
    ns = 0
    for g in graphs:
        starts = ps.scale_starts(g)
        if len(starts) < 2:
            return None
        ns += max(e[2] for e in g) - starts[-2]
    return ns * 1e-6 / (len(graphs) * ctx.batch)
