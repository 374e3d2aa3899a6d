"""Host time of the program's ``engine.launch`` span (the replays of the
steps and decode graphs, which spin until the stream has room) per
``generate`` call (``engine.generate`` span) of the traced window."""


def read(ctx):
    from benchmark import program_spans as ps

    if "latencies_ms" in vars(ctx):
        return None
    calls = ps.in_window(ctx, "engine.generate")
    launches = ps.in_window(ctx, "engine.launch")
    if not calls or not launches:
        return None
    return sum(ps.ms(s) for s in launches) / len(calls)
