"""Host time of the program's ``engine.draw`` span (the labels and the
whole generation's Gumbel noise into the graphs' static buffers) per
``generate`` call (``engine.generate`` span) of the traced window."""


def read(ctx):
    from benchmark import program_spans as ps

    if "latencies_ms" in vars(ctx):
        return None
    calls = ps.in_window(ctx, "engine.generate")
    draws = ps.in_window(ctx, "engine.draw")
    if not calls or not draws:
        return None
    return sum(ps.ms(s) for s in draws) / len(calls)
