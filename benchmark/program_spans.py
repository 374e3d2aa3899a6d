"""The program's own tracing, for the readers of ``benchmark/metrics/``:
the spans that ``fpqvar_tpu_torch`` records while a profiler runs
(``utils/logging.py`` ``spans``: name, ``time.time_ns()`` start and end,
id, parent id, attributes), and the stage marker kernel that it launches
at the start of each scale of a generation and once after the last
(``ops/stage_mark.py`` ``STAGE_MARK_KERNEL``), which splits each replay
of its steps graph by scale.

A program without them gives no spans, no marker name and no steps
graphs, and the readers then read nothing.
"""
from __future__ import annotations


def in_window(ctx, name: str) -> list:
    """The program's spans called ``name`` that overlap the traced
    window, in the order they started; [] without a trace or spans."""
    t = ctx.trace
    w = None if t is None else t.window
    if w is None:
        return []
    try:
        from fpqvar_tpu_torch.utils.logging import spans
    except ImportError:
        return []
    return sorted((s for s in spans() if s.name == name
                   and s.end_ns >= w[0] and s.start_ns <= w[1]),
                  key=lambda s: s.start_ns)


def marker_name():
    """The stage marker kernel's name, or None."""
    try:
        from fpqvar_tpu_torch.ops.stage_mark import STAGE_MARK_KERNEL
    except ImportError:
        return None
    return STAGE_MARK_KERNEL


def steps_graphs(trace) -> list:
    """The device events of each launch of a steps graph (a graph launch
    that holds stage markers), each sorted by start, in the order the
    launches started; [] without markers or correlation ids."""
    mark = marker_name()
    groups = None if (trace is None or mark is None) else (
        trace.graph_launches())
    if not groups:
        return []
    return [sorted(g, key=lambda e: e[1]) for g in groups
            if any(mark in e[0] for e in g)]


def scale_starts(graph) -> list:
    """The start (ns) of each stage marker of one steps graph, in order:
    scale ``k`` runs from marker ``k`` to marker ``k + 1``, and the last
    marker follows the last scale."""
    mark = marker_name()
    return [e[1] for e in graph if mark in e[0]]


def ms(s) -> float:
    """A span's length in ms."""
    return (s.end_ns - s.start_ns) * 1e-6
