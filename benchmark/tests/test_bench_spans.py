"""The readers of the program's spans and stage markers, on a synthetic
run: spans in place of the program's buffer and device events in place of
the profiler's, on one clock.  Each reader returns None where the
program records neither (an older program)."""
import sys
from types import SimpleNamespace

import pytest

from benchmark import cells, program_spans

MARK = "fpq_stage_mark"
MS = 1_000_000


class _Trace:
    """The parts of ``benchmark/trace.py`` ``Trace`` that the readers
    use: the window and the events of each graph launch."""

    def __init__(self, groups, window):
        self.groups, self.window = groups, window

    def graph_launches(self):
        return sorted(self.groups, key=lambda g: min(e[1] for e in g))


def _span(name, start_ms, end_ms, id, parent=None, **attrs):
    from fpqvar_tpu_torch.utils.logging import Span

    return Span(name, int(start_ms * MS), int(end_ms * MS), id, parent,
                attrs)


def _steps(t0_ms, scale_ms, corr, prep_ms=1.0):
    """A steps graph launch starting at ``t0_ms``: a prepare kernel, then
    per scale a marker and one kernel of ``scale_ms[k]``, then the last
    marker."""
    ev = [("prepare", t0_ms * MS, (t0_ms + prep_ms) * MS, corr)]
    t = t0_ms + prep_ms
    for k, d in enumerate(scale_ms):
        ev.append((MARK, int(t * MS), int(t * MS) + 1000, corr))
        ev.append((f"scale{k}", int(t * MS) + 1000, int((t + d) * MS), corr))
        t += d
    ev.append((MARK, int(t * MS), int(t * MS) + 1000, corr))
    return ev


def _decode(t0_ms, corr):
    return [("conv", t0_ms * MS, (t0_ms + 5) * MS, corr),
            ("conv", (t0_ms + 5) * MS, (t0_ms + 9) * MS, corr)]


def _read(name, ctx):
    return cells.reader(name)(ctx)


@pytest.fixture
def batch_run(monkeypatch):
    """Two generate calls of batch 4 in a window of 0-300 ms, and a third
    call from before the window that the readers leave out."""
    import fpqvar_tpu_torch.utils.logging as L

    spans = [_span("engine.generate", -50, -40, 1)]
    for n, t in enumerate((0, 100)):
        g = 10 + 10 * n
        spans += [_span("engine.generate", t, t + 30, g),
                  _span("engine.draw", t + 1, t + 5, g + 1, g),
                  _span("engine.launch", t + 5, t + 25, g + 2, g),
                  _span("engine.copy", t + 25, t + 29, g + 3, g)]
    monkeypatch.setattr(L, "spans", lambda: list(spans))
    groups = [_steps(10, [1.0] * 9 + [20.0], 7), _decode(50, 8),
              _steps(110, [1.0] * 9 + [30.0], 9), _decode(160, 10)]
    trace = _Trace(groups, (2 * MS, 300 * MS))
    return SimpleNamespace(trace=trace, batch=4, images=8)


def test_draw_and_launch_per_call(batch_run):
    assert _read("draw_ms_per_batch.batch", batch_run) == pytest.approx(4.0)
    assert _read("launch_ms_per_batch.batch",
                 batch_run) == pytest.approx(20.0)


def test_last_scale_per_image(batch_run):
    # (20 + 30) ms of last scales over 2 launches of 4 images; each ends
    # on the last marker's 1 us
    got = _read("last_scale_ms_per_img.batch", batch_run)
    assert got == pytest.approx((20 + 30 + 0.002) / 8)


def test_scale_split_sums_to_the_graph_less_its_prepare(batch_run):
    g = program_spans.steps_graphs(batch_run.trace)
    assert len(g) == 2
    starts = program_spans.scale_starts(g[0])
    assert len(starts) == 11
    per_scale = [b - a for a, b in zip(starts, starts[1:])]
    span = max(e[2] for e in g[0]) - g[0][0][1]
    assert sum(per_scale) == pytest.approx(span - 1.0 * MS, abs=1000)


@pytest.fixture
def serve_run(monkeypatch):
    """Three server batches: the first waits 10 ms on the card, the second
    50 ms behind the first, and the third starts 2 ms before its launch
    span ends."""
    import fpqvar_tpu_torch.utils.logging as L

    spans, groups = [], []
    for n, (t, dev) in enumerate(((0, 30), (40, 110), (300, 318))):
        d = 100 * (n + 1)
        spans += [_span("server.collect", t, t + 10 + 20 * n, d - 1,
                        batch=n, requests=[n]),
                  _span("server.dispatch", t + 50, t + 70, d, batch=n,
                        requests=[n]),
                  _span("engine.generate", t + 50, t + 70, d + 1, d),
                  _span("engine.launch", t + 55, t + 70, d + 2, d + 1)]
        groups += [_steps(dev + 50, [1.0] * 10, 2 * n + 1),
                   _decode(dev + 100, 2 * n + 2)]
    # an eager generate outside any server batch, whose launch is no
    # server batch's
    spans.append(_span("engine.launch", 500, 501, 900, None))
    monkeypatch.setattr(L, "spans", lambda: list(spans))
    trace = _Trace(groups, (0, 1000 * MS))
    return SimpleNamespace(trace=trace, latencies_ms=[1.0], batch=16)


def test_coalesce_median(serve_run):
    assert _read("coalesce_ms_p50.serve", serve_run) == pytest.approx(30.0)


def test_device_wait_median(serve_run):
    # launches end at 70, 110, 370 ms; the steps graphs start at 80, 160,
    # 368 ms
    assert _read("device_wait_ms_p50.serve",
                 serve_run) == pytest.approx(10.0)


def test_device_wait_needs_one_graph_a_batch(serve_run):
    serve_run.trace.groups = serve_run.trace.groups[2:]
    assert _read("device_wait_ms_p50.serve", serve_run) is None


@pytest.mark.parametrize("name", ["draw_ms_per_batch.batch",
                                  "launch_ms_per_batch.batch",
                                  "last_scale_ms_per_img.batch"])
def test_batch_readers_read_nothing_in_a_serve_run(serve_run, name):
    assert _read(name, serve_run) is None


@pytest.mark.parametrize("name", ["coalesce_ms_p50.serve",
                                  "device_wait_ms_p50.serve"])
def test_serve_readers_read_nothing_in_a_batch_run(batch_run, name):
    assert _read(name, batch_run) is None


@pytest.mark.parametrize("name", ["draw_ms_per_batch.batch",
                                  "launch_ms_per_batch.batch",
                                  "last_scale_ms_per_img.batch",
                                  "coalesce_ms_p50.serve",
                                  "device_wait_ms_p50.serve"])
def test_readers_read_nothing_from_a_program_without_spans(
        monkeypatch, batch_run, serve_run, name):
    import fpqvar_tpu_torch.utils.logging as L

    monkeypatch.delattr(L, "spans")
    monkeypatch.setitem(sys.modules, "fpqvar_tpu_torch.ops.stage_mark", None)
    assert _read(name, batch_run) is None
    assert _read(name, serve_run) is None
    assert program_spans.marker_name() is None


def test_readers_read_nothing_without_a_trace():
    ctx = SimpleNamespace(trace=None, batch=4, latencies_ms=[1.0])
    assert _read("coalesce_ms_p50.serve", ctx) is None
    del ctx.latencies_ms
    assert _read("last_scale_ms_per_img.batch", ctx) is None
