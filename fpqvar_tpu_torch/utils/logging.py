"""Metrics logging, profiling and program spans: a windowed-stat tracker,
a JSONL metrics sink, a ``torch.profiler`` trace context (the port of the
JAX package's ``utils/logging.py``, whose trace context runs
``jax.profiler``) and a span recorder on the profiler's clock.

Spans (:func:`span`) name what the host is doing: a name, a start and an
end as ``time.time_ns()`` (the Unix clock to which the profiler converts
its own timestamps, so spans line up with a device trace), an id, the id
of the span open around it on the same thread, and a few attributes.
They are recorded only while a ``torch.profiler`` session is active (the
flag PyTorch keeps for fast Python checks); with no session a span costs
one attribute read.  Recorded spans are kept in memory, the newest
``SPAN_CAPACITY`` of them: :func:`spans` returns a copy, and
:func:`clear_spans` empties the buffer.  Inside :func:`profile_trace`
each span also opens a ``record_function`` of its name, so the Chrome
trace shows the spans over the kernels.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

#: how many spans the buffer keeps (the oldest go first)
SPAN_CAPACITY = 1 << 16


class SmoothedValue:
    """Windowed median / average tracker."""

    def __init__(self, window: int = 30):
        self.window = deque(maxlen=window)
        self.total = 0.0
        self.count = 0

    def update(self, value: float, n: int = 1):
        self.window.append(value)
        self.total += value * n
        self.count += n

    @property
    def avg(self) -> float:
        return sum(self.window) / max(len(self.window), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def median(self) -> float:
        s = sorted(self.window)
        return s[len(s) // 2] if s else 0.0


class MetricLogger:
    """Iteration logger; with ``jsonl_path`` every update appends one JSON
    line ``{"t": unix time, <metric>: value, ..., "step": step}``."""

    def __init__(self, jsonl_path: Optional[str] = None, window: int = 30):
        self.meters: Dict[str, SmoothedValue] = defaultdict(
            lambda: SmoothedValue(window))
        self.jsonl_path = jsonl_path
        if jsonl_path:
            os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)

    def update(self, step: Optional[int] = None, **metrics: float):
        for k, v in metrics.items():
            self.meters[k].update(float(v))
        if self.jsonl_path:
            rec = {"t": time.time(), **{k: float(v) for k, v in
                                        metrics.items()}}
            if step is not None:
                rec["step"] = int(step)
            with open(self.jsonl_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, float]:
        return {k: m.global_avg for k, m in self.meters.items()}

    def __str__(self) -> str:
        return "  ".join(
            f"{k}: {m.avg:.4f} ({m.global_avg:.4f})"
            for k, m in self.meters.items())


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` over the block (host and, where there is one, the
    card), written to ``log_dir/trace.json`` as a Chrome trace, with the
    program's spans in it; no-op when ``log_dir`` is None."""
    global _annotate
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        _annotate += 1
        try:
            yield
        finally:
            _annotate -= 1
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# program spans
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Span:
    """One recorded span: ``start_ns`` and ``end_ns`` are
    ``time.time_ns()``; ``parent`` is the id of the span that was open
    around it on its thread (None at the top)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    attrs: dict = field(default_factory=dict)


_spans: deque = deque(maxlen=SPAN_CAPACITY)
_span_ids = itertools.count(1)
_open = threading.local()
#: open profile_trace sessions: spans also open a record_function
_annotate = 0


class _Off:
    """The span handed out while no profiler runs: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _On:
    __slots__ = ("name", "attrs", "id", "parent", "start_ns", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only once the span has started."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_span_ids)
        stack.append(self.id)
        self._rf = None
        if _annotate:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _open.stack.pop()
        _spans.append(Span(self.name, self.start_ns, end, self.id,
                           self.parent, self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records the block as a span named ``name``
    with ``attrs`` while a ``torch.profiler`` session is active, and does
    nothing otherwise.  What it yields is false when nothing is recorded,
    and has ``set(**attrs)`` either way."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, attrs)


def spans() -> List[Span]:
    """A copy of the recorded spans, oldest first (by end)."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()
