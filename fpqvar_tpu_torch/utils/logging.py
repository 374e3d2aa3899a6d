"""Metrics logging and profiling: a windowed-stat tracker, a JSONL metrics
sink and a ``torch.profiler`` trace context (the port of the JAX package's
``utils/logging.py``, whose trace context runs ``jax.profiler``)."""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional


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
    card), written to ``log_dir/trace.json`` as a Chrome trace; no-op when
    ``log_dir`` is None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Timer:
    """Wall-clock stage timer: ``with timer.stage(name): ...`` adds the
    block's seconds to ``timer.stages[name]``."""

    def __init__(self):
        self.stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0)
