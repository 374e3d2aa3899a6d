"""The device trace of a ``--trace 1`` run: torch.profiler (CUDA activity)
over part of the run, read in memory.

The profiler drops a varying number of a window's first kernel records,
so every window opens on ``PAD`` short spin kernels, which are left out.
The traced window runs from the first kept kernel's start to the last
one's end; ``busy`` is the union of the device events' intervals in it
(kernels, copies and fills; overlapping ones counted once).  Kernels of
one CUDA graph launch share its correlation id, which ties a replay's
kernels to its launch.  Host spans (``span``, wall clock in ns, the
profiler's clock) label the idle gaps by what the host was doing.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

PAD = 256
PAD_NAME = "spin_kernel"


class Trace:
    def __init__(self):
        self._prof = None
        self.events = []          # (name, start_ns, end_ns, correlation)
        self.host = []            # (name, start_ns, end_ns)

    # ---------------------------------------------------------------
    def start(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        for _ in range(PAD):
            torch.cuda._sleep(1000)

    def stop(self):
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.events = _device_events(self._prof)
        self._prof = None

    def span(self, name: str):
        return _Span(self.host, name)

    # ---------------------------------------------------------------
    @property
    def window(self):
        """(start, end) ns of the traced window."""
        if not self.events:
            return None
        return (min(e[1] for e in self.events),
                max(e[2] for e in self.events))

    def intervals(self):
        """The busy intervals: the union of the device events'."""
        out = []
        for _, s, e, _ in sorted(self.events, key=lambda x: x[1]):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.intervals()) * 1e-9

    def window_s(self) -> float:
        w = self.window
        return 0.0 if w is None else (w[1] - w[0]) * 1e-9

    def kernel_s(self, keys) -> float:
        """Device seconds of the events whose names hold any of ``keys``."""
        return sum(e - s for n, s, e, _ in self.events
                   if any(k in n for k in keys)) * 1e-9

    def launches(self, keys) -> int:
        return sum(1 for n, *_ in self.events if any(k in n for k in keys))

    def graph_launches(self):
        """The device events of each CUDA graph launch (two or more events
        under one correlation id), in the order they started; None where
        the trace carries no correlation ids."""
        by = defaultdict(list)
        for ev in self.events:
            if ev[3]:
                by[ev[3]].append(ev)
        groups = [g for g in by.values() if len(g) > 1]
        if not groups:
            return None
        return sorted(groups, key=lambda g: min(e[1] for e in g))

    def breakdown(self, top: int = 10) -> dict:
        tot = defaultdict(int)
        for n, s, e, _ in self.events:
            tot[n] += e - s
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        iv = self.intervals()
        gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1])
                       for i in range(len(iv) - 1)), reverse=True)[:top]
        return {"device_ops": [[n[:120], t * 1e-9] for n, t in ops],
                "idle_gaps": [[self._host_at(at), g * 1e-9]
                              for g, at in gaps]}

    def _host_at(self, t_ns: int) -> str:
        inside = [n for n, s, e in self.host if s <= t_ns <= e]
        return inside[-1] if inside else "host outside spans"


class _Span:
    def __init__(self, sink, name):
        self.sink, self.name = sink, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.sink.append((self.name, self.t0, time.time_ns()))
        return False


def _device_events(prof):
    """(name, start_ns, end_ns, correlation id) of every device event but
    the spin kernels that open the window."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        name = e.name()
        if PAD_NAME in name:
            continue
        try:
            corr = e.correlation_id()
        except AttributeError:
            corr = 0
        s = e.start_ns()
        out.append((name, s, s + e.duration_ns(), corr))
    return out
