"""The benchmark of ``fpqvar_tpu_torch``: one run of one cell.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The run builds the cell's configuration on the card from the seed (seeded
weights through the program's device transform), warms up every shape the
cell's traffic uses (the generator's first call captures its CUDA graphs)
and counts all of that as set-up; then it drives the cell's traffic
(``benchmark/traffic.py``) for ``--seconds``.  Once the window has closed
it reads the peak memory, frees the program, checks what the timed path
produced against the plain reference (``benchmark/check.py``), and prints
one JSON line: ``correct``, ``attempted``, ``failed``, the cell's
end-to-end metrics (``--trace 0``) or per-layer metrics (``--trace 1``,
with the device's busy and window seconds and the trace's breakdown), the
device, and last the compared numbers beside their limits, which also end
standard error.

With ``--trace 1`` the run is shorter: the traffic file's
``trace_batches`` batches, or its ``trace_seconds`` of serving, all under
torch.profiler.  Exits non-zero without a result when the card or the
program is missing, or when JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import collections  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fpqvar_tpu")
#: how long the drain after a serving window waits for the last requests
DRAIN_S = 60.0
#: the batch index whose labels and seed the warm-up generation uses
WARM_BATCH = 1 << 20
#: the checked generation is one of the window's first CHECK_AMONG
CHECK_AMONG = 3


def process_start() -> float:
    """The wall-clock time this process started (``/proc``), else the
    time this module was imported."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def card_state() -> str | None:
    """The card's SM clock (MHz), power draw (W), temperature (C) and
    active clock event reasons, as ``nvidia-smi`` reads them; ``None``
    where it cannot.  Beside a run's timings it tells a card that ran
    slow (a lower clock, a power or thermal cap) from a host that did."""
    import subprocess

    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu,"
             "clocks_throttle_reasons.active", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().replace("\n", "; ") or None


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _check_at(seed: int, mix: dict) -> int:
    n = min(CHECK_AMONG, mix.get("trace_batches", CHECK_AMONG))
    return int(np.random.default_rng([seed, 10]).integers(n))


# ---------------------------------------------------------------------------
# drivers: the program's entry points under the cell's traffic
# ---------------------------------------------------------------------------

class BatchDriver:
    """Closed loop of whole batches through ``VARGenerator.generate``; the
    checked rows (half from each half of the batch) and the checked batch
    come from the seed."""

    def __init__(self, prog, spec, mix, seed, device):
        import torch

        from benchmark import traffic

        self.torch, self.traffic = torch, traffic
        self.prog, self.spec, self.seed, self.dev = prog, spec, seed, device
        self.b = mix["batch"]
        self.labels = torch.as_tensor(traffic.batch_labels(
            mix, spec["model"]["num_classes"], seed, 4096), device=device)
        r = spec["check"]["rows"]
        rng = np.random.default_rng([seed, 9])
        half = self.b // 2
        self.rows = sorted(int(i) for i in np.concatenate([
            rng.choice(half, r // 2, replace=False),
            half + rng.choice(self.b - half, r - r // 2, replace=False)]))
        self.check_at = _check_at(seed, mix)
        self.ahead = int(mix.get("ahead", 1))
        self.state = self.images = None
        self.done = 0
        self.gen_s, self.gen_cpu_s, self.done_at = [], [], []
        self.card = []
        self.copy = (torch.cuda.Stream(device) if
                     torch.device(device).type == "cuda" else None)

    def warm(self):
        """Capture the graphs, then replay them once: a graph's first
        launch also uploads it to the device."""
        self.prog.tap.arm(self.b, self.rows, self.spec["model"]["embed_dim"])
        for i in range(WARM_BATCH, WARM_BATCH + 2):
            self._fetch(self._queue(i))
        self.done, self.gen_s, self.gen_cpu_s = 0, [], []
        if self.copy is not None:
            self.torch.cuda.synchronize()

    def _queue(self, i):
        torch = self.torch
        g = torch.Generator(device=self.dev)
        g.manual_seed(self.traffic.batch_seed(self.seed, i))
        t0, c0 = time.perf_counter(), time.thread_time()
        imgs = self.prog.generator.generate(
            self.prog.params, self.prog.vae, self.labels[i % len(self.labels)],
            g)
        self.gen_s.append(time.perf_counter() - t0)
        self.gen_cpu_s.append(time.thread_time() - c0)
        if i == self.check_at:
            self.state = self.prog.tap.snapshot()
        ev = None
        if self.copy is not None:
            ev = torch.cuda.Event()
            ev.record()
        return i, imgs, ev

    def _fetch(self, q):
        i, imgs, ev = q
        if ev is None:
            host = imgs.to("cpu", self.torch.float32)
        else:
            with self.torch.cuda.stream(self.copy):
                self.copy.wait_event(ev)
                host = imgs.to("cpu", self.torch.float32)
        if i == self.check_at:
            self.images = host[self.rows].clone()
        return host

    def window(self, seconds, trace, n_batches=None):
        """Keep the traffic's ``ahead`` batches queued beyond the one
        being fetched.  At the first fetch at or after ``seconds`` (or
        once ``n_batches`` are queued) queue nothing more, fetch every
        batch still queued, and close the window after that: all of them
        count, over all of that time."""
        pending = collections.deque()
        t0 = time.perf_counter()
        queued, closing = 0, False
        while True:
            while (not closing and len(pending) <= self.ahead
                   and (n_batches is None or queued < n_batches)):
                pending.append(self._queue(queued))
                queued += 1
            if not pending:
                break
            span = trace.span("fetch") if trace else None
            if span:
                span.__enter__()
            self._fetch(pending.popleft())
            if span:
                span.__exit__(None, None, None)
            self.done += 1
            self.done_at.append(time.perf_counter() - t0)
            if self.copy is not None and self.done_at[-1] >= 10 * len(
                    self.card):
                # the card's state about every 10 s, while work is queued
                self.card.append(card_state())
            closing = closing or (n_batches is None
                                  and self.done_at[-1] >= seconds)
        self.t_window = self.done_at[-1]
        return t0

    def sample(self):
        """The checked rows of the checked batch: labels, the program's
        state and tokens, images, and where their noise came from."""
        i = self.check_at
        rows = self.torch.as_tensor(self.rows)
        st = self.state or {"X": None, "S": None, "tokens": None}
        return {"labels": self.labels[i][rows.to(self.labels.device)],
                "X": st["X"], "S": st["S"],
                "tokens": (None if st["tokens"] is None
                           else st["tokens"][rows.to(st["tokens"].device)]),
                "images": self.images, "image_rows": list(range(len(rows))),
                "noise": ("batch", self.traffic.batch_seed(self.seed, i),
                          self.b, rows)}

    def facts(self):
        images = self.done * self.b
        return {"images": images, "window_s": self.t_window,
                "gen_host_s": list(self.gen_s),
                "gen_cpu_s": list(self.gen_cpu_s),
                "done_at_s": list(self.done_at), "card": list(self.card),
                "attempted": images,
                "failed": 0, "batch": self.b}


class ServeDriver:
    """Open-loop single-image requests through ``GenerationServer``; the
    checked rows are the first rows of one of the window's first server
    batches, drawn from the seed."""

    def __init__(self, prog, spec, mix, seed, device):
        import torch

        from benchmark import program, traffic

        self.torch, self.traffic, self.program = torch, traffic, program
        self.prog, self.spec, self.mix = prog, spec, mix
        self.seed, self.dev = seed, device
        self.mb = mix["max_batch"]
        self.rows = list(range(min(spec["check"]["rows"], self.mb)))
        self.shim = program.GeneratorShim(prog, time.perf_counter,
                                          _check_at(seed, mix))
        self.server = None

    def warm(self):
        from benchmark.check import row_seed

        torch = self.torch
        p = self.prog
        if p.tap.b != self.mb:
            p.tap.arm(self.mb, self.rows, self.spec["model"]["embed_dim"])
        gens = []
        for _ in range(self.mb):
            g = torch.Generator(device=self.dev)
            g.manual_seed(row_seed(self.seed, 0))
            gens.append(g)
        labels = torch.zeros(self.mb, dtype=torch.long, device=self.dev)
        for _ in range(2):          # the capture, then the first replay
            p.generator.generate(p.params, p.vae, labels, gens).to("cpu")
        self.server = self.program.server(p, self.shim, self.mb,
                                          self.mix["max_wait_ms"], self.seed)

    def window(self, seconds, trace, n_batches=None):
        due, labels, seeds = self.traffic.arrivals(
            self.mix, self.spec["model"]["num_classes"], self.seed, seconds)
        n = len(due)
        done = [None] * n
        ok = [False] * n
        futs = []
        late = 0.0
        t0 = time.perf_counter()
        for i in range(n):
            wait = t0 + due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            late = max(late, time.perf_counter() - t0 - due[i])
            fut = self.server.submit(int(labels[i]), int(seeds[i]))

            def stamp(f, i=i):
                done[i] = time.perf_counter()
                ok[i] = f.exception() is None

            fut.add_done_callback(stamp)
            futs.append(fut)
        deadline = t0 + seconds + DRAIN_S
        while (not all(f.done() for f in futs)
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        t_drain = time.perf_counter()
        self.server.stop()
        self.lat = [((done[i] if (done[i] is not None and ok[i]) else t_drain)
                     - (t0 + due[i])) * 1e3 for i in range(n)]
        self.due, self.t0 = due, t0
        self.labels, self.seeds, self.ok, self.results = labels, seeds, ok, futs
        self.failed = n - sum(ok)
        self.late_ms = float(late * 1e3)
        self.stats = self.server.stats()
        self.server = None
        self.t_window = seconds
        return t0

    def sample(self):
        """The checked rows of the checked server batch: a row holds a
        request (its label, seed and image) or the server's padding (label
        0, seed 0, no image)."""
        from benchmark.check import row_seed

        torch = self.torch
        st = self.shim.state or {"X": None, "S": None, "tokens": None}
        k = self.shim.check_at
        by_seed = {row_seed(self.seed, int(s)): i
                   for i, s in enumerate(self.seeds)}
        pad = row_seed(self.seed, 0)
        seeds = (self.shim.calls[k]["seeds"] if k < len(self.shim.calls)
                 else [])
        labels, noise, images, image_rows = [], [], [], []
        for r in self.rows:
            s = seeds[r] if r < len(seeds) else None
            i = by_seed.get(s)
            if i is not None:
                labels.append(int(self.labels[i]))
                noise.append(s)
                if self.ok[i]:
                    image_rows.append(len(labels) - 1)
                    images.append(self.results[i].result())
            else:
                # padding, or a seed the server should not have made
                labels.append(0)
                noise.append(pad if s == pad else None)
        return {"labels": torch.as_tensor(labels),
                "X": st["X"], "S": st["S"],
                "tokens": (None if st["tokens"] is None else
                           st["tokens"][torch.as_tensor(self.rows).to(
                               st["tokens"].device)]),
                "images": torch.stack(images) if images else None,
                "image_rows": image_rows, "noise": ("rows", noise)}

    def queue_ms(self):
        """Per request: from its due time to the start of the generate
        call that took it."""
        from benchmark.check import row_seed

        start = {}
        for call in self.shim.calls:
            for s in call["seeds"]:
                start.setdefault(s, call["start"])
        out = []
        for i, seed in enumerate(self.seeds):
            s = start.get(row_seed(self.seed, int(seed)))
            if s is not None:
                out.append((s - (self.t0 + self.due[i])) * 1e3)
        return out

    def facts(self):
        return {"latencies_ms": self.lat, "attempted": len(self.lat),
                "failed": self.failed, "server": self.stats,
                "queue_ms": self.queue_ms(), "late_ms": self.late_ms,
                "window_s": self.t_window, "batch": self.mb,
                "images": sum(self.ok),
                "gen_host_s": [c["end"] - c["start"]
                               for c in self.shim.calls]}


DRIVERS = {"batch": BatchDriver, "server": ServeDriver}


# ---------------------------------------------------------------------------

def run(bench: dict, cell_name: str, seed: int, seconds: float, trace: bool,
        device, t_start: float, root: Path = ROOT, traffic_dir=None,
        metrics_dir=None, control: bool = False) -> dict:
    """One run of a cell; returns the result's dict (with ``control``, the
    control's readings beside the program's under ``"check"``), with an
    ``"info"`` entry (set-up parts, window length, the sender's lateness)
    that :func:`main` prints to standard error and leaves out of the
    line.  ``root``
    is where the configuration files' paths start; ``traffic_dir`` and
    ``metrics_dir`` default to the benchmark's own."""
    import torch

    from benchmark import cells, check, counts, program, traffic
    from benchmark.trace import Trace

    cell = cells.workload(bench, cell_name)
    spec = cells.config(bench, cell["config"], root)
    mix = traffic.load(cell["traffic"], traffic_dir or traffic.ROOT)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    prog = program.build(spec, seed, device)
    drv = DRIVERS[mix["entry"]](prog, spec, mix, seed, device)
    drv.warm()
    tracer = Trace() if (trace and on_card) else None
    n_batches = None
    if trace:
        n_batches = mix.get("trace_batches")
        seconds = min(seconds, mix.get("trace_seconds", seconds))
    if tracer:
        tracer.start()
    setup_s = time.time() - t_start
    drv.window(seconds, tracer, n_batches)
    if tracer:
        tracer.stop()
    peak = torch.cuda.max_memory_reserved() if on_card else 0
    batch = mix.get("batch", mix.get("max_batch"))
    capture = prog.generator.capture_stats(batch)
    kv = program.kv_cache_bytes(prog, batch)
    build_s = dict(prog.build_s)
    facts = drv.facts()
    rows = drv.sample()
    drv.prog = drv.state = None
    if hasattr(drv, "shim"):
        drv.shim.state = None
    prog.close()
    del prog
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.judge(spec, seed, rows, device, control=control)
    del rows
    limits = spec["check"]["limits"]
    correct = (facts["failed"] == 0
               and all(limits[k] is not None and numbers[k] <= limits[k]
                       for k in limits))
    ctx = SimpleNamespace(spec=spec, mix=mix, cell=cell, setup_s=setup_s,
                          peak_bytes=peak, capture=capture, kv_bytes=kv,
                          trace=tracer, counts=counts, **facts)
    metrics = {}
    roots = [d for d in (metrics_dir, cells.METRICS) if d]
    for m in cells.metrics_of(bench, cell_name, trace):
        v = cells.reader(m["name"], roots)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name() if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": facts["attempted"],
           "failed": facts["failed"], "metrics": metrics, "device": dev}
    if tracer:
        dev["busy_s"] = tracer.busy_s()
        dev["window_s"] = tracer.window_s()
        out["breakdown"] = tracer.breakdown()
    out["info"] = dict(build_s, window_s=facts["window_s"],
                       **({"sender_late_ms": facts["late_ms"]}
                          if "late_ms" in facts else {}),
                       **({"batch_done_at_s": facts["done_at_s"],
                           "card": facts["card"],
                           "gen_host_s": facts["gen_host_s"],
                           "gen_cpu_s": facts["gen_cpu_s"]}
                          if "done_at_s" in facts else {}))
    out["check"] = {k: {"value": min(numbers[k], 1e30),
                        "limit": limits.get(k)} for k in numbers}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    from benchmark import cells

    bench = cells.load_benchmark()
    cell = cells.workload(bench, args.workload)
    cache = ROOT / ".benchmark_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"benchmark: needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import fpqvar_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is missing: {e}", file=sys.stderr)
        return 2
    out = run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    print("info " + json.dumps(out.pop("info")), file=sys.stderr)
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
