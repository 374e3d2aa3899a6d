"""Finding a cell's pieces by name: its workload entry in
``BENCHMARK.json``, its configuration file, its traffic file, and the
reader of each metric it reports (``benchmark/metrics/<name>.py``, a
``read(ctx)`` that returns the value, or None where it finds nothing to
read).  A new cell, configuration, mix or metric is new files and new
entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
METRICS = HERE / "metrics"


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    return json.loads(Path(path).read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a cell reports: its end-to-end metrics, or with
    ``trace`` its per-layer metrics (those without a ``workloads`` list go
    to every cell that reports the end-to-end metric they move)."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in names)]


def reader(name: str, roots=(METRICS,)):
    """The ``read`` function of metric ``name``, from the first of
    ``roots`` that holds ``<name>.py``."""
    path = next(p for p in (Path(r) / f"{name}.py" for r in roots)
                if p.exists())
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
