"""The benchmark's files: every cell's pieces found by name, names and
units within the contract's characters, no JAX anywhere, no program in the
reference."""
import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import cells, traffic
from benchmark.tests.helpers import CELLS, REPO, test_bench  # noqa: F401

BENCH = cells.load_benchmark()
HERE = Path(cells.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _metrics(b):
    return b["end_to_end"] + b["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_pieces_found_by_name(w):
    spec = cells.config(BENCH, w["config"])
    assert spec["name"] == w["config"]
    mix = traffic.load(w["traffic"])
    assert mix["entry"] in ("batch", "server")
    for trace in (False, True):
        ms = cells.metrics_of(BENCH, w["name"], trace)
        assert ms
        for m in ms:
            assert callable(cells.reader(m["name"]))
    names = {m["name"] for m in cells.metrics_of(BENCH, w["name"], False)}
    assert "setup_s" in names and len(names) >= 2


def test_names_and_units():
    for group in ("configs", "workloads"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert 1 <= len(e["why"]) <= 200
    for w in BENCH["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    for m in _metrics(BENCH):
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in _metrics(BENCH)]
    assert len(names) == len(set(names))


def test_per_layer_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            e2e = {e["name"] for e in cells.metrics_of(BENCH, cell, False)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_config_files_hold_limits_and_no_cut():
    for c in BENCH["configs"]:
        spec = json.loads((REPO / c["file"]).read_text())
        assert c["reduced"] == []
        assert all(v is not None for v in spec["check"]["limits"].values())


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None)
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_anywhere():
    for path in HERE.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("jax", "jaxlib", "flax",
                                             "fpqvar_tpu"), (path, mod)


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] != "fpqvar_tpu_torch", (path, mod)
            assert not mod.startswith("benchmark.") or mod.startswith(
                "benchmark.reference"), (path, mod)


def test_a_new_cell_is_new_files(test_bench):  # noqa: F811
    """The test-only cells sit in files of their own and load through the
    same functions."""
    for w in test_bench["workloads"]:
        spec = cells.config(test_bench, w["config"], REPO)
        assert spec["name"] == w["config"]
        traffic.load(w["traffic"], CELLS / "traffic")
    r = cells.reader("tiny_requests", [CELLS / "metrics", cells.METRICS])
    assert r(type("C", (), {"attempted": 3})()) == 3
