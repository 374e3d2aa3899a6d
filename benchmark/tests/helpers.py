"""Shared helpers and fixtures of the benchmark's CPU tests: the test-only cells
(``benchmark/tests/cells/``), which sit in files of their own."""
from pathlib import Path

import pytest
import torch

CELLS = Path(__file__).resolve().parent / "cells"
REPO = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="session")
def test_bench():
    from benchmark import cells

    return cells.load_benchmark(CELLS / "BENCHMARK.json")


def run_cell(bench, cell, seed=2 ** 31 + 7, seconds=1.0, trace=False,
             control=False):
    import time

    from benchmark.run import run

    return run(bench, cell, seed, seconds, trace, "cpu", time.time(),
               root=REPO, traffic_dir=CELLS / "traffic",
               metrics_dir=CELLS / "metrics", control=control)
