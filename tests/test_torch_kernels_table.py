"""The wiring of the port's CUDA sources into ``chip_smoke.py``, checked
here without a card.

``chip_smoke.py`` is read with ``ast`` (not imported): its tables
``KERNEL_SOURCES`` (what phase 2 builds), ``WGMMA_SOURCES`` (the GEMM
sources, whose SASS must hold a warpgroup MMA), ``QUANT_SOURCES`` (the
quantizers Q1-Q3, which run no GEMM), ``TRACE_SOURCES`` (the stage marker,
which computes nothing), ``ATTN_SOURCES`` (the attention A1, its products
on ``mma.sync``) and ``PORT_KERNELS`` (the profiler's
keys, parts of kernel names, by which phase 6 counts each kernel's
launches) are held against ``fpqvar_tpu_torch/csrc/``:

- every ``csrc/*.cu`` is built, and every name built has a source;
- every ``#include "...cuh"`` names a header of ``csrc/``, and every header
  is reached from some source, so no orphan header is left;
- every source is in exactly one of ``WGMMA_SOURCES``,
  ``QUANT_SOURCES``, ``TRACE_SOURCES`` and ``ATTN_SOURCES``; every GEMM
  source runs on ``wgmma`` (reaches ``wgmma_gemm.cuh``), every quantizer
  reaches ``grid_snap.cuh`` and no GEMM, the marker and the attention
  reach no header of either (the attention's SASS holds ``HMMA``), and
  the first slices' ``mma.sync`` tile loop ``int8_mma.cuh`` is gone;
- no profiler key is a part of another label's key, and each key is a
  part of exactly one kernel or epilogue name defined in ``csrc/``: itself
  (one kernel sharing another's wgmma instantiation must give its
  epilogue a name of its own, or the profiler counts the two as one).
"""
import ast
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "fpqvar_tpu_torch" / "csrc"
TABLES = ("KERNEL_SOURCES", "WGMMA_SOURCES", "QUANT_SOURCES",
          "TRACE_SOURCES", "ATTN_SOURCES", "K4_KERNELS", "PORT_KERNELS")
SOURCES = sorted(p.stem for p in CSRC.glob("*.cu"))
HEADERS = sorted(p.name for p in CSRC.glob("*.cuh"))
FILES = sorted(p.name for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))
INCLUDE = re.compile(r'^\s*#include\s+"([^"]+)"', re.M)


def _tables() -> dict:
    """The module-level tables of ``chip_smoke.py``, evaluated on their
    own (they are literals, ``PORT_KERNELS`` reading ``K4_KERNELS``)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    body = [node for node in tree.body if isinstance(node, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id in TABLES
                    for t in node.targets)]
    scope: dict = {}
    exec(compile(ast.Module(body=body, type_ignores=[]), "chip_smoke.py",
                 "exec"), {"__builtins__": {}}, scope)
    return scope


def _includes(name: str) -> list:
    return INCLUDE.findall((CSRC / name).read_text())


def _reached(source: str) -> set:
    """The headers that ``csrc/<source>.cu`` includes, directly or
    through other headers."""
    seen, todo = set(), _includes(f"{source}.cu")
    while todo:
        h = todo.pop()
        if h not in seen and (CSRC / h).exists():
            seen.add(h)
            todo.extend(_includes(h))
    return seen


def _defined_names() -> dict:
    """Every struct and ``*_kernel`` function defined in ``csrc/`` -> the
    files that define it."""
    names: dict = {}
    for f in FILES:
        text = (CSRC / f).read_text()
        for n in set(re.findall(r"\bstruct\s+(\w+)", text)
                     + re.findall(r"^(\w+_kernel)\s*\(", text, re.M)):
            names.setdefault(n, set()).add(f)
    return names


@pytest.mark.parametrize("stem", SOURCES)
def test_every_source_is_built(stem):
    assert stem in _tables()["KERNEL_SOURCES"]


def test_every_built_name_has_a_source():
    built = _tables()["KERNEL_SOURCES"]
    assert len(set(built)) == len(built)
    assert set(built) <= set(SOURCES)


@pytest.mark.parametrize("name", FILES)
def test_includes_name_headers_that_exist(name):
    missing = [h for h in _includes(name) if not (CSRC / h).exists()]
    assert not missing, f"{name} includes {missing}"


@pytest.mark.parametrize("header", HEADERS)
def test_no_orphan_header(header):
    users = [s for s in SOURCES if header in _reached(s)]
    assert users, f"no source includes {header}"


def test_every_source_but_the_probe_runs_on_wgmma():
    """Every GEMM source runs on ``wgmma``, the rate probe's K6 as well;
    every other source is a quantizer of ``QUANT_SOURCES`` (a group over
    the lanes it needs, on ``grid_snap.cuh``, no GEMM), the stage marker
    of ``TRACE_SOURCES`` (neither) or the attention of ``ATTN_SOURCES``
    (neither: its two products on ``mma.sync`` with the softmax between
    them in registers), and each source is in exactly one of the four
    tables."""
    wgmma = _tables()["WGMMA_SOURCES"]
    quant = _tables()["QUANT_SOURCES"]
    trace = _tables()["TRACE_SOURCES"]
    attn = _tables()["ATTN_SOURCES"]
    groups = [set(wgmma), set(quant), set(trace), set(attn)]
    assert sum(len(g) for g in groups) == len(set().union(*groups))
    assert set().union(*groups) == set(SOURCES)
    for src in list(trace) + list(attn):
        assert not {"wgmma_gemm.cuh", "grid_snap.cuh"} & _reached(src), src
    assert set(attn.values()) == {"HMMA"}
    assert set(wgmma.values()) <= {"HGMMA", "IGMMA"}
    assert wgmma["int8_probe_gemm"] == "IGMMA"
    for src in wgmma:
        assert "wgmma_gemm.cuh" in _reached(src), src
    assert sorted(quant.values()) == ["Q1", "Q2", "Q3"]
    for src in quant:
        assert "grid_snap.cuh" in _reached(src), src
        assert "wgmma_gemm.cuh" not in _reached(src), src
    assert not (CSRC / "int8_mma.cuh").exists()


def test_port_kernel_keys_are_no_part_of_another_labels_key():
    keys = [(label, k) for label, ks in _tables()["PORT_KERNELS"].items()
            for k in ks]
    clashes = [(a, ka, b, kb) for a, ka in keys for b, kb in keys
               if a != b and ka in kb]
    assert not clashes


@pytest.mark.parametrize("label", ["K1", "K2", "K3", "K4 (a)", "K4 (b)",
                                   "K5", "Q1", "Q2", "Q3", "A1"])
def test_port_kernel_key_names_one_kernel_or_epilogue(label):
    names = _defined_names()
    for key in _tables()["PORT_KERNELS"][label]:
        holders = sorted(n for n in names if key in n)
        assert holders == [key], f"{label} key {key!r} is in {holders}"
        assert len(names[key]) == 1, f"{key} defined in {names[key]}"
