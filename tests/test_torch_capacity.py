"""The port's ``tools/capacity_study.py`` against ``scripts/capacity_study.py``.

- The search: JAX's ``find_max_batch`` and the port's, each fed the same
  scripted probe outcomes through its own module's ``probe``
  (monkeypatched), probe the same batches in the same order and return
  equal curves, or raise alike: every batch fits up to the cap; an OOM at
  32 with the bisection's 24 fitting; the same with 24 out of memory; an
  OOM at the starting batch; a failure that is not an OOM; a timeout.
  Both ``main``s print equal JSON lines (per mode and the summary), and
  both pick the same modes and first batch for each preset.
- The flags: the port's defaults equal JAX's (read from JAX's parser).
- The probe's classification: a child whose errors hold PyTorch's
  out-of-memory text, or whose output holds ``OOM_LINE``, is an OOM, as
  JAX's ``probe`` takes the same text; one holding "an illegal memory
  access" is not, and the study raises.  The child itself prints
  ``OOM_LINE`` and exits 3 on ``torch.cuda.OutOfMemoryError``.
- Static bytes: the port's weights and KV cache of 2 * batch rows, counted
  from the real tensors, equal ``bench.py``'s count of JAX's tree and
  cache under the same recipe.
- One real child (``--preset tiny --device cpu``, ``int8``, batch 2, one
  round): its line parses, its rate is above 0, its images are finite,
  and its static bytes are the tree's and the cache's tensor bytes.
"""
import argparse
import importlib.util
import io
import json
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import bench_recipes as jax_bench_recipes
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models.var import init_kv_cache as jax_init_kv_cache
from fpqvar_tpu.quantize.recipe import synth_device_params as jax_synth
from fpqvar_tpu.quantize.runtime import build_runtime as jax_runtime

from fpqvar_tpu_torch.config import bench_recipes, var_tiny
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.quantize.recipe import synth_device_params
from fpqvar_tpu_torch.tools import capacity_study as CS
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent

#: PyTorch's out-of-memory error as a child prints it
TORCH_OOM = ("torch.OutOfMemoryError: CUDA out of memory. Tried to allocate "
             "20.00 GiB. GPU 0 has a total capacity of 79.19 GiB of which "
             "3.12 GiB is free.")
ILLEGAL = ("RuntimeError: CUDA error: an illegal memory access was "
           "encountered\nCUDA kernel errors might be asynchronously reported "
           "at some other API call")


@pytest.fixture(scope="module")
def jax_cs():
    spec = importlib.util.spec_from_file_location(
        "jax_capacity_study", ROOT / "scripts" / "capacity_study.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ips(mode: str, batch: int) -> float:
    """A rate that rises with the batch and flattens (mode-dependent)."""
    return (3.0 + len(mode)) * batch / (1.0 + batch / 24.0) + 0.1234567


#: name -> {mode: {batch: outcome}}; a batch not listed fits
SCENARIOS = {
    "fits_to_cap": {},
    "oom_at_32_mid_fits": {m: {32: "oom", 64: "oom"} for m in
                           ("bf16", "int8chs", "packed")},
    "oom_at_32_mid_oom": {m: {24: "oom", 32: "oom", 64: "oom"} for m in
                          ("bf16", "int8chs", "packed")},
    "mixed_walls": {"bf16": {16: "oom", 32: "oom"},
                    "int8chs": {64: "oom"}, "packed": {}},
    "oom_at_start": {"int8chs": {8: "oom"}},
    "not_oom": {"packed": {16: "fail"}},
    "timeout": {"int8chs": {32: "timeout"}},
    "bisect_fails_not_oom": {"bf16": {32: "oom", 24: "fail"}},
}


def _outcome(scenario: str, mode: str, batch: int, port: bool) -> dict:
    kind = SCENARIOS[scenario].get(mode, {}).get(batch, "fit")
    if kind == "fit":
        r = {"ok": True, "ips": _ips(mode, batch), "static": ""}
        return {**r, "record": {"batch": batch}} if port else r
    if kind == "oom":
        return {"ok": False, "oom": True, "err": TORCH_OOM}
    if kind == "timeout":
        return {"ok": False, "oom": False, "err": "probe timeout"}
    return {"ok": False, "oom": False, "err": ILLEGAL}


def _stub(monkeypatch, mod, scenario: str, port: bool) -> list:
    calls = []

    def probe(preset, mode, batch, rounds, timeout, *rest):
        calls.append((preset, mode, batch, rounds, timeout))
        return _outcome(scenario, mode, batch, port)

    monkeypatch.setattr(mod, "probe", probe)
    return calls


def _run(fn):
    """(stdout lines, the exception or None) of ``fn()``."""
    buf = io.StringIO()
    err = None
    with redirect_stdout(buf):
        try:
            fn()
        except RuntimeError as e:
            err = e
    return buf.getvalue().splitlines(), err


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("mode", ["bf16", "int8chs", "packed"])
def test_find_max_batch_matches_jax(jax_cs, monkeypatch, scenario, mode):
    jcalls = _stub(monkeypatch, jax_cs, scenario, port=False)
    pcalls = _stub(monkeypatch, CS, scenario, port=True)
    args = ("d30", mode, 8, 64, 4, 3600)
    got, records = {}, {}
    jout, jerr = _run(lambda: got.update(
        jax=jax_cs.find_max_batch(*args)))
    pout, perr = _run(lambda: got.update(port=CS.find_max_batch(
        *args, device="cuda", records=records)))
    assert pcalls == jcalls
    assert (jerr is None) == (perr is None)
    if jerr is not None:
        assert str(perr) == str(jerr)
        return
    assert got["port"] == got["jax"]
    # every fitting probe's record is kept, every other probe's error
    for b in got["jax"]:
        assert records[b] == {"batch": b}
    assert {b for b, r in records.items() if "err" in r} == {
        c[2] for c in jcalls} - set(got["jax"])


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_main_prints_jax_lines(jax_cs, monkeypatch, scenario):
    argv = ["--preset", "d30", "--modes", "bf16,int8chs,packed"]
    jcalls = _stub(monkeypatch, jax_cs, scenario, port=False)
    pcalls = _stub(monkeypatch, CS, scenario, port=True)
    monkeypatch.setattr(sys, "argv", ["capacity_study.py"] + argv)
    jout, jerr = _run(jax_cs.main)
    ret = {}
    pout, perr = _run(lambda: ret.update(out=CS.main(argv)))
    assert pcalls == jcalls
    assert pout == jout
    assert all(json.loads(l) for l in pout)
    assert (jerr is None) == (perr is None)
    if jerr is not None:
        assert str(perr) == str(jerr)
        return
    lines = [json.loads(l) for l in pout]
    assert ret["out"]["modes"] == {l.pop("mode"): l for l in lines[:3]}
    assert ret["out"]["summary"] == lines[3]


@pytest.mark.parametrize("preset", ["tiny", "d16", "d30", "d36"])
def test_default_modes_and_start_match_jax(jax_cs, monkeypatch, preset):
    """One probe a default mode, at the preset's first batch (the cap)."""
    argv = ["--preset", preset, "--cap", str(CS.START[preset])]
    jcalls = _stub(monkeypatch, jax_cs, "fits_to_cap", port=False)
    pcalls = _stub(monkeypatch, CS, "fits_to_cap", port=True)
    monkeypatch.setattr(sys, "argv", ["capacity_study.py"] + argv)
    jout, jerr = _run(jax_cs.main)
    pout, perr = _run(lambda: CS.main(argv))
    assert pcalls == jcalls and pout == jout and jerr is perr is None
    modes = [c[1] for c in pcalls]
    assert len(modes) in (2, 3) and set(modes) <= set(bench_recipes())
    assert {c[2] for c in pcalls} == {CS.START[preset]}


def test_flag_defaults_match_jax(jax_cs, monkeypatch):
    class Stop(Exception):
        pass

    seen = {}
    parse = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        seen.update(vars(parse(self, *a, **kw)))
        raise Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    monkeypatch.setattr(sys, "argv", ["capacity_study.py"])
    with pytest.raises(Stop):
        jax_cs.main()
    monkeypatch.undo()
    ours = vars(CS.parse_args([]))
    assert {k: ours[k] for k in seen} == seen
    assert ours["device"] == "cuda" and ours["probe"] is False
    assert CS.OOM_MARKERS == jax_cs.OOM_MARKERS


def _fake_run(monkeypatch, rc: int, stdout: str, stderr: str):
    def run(cmd, **kw):
        return subprocess.CompletedProcess(cmd, rc, stdout, stderr)

    monkeypatch.setattr(subprocess, "run", run)


@pytest.mark.parametrize("rc,stdout,stderr,oom", [
    (1, "", "Traceback (most recent call last):\n" + TORCH_OOM, True),
    (3, CS.OOM_LINE + "\n", "CUDA out of memory. Tried to allocate", True),
    (3, CS.OOM_LINE + "\n", "", True),
    (1, "", "Traceback (most recent call last):\n" + ILLEGAL, False),
    (1, "", "AssertionError: non-finite images", False),
])
def test_probe_classifies_failures(jax_cs, monkeypatch, rc, stdout, stderr,
                                   oom):
    _fake_run(monkeypatch, rc, stdout, stderr)
    r = CS.probe("d36", "bf16", 64, 4, 60)
    assert r["ok"] is False and r["oom"] is oom
    if stderr:
        # JAX's probe reads the same errors alike
        assert jax_cs.probe("d36", "bf16", 64, 4, 60)["oom"] is oom
    if not oom:
        with pytest.raises(RuntimeError, match="failed \\(not OOM\\)"):
            CS.find_max_batch("d36", "bf16", 64, 64, 4, 60)


def test_probe_timeout_raises_like_jax(jax_cs, monkeypatch):
    def run(cmd, **kw):
        raise subprocess.TimeoutExpired(cmd, kw.get("timeout"))

    monkeypatch.setattr(subprocess, "run", run)
    assert CS.probe("d36", "bf16", 2, 4, 1) == jax_cs.probe(
        "d36", "bf16", 2, 4, 1) == {"ok": False, "oom": False,
                                    "err": "probe timeout"}
    with pytest.raises(RuntimeError, match="probe timeout"):
        CS.find_max_batch("d36", "bf16", 2, 64, 4, 1)


def test_probe_reads_the_child_line(monkeypatch):
    rec = {"ips": 12.5, "max_memory_allocated": 2**30,
           "max_memory_reserved": 2**31, "weight_bytes": 10,
           "cache_bytes": 20, "pool_bytes": None}
    _fake_run(monkeypatch, 0, "noise\n" + CS.PROBE_TAG + json.dumps(rec)
              + "\n", "")
    r = CS.probe("d16", "int8kv", 8, 4, 60)
    assert r["ok"] and r["ips"] == 12.5 and r["record"] == rec
    assert "peak allocated 1.00" in r["static"]


def test_child_reports_oom_on_a_line(monkeypatch, capsys):
    def oom(*a):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                          "allocate 1 GiB")

    monkeypatch.setattr(CS, "measure", oom)
    args = CS.parse_args(["--probe", "--preset", "d36", "--mode", "bf16",
                          "--batch", "64"])
    assert CS.probe_main(args) == 3
    out = capsys.readouterr()
    assert CS.OOM_LINE in out.out.splitlines()
    assert "out of memory" in out.err


def _leaf_bytes(tree) -> int:
    """Bytes of the tensors of a tree, counted apart from the tool."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_leaf_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_leaf_bytes(v) for v in tree)
    if hasattr(tree, "codes") and hasattr(tree, "scales"):
        return _leaf_bytes(tree.codes) + _leaf_bytes(tree.scales)
    return 0


def _galt(cfg):
    return tuple(np.ones((cfg.depth, cfg.width), np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("mode", ["bf16", "int8", "int8chs", "packed",
                                  "int8kv"])
def test_static_bytes_equal_bench_count_of_jax(mode):
    """``bench.py``'s ``static_hbm_gb`` arithmetic (unrounded) on JAX's
    tree and cache against the port's counts at ``var_tiny``, batch 2."""
    jcfg, jq = jax_var_tiny(), jax_bench_recipes()[mode]
    jp = jax_synth(jcfg, jq, jax.random.PRNGKey(0), galt=_galt(jcfg))
    jw = sum(a.size * a.dtype.itemsize
             for a in jax.tree_util.tree_leaves(jp) if hasattr(a, "dtype"))
    qrt = jax_runtime(jq, jcfg.depth, jcfg.width)
    jc = jax.eval_shape(lambda: jax_init_kv_cache(jcfg, 4,
                                                  kv_codec=qrt.kv_codec))
    jcb = sum(a.size * jnp.dtype(a.dtype).itemsize
              for a in jax.tree_util.tree_leaves(jc))
    cfg, q = var_tiny(), bench_recipes()[mode]
    p = synth_device_params(cfg, q, seed=0, galt=_galt(cfg), device="cpu")
    cache = VARGenerator(cfg, q, device="cpu").init_cache(2)
    assert CS.tensor_bytes(p) == _leaf_bytes(p) == jw
    assert CS.tensor_bytes(cache) == _leaf_bytes(cache) == jcb


def test_one_real_child_on_the_cpu():
    r = CS.probe("tiny", "int8", 2, 1, 600, "cpu")
    assert r["ok"], r
    rec = r["record"]
    assert rec["ips"] > 0 and rec["ips"] == r["ips"]
    assert rec["images_finite"] and rec["image_shape"] == [2, 3, 6, 6]
    assert rec["batch"] == 2 and rec["rounds"] == 1
    assert len(rec["round_s"]) == 1
    cfg, q = var_tiny(), bench_recipes()["int8"]
    p = synth_device_params(cfg, q, seed=0, galt=_galt(cfg), device="cpu")
    cache = VARGenerator(cfg, q, device="cpu").init_cache(2)
    assert rec["weight_bytes"] == _leaf_bytes(p)
    assert rec["cache_bytes"] == _leaf_bytes(cache)
    assert rec["static_bytes"] == _leaf_bytes(p) + _leaf_bytes(cache)
    # the CPU has no device memory statistics and no graphs
    assert rec["max_memory_allocated"] is None and rec["pool_bytes"] is None
    # on CPU tensors every wrapper takes its plain version: no launches
    assert set(rec["warmup_launches"].values()) == {0}
    assert rec["capture_launches"] is None
