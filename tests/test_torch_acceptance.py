"""The port's ``acceptance`` CLI against ``scripts/acceptance.py``.

- ``TARGETS`` and ``recipe_config`` equal JAX's, field by field.
- ``verdict`` gives JAX's verdict: JAX's rules are the statements of
  ``scripts/acceptance.py``'s ``main`` from ``tgt = TARGETS[...]`` through
  the smoke-mode override, taken from its source with ``ast`` and run on
  the same inputs, so the comparison is with JAX's own code.  Inputs sit
  on both sides of every threshold (IS at the published IS less the
  slack, FID at the published FID plus the slack, FID and dFID at the
  dFID budget plus the slack), on the ``--ref-npz`` and the fp16
  routes, with and without fp16 metrics, and in smoke mode (finite and
  non-finite metrics).
- One ``--tiny --device cpu`` run (a module fixture, about 45 s here,
  most of it the two 2048-wide ``sqrtm`` of FID and sFID) writes JAX's
  artifacts (``best_s/mat_qkv_best_s_fp4.npz``, ``figs_fp4.npz``,
  ``figs_fp16.npz``, ``features_fp4.npz``, ``calib/CAPTURE_COMPLETE``)
  and ``ACCEPTANCE.json`` with JAX's keys; a second invocation on the same
  ``--out`` resumes every stage (capture, GALT, generation and feature
  extraction are replaced by functions that raise; the metrics by the
  first run's, to keep the file cheap).  A partial calibration store
  (no ``CAPTURE_COMPLETE``) is wiped and captured again.
"""
import argparse
import ast
import dataclasses
import importlib.util
import json
import math
import os
import time
from pathlib import Path

import numpy as np
import pytest

from fpqvar_tpu_torch.config import var_tiny
from fpqvar_tpu_torch.models import build_vae_var
from fpqvar_tpu_torch.tools import acceptance as A
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
RECIPES = ("fp4", "fp4_kv6", "fp6", "fp6_kv6")


@pytest.fixture(scope="module")
def jax_acc():
    spec = importlib.util.spec_from_file_location(
        "jax_script_acceptance", ROOT / "scripts" / "acceptance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_verdict(jax_acc):
    """JAX's verdict statements (``main``'s stage 5) as a function of
    ``(args, metrics, fp16_metrics, smoke, n_expected, t0)``."""
    tree = ast.parse((ROOT / "scripts" / "acceptance.py").read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    body = main.body
    start = next(i for i, s in enumerate(body)
                 if isinstance(s, ast.Assign)
                 and ast.unparse(s.targets[0]) == "tgt")
    end = next(i for i, s in enumerate(body)
               if isinstance(s, ast.If)
               and ast.unparse(s.test) == "verdict['smoke_mode']")
    fn = ast.parse("def jax_verdict(args, metrics, fp16_metrics, smoke, "
                   "n_expected, t0):\n    pass").body[0]
    fn.body = body[start:end + 1] + [ast.parse("return verdict").body[0]]
    mod = ast.fix_missing_locations(ast.Module(body=[fn], type_ignores=[]))
    ns = {"TARGETS": jax_acc.TARGETS, "np": np, "time": time}
    exec(compile(mod, "scripts/acceptance.py", "exec"), ns)
    return ns["jax_verdict"]


def test_targets_and_recipes_match_jax(jax_acc):
    assert A.TARGETS == jax_acc.TARGETS
    for name in RECIPES:
        assert dataclasses.asdict(A.recipe_config(name)) == \
            dataclasses.asdict(jax_acc.recipe_config(name)), name
    assert A.parse_args(["--out", "x"]).recipe == "fp4"
    with pytest.raises(SystemExit):
        A.parse_args(["--out", "x", "--recipe", "fp16"])


def _metric_cases(recipe, fid_slack, is_slack):
    """Metric dicts on both sides of each threshold of ``recipe``."""
    tgt, f16 = A.TARGETS[recipe], A.TARGETS["fp16"]
    budget = tgt["fid"] - f16["fid"]
    is_edge = tgt["is"] * (1 - is_slack)
    base = {"inception_score": is_edge + 1.0, "fid": 0.1, "sfid": 1.0,
            "precision": 0.7, "recall": 0.6}
    cases = []
    for d in (-1e-3, 1e-3):
        cases.append({**base, "inception_score": is_edge + d})
        cases.append({**base, "fid": tgt["fid"] + fid_slack + d})
        cases.append({**base, "fid": budget + fid_slack + d})
    return cases, budget


@pytest.mark.parametrize("recipe", RECIPES)
def test_verdict_matches_jax(recipe, jax_verdict):
    fid_slack, is_slack = 0.5, 0.05
    cases, budget = _metric_cases(recipe, fid_slack, is_slack)
    fp16_sets = [None]
    for d in (-1e-3, 1e-3):
        # the quantized set's dFID to these fp16 metrics sits at the budget
        fp16_sets.append(lambda m, d=d: {
            **m, "fid": m["fid"] - (budget + fid_slack + d),
            "inception_score": m["inception_score"] + 3.0})
    seen = set()
    for metrics in cases:
        for make16 in fp16_sets:
            fp16 = make16(metrics) if make16 else None
            for ref_npz in (None, "ref.npz"):
                for smoke in (False, True):
                    args = argparse.Namespace(
                        recipe=recipe, ref_npz=ref_npz, fid_slack=fid_slack,
                        is_slack=is_slack,
                        inception_ckpt="random" if smoke else "inc.pth")
                    want = jax_verdict(args, metrics, fp16, False, 8,
                                       time.time())
                    ours = A.verdict(recipe, metrics, fp16,
                                     ref_npz_given=ref_npz is not None,
                                     smoke=smoke, fid_slack=fid_slack,
                                     is_slack=is_slack, n_images=8,
                                     wall_s=0.0)
                    want.pop("wall_s")
                    ours.pop("wall_s")
                    assert ours == want, (metrics, fp16, ref_npz, smoke)
                    seen.add((tuple(sorted(want["checks"].items())),
                              want["pass"]))
    # both outcomes of every check were reached
    outcomes = {(k, v) for checks, _ in seen for k, v in checks}
    for key in ("is_within_published", "fid_within_published",
                "fid_vs_fp16_within_delta_budget", "dfid_within_budget"):
        assert {(key, True), (key, False)} <= outcomes, key
    assert {p for _, p in seen} == {True, False}


def test_verdict_smoke_mode_needs_finite_metrics(jax_verdict):
    metrics = {"inception_score": 1.0, "fid": math.nan, "sfid": 0.0,
               "precision": 1.0, "recall": 1.0}
    args = argparse.Namespace(recipe="fp4", ref_npz=None, fid_slack=0.5,
                              is_slack=0.05, inception_ckpt="random")
    want = jax_verdict(args, metrics, None, True, 8, time.time())
    ours = A.verdict("fp4", metrics, None, ref_npz_given=False, smoke=True,
                     fid_slack=0.5, is_slack=0.05, n_images=8, wall_s=0.0)
    assert ours["checks"] == want["checks"] == {
        "pipeline_finite_metrics": False}
    assert ours["pass"] is want["pass"] is False


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("acceptance") / "acc"
    verdict = A.main(["--tiny", "--device", "cpu", "--out", str(out)])
    return out, verdict


def test_tiny_run_writes_jax_artifacts(tiny_run, jax_verdict):
    out, verdict = tiny_run
    for rel in ("best_s/mat_qkv_best_s_fp4.npz", "best_s/fc1_best_s_fp4.npz",
                "calib/CAPTURE_COMPLETE", "figs_fp4.npz", "figs_fp16.npz",
                "features_fp4.npz", "ACCEPTANCE.json"):
        assert (out / rel).exists(), rel
    cfg = var_tiny()
    with np.load(out / "figs_fp4.npz") as f:
        assert f["arr_0"].shape == (8, 6, 6, 3)
    with np.load(out / "best_s/fc1_best_s_fp4.npz") as f:
        assert f["best_s"].shape == (cfg.depth, cfg.width)
    with open(out / "ACCEPTANCE.json") as f:
        doc = json.load(f)
    args = argparse.Namespace(recipe="fp4", ref_npz=None, fid_slack=0.5,
                              is_slack=0.05, inception_ckpt="random")
    jax_keys = list(jax_verdict(args, verdict["metrics"], None, True, 8,
                                time.time()))
    assert list(doc) == jax_keys
    assert doc == json.loads(json.dumps(verdict))
    assert doc["pass"] and doc["smoke_mode"] and doc["n_images"] == 8
    assert set(doc["metrics"]) == {"inception_score", "fid", "sfid",
                                   "precision", "recall"}


def test_tiny_run_resumes_every_stage(tiny_run, monkeypatch, capsys):
    out, verdict = tiny_run
    from fpqvar_tpu_torch.eval import inception, metrics, pipeline
    from fpqvar_tpu_torch.quantize import calibration, galt

    def refuse(*a, **k):
        raise AssertionError("a stage ran again on a complete --out")

    for mod, name in ((calibration, "capture_generation"),
                      (galt, "train_galt"), (pipeline, "generate_eval_set"),
                      (inception, "extract_features_batched")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(metrics, "evaluate_all",
                        lambda *a, **k: dict(verdict["metrics"]))
    capsys.readouterr()
    again = A.main(["--tiny", "--device", "cpu", "--out", str(out)])
    said = capsys.readouterr().out
    for stage in ("GALT vectors found", "fp4: packed npz exists",
                  "fp16: packed npz exists"):
        assert stage in said, stage
    assert again["pass"] and again["metrics"] == verdict["metrics"]


def test_partial_capture_is_captured_again(tmp_path, monkeypatch):
    """A calibration store without ``CAPTURE_COMPLETE`` (a crashed run) is
    wiped and captured again, then GALT trains on it."""
    out = tmp_path / "acc"
    calib = out / "calib"
    calib.mkdir(parents=True)
    (calib / "fc1_block0_step0.npz").write_bytes(b"partial")
    args = A.parse_args(["--out", str(out), "--device", "cpu"])
    args.calib_classes, args.galt_epochs = 2, 1
    cfg = var_tiny()
    vae_p, var_p = build_vae_var(0, cfg, "cpu")
    galt = A._calibrate_and_train_galt(args, cfg, A.recipe_config("fp4"),
                                       var_p, vae_p, lambda msg: None)
    assert (calib / "CAPTURE_COMPLETE").read_text() == "classes=2\n"
    with np.load(calib / "fc1_block0_step0.npz") as f:
        assert f["x"].shape[0] == 4              # 2 labels, CFG doubled
    assert [g.shape for g in galt] == [(cfg.depth, cfg.width)] * 2
    assert sorted(os.listdir(out / "best_s")) == [
        "fc1_best_s_fp4.npz", "mat_qkv_best_s_fp4.npz"]
