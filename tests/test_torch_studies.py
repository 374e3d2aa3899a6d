"""The studies' modules of the port against the JAX package: outlier
planting, the baseline quantizer zoo, the quality ladder's pieces, and the
``baseline_study`` and ``quality_ladder`` CLIs.

- ``plant_activation_outliers`` does JAX's float32 arithmetic op for op
  (separate multiplies and adds), so the planted trees are bit-equal.  The
  planted model computes the same function up to the rounding the rewrite
  adds: each touched weight is rounded at most twice (a scale and a
  divide), so the teacher-forcing logits of the unquantized model may move
  by at most ``PLANT_ULPS`` times their response to a one-ulp change of
  those same weights, measured in the test.
- ``du_quantizer`` within a relative 1e-6 of JAX's (``round`` of a
  quotient that differs in its last bit could flip a level, but none does
  at these inputs), ``flint_quant`` bit-equal; the clipping sweep, the
  rotation-aware sweep (block and full Hadamard) and
  ``compare_baselines`` with JAX's keys, values within a relative 1e-5
  (means of float32 squares summed in another order).
- The quality ladder's synthetic images are JAX's (numpy), its stages
  JAX's recipes.  A tiny ladder run takes about 100 s on this CPU (each
  FID's ``sqrtm`` of a 2048 x 2048 product, and Inception at 299 px), so
  it runs on the card in ``chip_smoke.py`` phase 14 (e) instead.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import QuantConfig as JQuantConfig
from fpqvar_tpu.config import fpqvar_w4a4 as jax_w4a4
from fpqvar_tpu.config import fpqvar_w6a6 as jax_w6a6
from fpqvar_tpu.quantize import baselines as JB
from fpqvar_tpu.quantize import outliers as JO

from fpqvar_tpu_torch.config import var_tiny
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.quantize import baselines as B
from fpqvar_tpu_torch.quantize import outliers as O
from fpqvar_tpu_torch.tools import baseline_study, calibrate, quality_ladder
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_generate import _jax_float_params
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
#: roundings the planting adds to a touched weight (module docstring)
PLANT_ULPS = 2
TOUCHED = (("ada_lin", "w"), ("ada_lin", "b"), ("mat_qkv_w",), ("fc1_w",))


# ---------------------------------------------------------------------------
# Outlier planting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_hot,scale", [(1, 16.0), (24, 64.0)])
def test_outlier_scale_vector_matches_jax(num_hot, scale):
    ours = O.outlier_scale_vector(128, num_hot, scale, seed=13)
    np.testing.assert_array_equal(
        ours, JO.outlier_scale_vector(128, num_hot, scale, seed=13))
    assert ours.dtype == np.float32 and ours.max() == np.float32(scale)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def planted():
    jcfg, jp = _jax_float_params(128)
    cfg = dataclasses.replace(var_tiny(), embed_dim=128, num_heads=2)
    s = O.outlier_scale_vector(128, 24, 64.0, seed=13)
    jplanted, _ = JO.plant_activation_outliers(
        jax.tree_util.tree_map(np.asarray, jp), jcfg, s)
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ours, s_out = O.plant_activation_outliers(tp, cfg, s)
    np.testing.assert_array_equal(s_out, s)
    return cfg, tp, ours, jplanted


def test_plant_activation_outliers_bit_equal(planted):
    cfg, tp, ours, jplanted = planted
    for path in TOUCHED:
        o = _leaf(ours["blocks"], path)
        assert o.dtype == torch.float32, path
        np.testing.assert_array_equal(
            o.numpy(), np.asarray(_leaf(jplanted["blocks"], path)),
            err_msg=str(path))
    # the caller's tree is left as it was, the rest shared
    assert ours["blocks"]["proj_w"] is tp["blocks"]["proj_w"]
    assert not torch.equal(ours["blocks"]["fc1_w"], tp["blocks"]["fc1_w"])
    with pytest.raises(ValueError, match="non-shared"):
        O.plant_activation_outliers(
            {"blocks": {"ada_gss": None}}, cfg, np.ones(128, np.float32))


def _logits(cfg, params):
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(
        (2, cfg.L - cfg.first_l, cfg.vae.z_channels)).astype(np.float32))
    with torch.no_grad():
        return V.var_forward(params, cfg, None, torch.tensor([3, 5]), x)


def test_planted_model_keeps_its_function(planted):
    """Unquantized teacher-forcing logits of the planted model against the
    unplanted one's, within PLANT_ULPS times the logits' response to a
    one-ulp change (random signs) of every touched weight."""
    cfg, tp, ours, _ = planted
    base = _logits(cfg, tp)
    moved = _logits(cfg, ours)
    rng = np.random.default_rng(10)
    bumped = dict(tp)
    bumped["blocks"] = dict(tp["blocks"])
    bumped["blocks"]["ada_lin"] = dict(tp["blocks"]["ada_lin"])
    for path in TOUCHED:
        t = _leaf(tp["blocks"], path)
        to = torch.where(torch.from_numpy(rng.random(t.shape) < 0.5),
                         torch.full_like(t, np.inf),
                         torch.full_like(t, -np.inf))
        holder = bumped["blocks"]
        for k in path[:-1]:
            holder = holder[k]
        holder[path[-1]] = torch.nextafter(t, to)
    response = float((_logits(cfg, bumped) - base).abs().max())
    diff = float((moved - base).abs().max())
    assert response > 0
    assert diff <= PLANT_ULPS * response, (diff, response)


# ---------------------------------------------------------------------------
# Baselines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def acts():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    x[:, [5, 77, 200]] *= 12.0               # a few outlier channels
    w = (rng.standard_normal((96, 256)) * 0.05).astype(np.float32)
    return x, w


@pytest.mark.parametrize("gran,bits", [("per_group", 4), ("per_token", 4),
                                       ("per_group", 6)])
def test_du_quantizer_matches_jax(acts, gran, bits):
    x = acts[0]
    ours = B.du_quantizer(torch.from_numpy(x), bits, granularity=gran).numpy()
    theirs = np.asarray(JB.du_quantizer(x, bits, granularity=gran))
    np.testing.assert_allclose(ours, theirs, rtol=0,
                               atol=1e-6 * np.abs(theirs).max())


@pytest.mark.parametrize("gran", ["per_token", "per_group"])
def test_flint_quant_bit_equal(acts, gran):
    x = acts[0]
    ours = B.flint_quant(torch.from_numpy(x), granularity=gran).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(JB.flint_quant(x, granularity=gran)))


def _close_tables(ours, theirs, rtol=1e-5):
    assert list(ours) == list(theirs)
    for k in theirs:
        if isinstance(theirs[k], dict):
            _close_tables(ours[k], theirs[k], rtol)
        else:
            assert ours[k] == pytest.approx(theirs[k], rel=rtol), k


def test_clipping_sweep_and_compare_baselines_match_jax(acts):
    x, w = acts
    _close_tables(B.clipping_strength_sweep(x, w, device="cpu"),
                  JB.clipping_strength_sweep(x, w))
    for bits in (4, 6):
        _close_tables(B.compare_baselines(x, n_bits=bits, device="cpu"),
                      JB.compare_baselines(x, n_bits=bits))


@pytest.mark.parametrize("block", [True, False], ids=["block", "full"])
def test_rotation_aware_sweep_matches_jax(acts, block):
    x, w = acts
    _close_tables(B.rotation_aware_sweep(x, w, block_rotate=block,
                                         device="cpu"),
                  JB.rotation_aware_sweep(x, w, block_rotate=block))


def test_baseline_study_cli(tmp_path):
    """A tiny store from the port's calibrate CLI; the study's JSON has
    JAX's schema, and each block's tables are JAX's functions' on the
    same activations and weights."""
    store = str(tmp_path / "calib")
    calibrate.main(["--tiny", "--device", "cpu", "--num-classes", "2",
                    "--batch", "2", "--out", store])
    out = str(tmp_path / "study.json")
    baseline_study.main(["--tiny", "--device", "cpu", "--calib", store,
                         "--kind", "fc1", "--max-samples", "64",
                         "--out", out])
    with open(out) as f:
        report = json.load(f)
    assert [e["block_idx"] for e in report] == [0, 1]
    from fpqvar_tpu_torch.models.var import init_var_params
    from fpqvar_tpu_torch.quantize.calibration import CalibrationStore

    w = init_var_params(var_tiny(), seed=0, device="cpu")["blocks"][
        "fc1_w"].numpy()
    cs, rng = CalibrationStore(store), np.random.default_rng(0)
    for entry in report:
        blk = entry["block_idx"]
        x = np.concatenate([cs.load("fc1", blk, s).reshape(-1, 128)
                            for s in range(cs.steps("fc1", blk))])
        if x.shape[0] > 64:
            x = x[rng.choice(x.shape[0], 64, replace=False)]
        assert list(entry) == ["block_idx", "act_absmax",
                               "reconstruction_mse",
                               "rotation_aware_matmul_mse"]
        assert entry["act_absmax"]["max"] == pytest.approx(
            float(np.abs(x).max()))
        _close_tables(entry["reconstruction_mse"], JB.compare_baselines(x))
        _close_tables(entry["rotation_aware_matmul_mse"],
                      JB.rotation_aware_sweep(x, w[blk]))


# ---------------------------------------------------------------------------
# The quality ladder
# ---------------------------------------------------------------------------

def test_ladder_synthetic_images_match_jax():
    import quality_ladder as jax_ladder

    for key, n in ((11, 20), (99, 7)):
        ours = quality_ladder.synth_images(key, n, 8, 16)
        theirs = jax_ladder.synth_images(key, n, 8, 16)
        for o, t in zip(ours, theirs):
            np.testing.assert_array_equal(o, t)


def _jax_stage_names():
    """The keys of the ``stages`` dict in JAX's ``main``."""
    tree = ast.parse(open(os.path.join(REPO, "scripts",
                                       "quality_ladder.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and getattr(node.targets[0], "id", None) == "stages"):
            return [k.value for k in node.value.keys]
    raise AssertionError("no stages dict in scripts/quality_ladder.py")


def test_ladder_stages_are_jax_recipes():
    galt = (np.ones((5, 256), np.float32),) * 2
    ours = quality_ladder._stages(galt)
    assert list(ours) == _jax_stage_names() == list(
        quality_ladder.STAGE_NAMES)
    fp4 = jax_w4a4()
    theirs = {
        "bf16": JQuantConfig(), "bf16_rep": JQuantConfig(),
        "fp4_naive": fp4.replace(rotate=False, block_rotate=False,
                                 transform=False, fc2_format="fp_e2"),
        "fp4_rot": fp4.replace(transform=False, fc2_format="fp_e2"),
        "fp4_galt": fp4.replace(fc2_format="fp_e2"), "fp4_full": fp4,
        "fp6_full": jax_w6a6(),
        "fp4_pertensor": fp4.replace(
            rotate=False, block_rotate=False, transform=False,
            weight_quant="per_tensor", act_quant="per_tensor",
            fc2_format="fp_e2"),
        "int4_rtn": JQuantConfig(
            enabled=True, int_quant=True, w_bit=4, a_bit=4,
            weight_quant="per_channel", act_quant="per_token",
            act_sym=True)}
    for name, (q, g) in ours.items():
        mine = dataclasses.asdict(q)
        ref = dataclasses.asdict(theirs[name])
        assert {k: mine[k] for k in ref if k in mine} == {
            k: ref[k] for k in ref if k in mine}, name
        assert (g is galt) == (name in ("fp4_galt", "fp4_full",
                                        "fp6_full")), name


def test_ladder_cli_flags():
    """JAX's flags and defaults (the port adds ``--study-key``,
    ``--inception-seeds``, ``--vae-params`` and ``--device``, default
    ``cuda``; ``--out`` names the port's own study file)."""
    res = subprocess.run(
        [sys.executable, "-m", "fpqvar_tpu_torch.tools.quality_ladder",
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    jres = subprocess.run(
        [sys.executable, os.path.join("scripts", "quality_ladder.py"),
         "--help"], cwd=REPO, capture_output=True, text=True, timeout=120,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    flags = {w.split("=")[0].rstrip(",") for w in res.stdout.split()
             if w.startswith("--")}
    jflags = {w.split("=")[0].rstrip(",") for w in jres.stdout.split()
              if w.startswith("--")}
    assert flags - jflags == {"--study-key", "--inception-seeds",
                              "--vae-params", "--device"}
    assert jflags <= flags
    args = quality_ladder.parse_args([])
    assert (args.depth, args.width, args.classes, args.train_n, args.steps,
            args.batch, args.eval_n, args.galt_epochs, args.plant_outliers,
            args.outlier_scale, args.plant_when, args.device) == (
        5, 256, 8, 2048, 700, 64, 256, 25, 16, 32.0, "post", "cuda")
    assert (args.out, args.inception_seeds, args.vae_params) == (
        "STUDY_quality_ladder_torch.json", "42", None)
