"""The port's ``serve``, ``latency_breakdown`` and ``motivation_plots``
CLIs against their ``scripts/`` twins.

- ``serve``: a ``--tiny --demo N --device cpu`` run writes the file names
  JAX's ``tests/test_cli.py`` expects (``class{c}_img{seed}.png``) and
  prints ``served N requests``; the decoded PNGs equal ``to_uint8`` of a
  ``GenerationServer``'s images for the same ``(class, seed)`` on the
  CLI's own trees (``serve.load_trees``), under ``w4a16``, ``w4a4
  --no-transform --backend packed`` and ``w4a4 --backend int8`` with GALT
  vectors from ``--best-s-dir``; stdin's ``"<class_id> [seed]"`` lines.
- ``latency_breakdown``: a ``--preset tiny --modes bf16,int8 --rounds 1``
  run prints JAX's JSON keys and every stage key, the scale keys being
  JAX's ``scale{si}_pn{pn}`` names read from JAX's ``VARGenerator(...,
  fuse_steps=False).statics`` (constructed, not run); its stepwise pass
  gives images ``torch.equal`` to ``generate`` with ``fuse_steps=False``
  on the same generator.
- ``motivation_plots``: on one calibration store written by the port's
  ``CalibrationStore`` and one upstream-format state dict at ``--depth
  2`` (read by both converters), the ``mse`` curves (act and weight,
  ``--rotate``, ``--kind fc2``, ``--bits 6``), the ``clip`` curves and the
  ``dist`` MSEs within a relative 1e-5 of JAX's (means of float32 squares
  summed in another order); JAX's studies run in-process from
  ``scripts/motivation_plots.py`` (loaded with ``importlib``, no
  ``main()``).
"""
import argparse
import dataclasses
import importlib.util
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from fpqvar_tpu.config import GenerateConfig as JGenerateConfig
from fpqvar_tpu.config import QuantConfig as JQuantConfig
from fpqvar_tpu.config import VARConfig as JVARConfig
from fpqvar_tpu.config import bench_recipes as jax_bench_recipes
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import VARGenerator as JaxGenerator

from fpqvar_tpu_torch.config import GenerateConfig, bench_recipes, var_tiny
from fpqvar_tpu_torch.eval import imaging as Im
from fpqvar_tpu_torch.eval import png
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.models.vqvae import init_vqvae_params
from fpqvar_tpu_torch.quantize.calibration import CalibrationStore
from fpqvar_tpu_torch.quantize.recipe import synth_device_params, to_bf16
from fpqvar_tpu_torch.serving import GenerationServer
from fpqvar_tpu_torch.tools import latency_breakdown as LB
from fpqvar_tpu_torch.tools import motivation_plots as MP
from fpqvar_tpu_torch.tools import serve
from test_torch_checkpoint import _var_state_dict
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
MP_REL = 1e-5


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def _server_images(argv, requests, max_batch):
    """``to_uint8`` of a ``GenerationServer``'s images on the CLI's trees."""
    args = serve.parse_args(argv)
    cfg = var_tiny()
    var_p, vae_p = serve.load_trees(args, cfg, serve.recipe(args))
    srv = GenerationServer(VARGenerator(cfg, serve.recipe(args),
                                        GenerateConfig(), device="cpu"),
                           var_p, vae_p, max_batch=max_batch)
    try:
        futs = [srv.submit(c, s) for c, s in requests]
        return [Im.to_uint8(f.result()[None])[0] for f in futs]
    finally:
        srv.stop()


@pytest.mark.parametrize("flags", [
    ["--recipe", "w4a16"],
    ["--recipe", "w4a4", "--no-transform", "--backend", "packed"],
    ["--recipe", "w4a4", "--backend", "int8", "--best-s-dir", "BEST"],
], ids=["w4a16", "w4a4_packed", "w4a4_int8_galt"])
def test_serve_demo_writes_the_servers_images(flags, tmp_path, capsys):
    if "BEST" in flags:
        best = tmp_path / "best_s"
        best.mkdir()
        rng = np.random.default_rng(0)
        cfg = var_tiny()
        for kind in ("mat_qkv", "fc1"):
            np.savez_compressed(best / f"{kind}_best_s_fp4.npz", best_s=np.exp(
                0.1 * rng.standard_normal((cfg.depth, cfg.width))).astype(
                np.float32))
        flags = [str(best) if f == "BEST" else f for f in flags]
    out = tmp_path / "served"
    argv = ["--tiny", "--device", "cpu", "--demo", "3", "--max-batch", "2",
            "--out", str(out), *flags]
    st = serve.main(argv)
    assert "served 3 requests" in capsys.readouterr().out
    assert st["batches"] >= 2
    # scripts/serve.py's names: class (i % classes), seed i
    names = sorted(os.listdir(out))
    assert names == ["class0_img0.png", "class1_img1.png", "class2_img2.png"]
    want = _server_images(argv, [(0, 0), (1, 1), (2, 2)], max_batch=2)
    for i, img in enumerate(want):
        np.testing.assert_array_equal(
            png.read_png(str(out / f"class{i}_img{i}.png")), img)


def test_serve_reads_requests_from_stdin(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.stdin", io.StringIO("3 7\n\n5\n"))
    out = tmp_path / "served"
    serve.main(["--tiny", "--device", "cpu", "--max-batch", "2",
                "--out", str(out)])
    assert "served 2 requests" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["class3_img7.png", "class5_img0.png"]


def test_serve_recipe_flags_match_jax():
    """``--recipe`` / ``--no-transform`` / ``--backend`` give the
    ``QuantConfig`` that ``scripts/serve.py`` builds."""
    from fpqvar_tpu.config import (fpqvar_w4a4, fpqvar_w4a16, fpqvar_w6a6)

    jax_of = {"bf16": JQuantConfig, "w4a4": fpqvar_w4a4,
              "w4a16": fpqvar_w4a16, "w6a6": fpqvar_w6a6}
    for name, make in jax_of.items():
        for extra in ([], ["--no-transform"], ["--backend", "int8"]):
            ours = serve.recipe(serve.parse_args(
                ["--out", "x", "--recipe", name, *extra]))
            want = make()
            if "--no-transform" in extra and want.enabled:
                want = want.replace(transform=False)
            if "--backend" in extra and want.enabled:
                want = want.replace(backend="int8")
            assert dataclasses.asdict(ours) == dataclasses.asdict(want), (
                name, extra)
    with pytest.raises(SystemExit, match="best-s-dir"):
        serve.main(["--tiny", "--device", "cpu", "--recipe", "w4a4",
                    "--demo", "1", "--out", "unused"])


# ---------------------------------------------------------------------------
# latency_breakdown
# ---------------------------------------------------------------------------

JAX_LB_KEYS = ["preset", "batch", "rounds", "per_stage_ms",
               "stepwise_sum_ms", "fused_call_ms", "imgs_per_s_fused",
               "stage_ratio_vs_bf16"]


def test_latency_breakdown_tiny_prints_every_stage(capsys):
    out = LB.main(["--preset", "tiny", "--modes", "bf16,int8",
                   "--rounds", "1", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert set(JAX_LB_KEYS) <= set(out)
    assert dataclasses.asdict(LB.build_cfg("tiny")) == dataclasses.asdict(
        var_tiny())
    assert (dataclasses.asdict(jax_var_tiny())
            == dataclasses.asdict(JVARConfig(
                depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 3),
                vae=jax_var_tiny().vae)))
    jax_steps = JaxGenerator(jax_var_tiny(), jax_bench_recipes()["int8"],
                             JGenerateConfig(), fuse_steps=False).statics
    want = (["prepare"] + [f"scale{st.si}_pn{st.pn}" for st in jax_steps]
            + ["vqvae_decode"])
    for mode in ("bf16", "int8"):
        assert list(out["per_stage_ms"][mode]) == want
        assert out["stepwise_images_finite"][mode]
        assert len(out["launches_per_pass"][mode]) == 2
        assert out["stepwise_sum_ms"][mode] > 0
        assert out["fused_call_ms"][mode] > 0
    assert list(out["stage_ratio_vs_bf16"]) == ["int8"]
    assert set(out["stage_ratio_vs_bf16"]["int8"]) <= set(want)


@pytest.mark.parametrize("mode", ["bf16", "int8", "packed", "int8kv"])
def test_stepwise_pass_equals_eager_generate(mode):
    cfg = var_tiny()
    q = bench_recipes()[mode]
    galt = (tuple(np.ones((cfg.depth, cfg.width), np.float32)
                  for _ in range(2)) if q.transform else None)
    params = synth_device_params(cfg, q, seed=0, galt=galt, device="cpu")
    vae = to_bf16(init_vqvae_params(cfg.vae, seed=1, device="cpu"))
    eng = VARGenerator(cfg, q, GenerateConfig(), device="cpu",
                       fuse_steps=False)
    labels = torch.tensor([3, 5, 7])
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(11)
    g2.manual_seed(11)
    timer = LB.StageTimer(torch.device("cpu"))
    ours = LB.stepwise_pass(eng, params, vae, labels, g1, timer)
    want = eng.generate(params, vae, labels, g2)
    assert torch.equal(ours, want)
    assert [n for n, _, _ in timer.marks][0] == "prepare"
    assert all(v >= 0 for v in timer.seconds().values())


# ---------------------------------------------------------------------------
# motivation_plots
# ---------------------------------------------------------------------------

DEPTH = 2


@pytest.fixture(scope="module")
def jax_mp():
    return _load_script("motivation_plots")


@pytest.fixture(scope="module")
def study_inputs(tmp_path_factory):
    """A port-written calibration store (depth 2, two steps of 160 rows a
    block, heavy-tailed, every kind) and an upstream-format VAR state dict
    at depth 2 (width 128, 256 px)."""
    root = tmp_path_factory.mktemp("motivation")
    calib = root / "calib"
    store = CalibrationStore(str(calib))
    rng = np.random.default_rng(0)
    c = 128
    widths = {"mat_qkv": c, "proj": c, "fc1": c, "fc2": 4 * c}
    for rows in (96, 64):      # two capture runs, concatenated per step
        taps = [{k: (rng.standard_t(3, (DEPTH, rows // 16, 16, w))
                     * np.exp(rng.standard_normal(w))).astype(np.float32)
                 for k, w in widths.items()} for _ in range(2)]
        store.append_run(taps)
    jcfg = JVARConfig(depth=DEPTH)
    sd = {k: torch.from_numpy(v) for k, v in
          _var_state_dict(jcfg, seed=3).items()}
    ckpt = root / "var_d2.pth"
    torch.save(sd, ckpt)
    return str(calib), str(ckpt), root


def _ns(**kw):
    base = dict(depth=DEPTH, resolution=256, kind="mat_qkv", tensor="act",
                calib=None, bits=4, rotate=False, block=1, max_samples=128,
                out=None, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


def _close_curves(ours: dict, theirs: dict, what: str):
    assert list(ours) == list(theirs), what
    for name in theirs:
        a, b = np.asarray(ours[name]), np.asarray(theirs[name])
        rel = np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30))
        assert rel <= MP_REL, f"{what}: {name} differs by a relative {rel}"


@pytest.mark.parametrize("kw", [
    dict(tensor="act", kind="fc2"),
    dict(tensor="act", kind="fc2", rotate=True),
    dict(tensor="act", kind="mat_qkv", rotate=True),
    dict(tensor="act", kind="fc2", bits=6),
    dict(tensor="weight", kind="fc2"),
    dict(tensor="weight", kind="fc1", rotate=True, bits=6),
], ids=["act_fc2", "act_fc2_rotate", "act_qkv_rotate", "act_fc2_bits6",
        "weight_fc2", "weight_fc1_rotate_bits6"])
def test_mse_study_matches_jax(kw, jax_mp, study_inputs, tmp_path):
    calib, ckpt, _ = study_inputs
    ours = MP.mse_study(_ns(calib=calib, var_ckpt=ckpt,
                            out=str(tmp_path / "ours.json"), **kw))
    jax_mp.mse_study(_ns(calib=calib, var_ckpt=ckpt,
                         out=str(tmp_path / "jax.json"), **kw))
    with open(tmp_path / "jax.json") as f:
        theirs = json.load(f)
    with open(tmp_path / "ours.json") as f:
        assert json.load(f) == json.loads(json.dumps(ours))
    assert list(ours) == list(theirs)
    assert {k: ours[k] for k in ("kind", "tensor", "bits", "rotate")} == {
        k: theirs[k] for k in ("kind", "tensor", "bits", "rotate")}
    _close_curves(ours["curves"], theirs["curves"], f"mse {kw}")
    _close_curves({k: [v] for k, v in ours["means"].items()},
                  {k: [v] for k, v in theirs["means"].items()},
                  f"means {kw}")
    assert (tmp_path / "ours.png").exists()


def test_clip_study_matches_jax(jax_mp, study_inputs, tmp_path):
    calib, ckpt, _ = study_inputs
    args = dict(calib=calib, var_ckpt=ckpt, kind="fc2")
    ours = MP.clip_study(_ns(out=str(tmp_path / "ours.json"), **args))
    jax_mp.clip_study(_ns(out=str(tmp_path / "jax.json"), **args))
    with open(tmp_path / "jax.json") as f:
        theirs = json.load(f)
    assert list(ours) == list(theirs)
    assert ours["strengths"] == theirs["strengths"]
    assert ours["blocks_sampled"] == theirs["blocks_sampled"]
    _close_curves(ours["curves"], theirs["curves"], "clip")
    assert ours["best"] == theirs["best"]


def test_dist_study_matches_jax(jax_mp, study_inputs, tmp_path, capsys):
    _, ckpt, _ = study_inputs
    args = dict(var_ckpt=ckpt, kind="fc1", block=1)
    ours = MP.dist_study(_ns(out=str(tmp_path / "ours.png"), **args))
    capsys.readouterr()
    jax_mp.dist_study(_ns(out=str(tmp_path / "jax.png"), **args))
    theirs = json.loads(capsys.readouterr().out.splitlines()[0])
    assert list(ours) == list(theirs)
    _close_curves({k: [ours[k]] for k in ours if k.startswith("mse")},
                  {k: [theirs[k]] for k in theirs if k.startswith("mse")},
                  "dist")
    assert (tmp_path / "ours.png").exists()
    with open(tmp_path / "ours.json") as f:
        assert json.load(f) == ours


def test_motivation_plots_cli_flags(study_inputs, tmp_path):
    calib, ckpt, _ = study_inputs
    with pytest.raises(SystemExit):
        MP.parse_args(["--plot", "clip"])           # clip needs --calib
    out = MP.main(["--plot", "mse", "--tensor", "act", "--calib", calib,
                   "--depth", "2", "--var-ckpt", ckpt, "--kind", "fc2",
                   "--rotate", "--device", "cpu", "--max-samples", "64",
                   "--out", str(tmp_path / "m.json")])
    assert list(out["curves"]) == ["E1M2 / INT4", "E2M1", "E3M0", "AFPQ",
                                   "DFQ", "NegReverse"]
    assert all(len(v) == DEPTH for v in out["curves"].values())
