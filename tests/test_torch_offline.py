"""The offline pipeline of the port against the JAX package: the STEs,
calibration capture and its store, the format search, GALT training and
its artifacts, the whole chain to a generation, and the four CLIs.

Both packages start from JAX's ``var_tiny`` params at width 128
(``adaln_gamma_std=0.02``) and the VQVAE of ``test_torch_generate``,
carried over by the bridge; JAX's functions run as its own tests run
them (the STE and the search under ``jit``, GALT's jitted optax step).

- The STE forward is bit-equal to JAX's jitted STE (the quantizers are
  bit-equal, and both compute ``x + (q(x) - x)``), its gradient the
  identity.
- ``capture_generation`` at ``top_k=1``: the tokens of every scale
  identical and the taps within ``test_capture_taps_match_jax``'s 1e-5
  (float32 sums in another order); ``capture_condition`` within 1e-6.
- ``CalibrationStore``: the port reads a store JAX wrote and JAX one the
  port wrote, file for file, and a second run appends.
- The format search on the same store: the same formats, losses within a
  relative ``SEARCH_RTOL`` (a mean of float32 squares; the sums run in
  another order).
- ``quant_error`` and its gradient within ``QERR_RTOL`` of
  ``jax.value_and_grad``'s.
- GALT: ``torch.optim.AdamW`` decays ``p * (1 - lr wd)`` where optax adds
  ``lr wd p``, equal in exact arithmetic, and the float32 sums run in
  another order; ``s`` within ``GALT_S_ATOL`` after ``train_galt``'s
  epoch over the store, and after 3 epochs of one block within the larger
  of that and twice JAX's own response to a one-ulp change of the
  activations (the best loss likewise, relative).
- The chain capture -> GALT -> ``quantize_var_params(int8)`` -> generate
  gives JAX's chain's tokens at ``top_k=1``, both transforms given JAX's
  ``s`` so that GALT's float drift cannot hide a fault of the transform.
- The four CLIs run in a chain at ``--tiny --device cpu`` (in process;
  ``calibrate`` once as a subprocess), and ``convert_checkpoint`` turns a
  seeded upstream ``.pth`` into the converter's tree.
"""
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import sampling as JS
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.quantize import calibration as JCal
from fpqvar_tpu.quantize import galt as JG
from fpqvar_tpu.quantize import search as JSe
from fpqvar_tpu.quantize import ste as JSte
from fpqvar_tpu.quantize.runtime import build_runtime as jax_runtime
from fpqvar_tpu.ops.hadamard import block_hadamard_block

from fpqvar_tpu_torch.config import GenerateConfig, var_tiny
from fpqvar_tpu_torch.models import VARGenerator, init_vqvae_params
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.quantize import calibration as CAL
from fpqvar_tpu_torch.quantize import galt as G
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.quantize import search as S
from fpqvar_tpu_torch.quantize import ste as STE
from fpqvar_tpu_torch.quantize.runtime import build_runtime
from fpqvar_tpu_torch.tools import (convert_checkpoint, search_formats,
                                    train_galt)
from fpqvar_tpu_torch.utils import checkpoint as C
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_checkpoint import (_assert_port_equal, _var_state_dict,
                                   _vqvae_state_dict)
from test_torch_generate import (LABELS, JaxGenerateConfig, JaxGenerator,
                                 _jax_float_params, _jax_params, _jax_vae,
                                 _recipe, jax_quantize)
from test_torch_vqvae import _params as vqvae_params
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP1 = dict(top_k=1, top_p=0.0)
SEARCH_RTOL = 1e-4
QERR_RTOL = 1e-4
GALT_S_ATOL = 1e-4
GALT_LOSS_RTOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def model():
    jcfg, jp = _jax_float_params(128)
    jvae = _jax_vae()
    return SimpleNamespace(jcfg=jcfg, jp=jp, jvae=jvae, cfg=var_tiny(),
                           tp=to_torch(_np_tree(jp), "cpu"),
                           tvae=to_torch(_np_tree(jvae), "cpu"))


def _capture(model, jqp=None, tqp=None, jqrt=None, qrt=None):
    """Both packages' capture at top_k=1 with the tokens each sampled."""
    jax_tok, port_tok = [], []
    jax_sample, port_sample = JS.sample_with_top_k_top_p, \
        CAL.sample_with_top_k_top_p

    def jax_rec(key, logits, top_k=0, top_p=0.0):
        idx = jax_sample(key, logits, top_k, top_p)
        jax_tok.append(np.asarray(idx))
        return idx

    def port_rec(logits, top_k=0, top_p=0.0, generator=None):
        idx = port_sample(logits, top_k, top_p, generator)
        port_tok.append(idx.numpy())
        return idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "sample_with_top_k_top_p", jax_rec)
        mp.setattr(CAL, "sample_with_top_k_top_p", port_rec)
        jt = JCal.capture_generation(
            model.jp if jqp is None else jqp, model.jvae, model.jcfg,
            jnp.asarray(LABELS), jax.random.PRNGKey(5),
            JaxGenerateConfig(**TOP1), qrt=jqrt)
        tt = CAL.capture_generation(
            model.tp if tqp is None else tqp, model.tvae, model.cfg, LABELS,
            torch.Generator().manual_seed(5), GenerateConfig(**TOP1),
            qrt=qrt)
    return jt, tt, jax_tok, port_tok


@pytest.fixture(scope="module")
def captured(model, tmp_path_factory):
    """Both captures, and a store of each written from its own taps."""
    jt, tt, jax_tok, port_tok = _capture(model)
    root = tmp_path_factory.mktemp("calib")
    jstore = JCal.CalibrationStore(str(root / "jax"))
    jstore.append_run(jt)
    tstore = CAL.CalibrationStore(str(root / "port"))
    tstore.append_run(tt)
    return SimpleNamespace(jt=jt, tt=tt, jax_tok=jax_tok, port_tok=port_tok,
                           jstore=jstore, tstore=tstore, root=root)


def _assert_taps_close(tt, jt):
    assert len(tt) == len(jt)
    for si, (ours, theirs) in enumerate(zip(tt, jt)):
        assert sorted(ours) == sorted(theirs) == sorted(CAL.LAYER_KINDS)
        for kind in ours:
            assert ours[kind].dtype == np.float32
            assert ours[kind].shape == np.asarray(theirs[kind]).shape
            np.testing.assert_allclose(ours[kind], np.asarray(theirs[kind]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{kind} step {si}")


# ---------------------------------------------------------------------------
# STE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w_bit,fmt", [(4, None), (6, None), (4, "fp_e1"),
                                       (4, "fp_e3"), (8, None)])
def test_ste_forward_bit_equal_and_identity_gradient(w_bit, fmt):
    rng = np.random.default_rng(w_bit)
    x = (rng.standard_normal((6, 256)) * 0.7).astype(np.float32)
    theirs = np.asarray(jax.jit(JG.make_quant_ste(w_bit, fmt))(x))
    quant = G.make_quant_ste(w_bit, fmt)
    xt = torch.from_numpy(x).requires_grad_(True)
    ours = quant(xt)
    np.testing.assert_array_equal(ours.detach().numpy(), theirs)   # exact
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    (ours * g).sum().backward()
    assert torch.equal(xt.grad, g)                                  # exact


def test_ste_wrappers_match_jax():
    x = np.random.default_rng(1).standard_normal((3, 128)).astype(np.float32)
    for ours, theirs in ((STE.fp_quant_ste("fp6_e3m2"),
                          JSte.fp_quant_ste("fp6_e3m2")),
                         (STE.int_sym_ste(6), JSte.int_sym_ste(6))):
        np.testing.assert_array_equal(ours(torch.from_numpy(x)).numpy(),
                                      np.asarray(jax.jit(theirs)(x)))


# ---------------------------------------------------------------------------
# Calibration capture and store
# ---------------------------------------------------------------------------

def test_capture_generation_matches_jax(model, captured):
    assert len(captured.port_tok) == len(captured.jax_tok) == 3
    for si, (a, b) in enumerate(zip(captured.port_tok, captured.jax_tok)):
        np.testing.assert_array_equal(a, b, err_msg=f"scale {si}")
    _assert_taps_close(captured.tt, captured.jt)
    assert captured.tt[1]["fc1"].shape == (2, 6, 4, 128)
    assert captured.tt[2]["fc2"].shape == (2, 6, 9, 512)


def test_capture_generation_with_packed_kv_matches_jax(model):
    """Under ``int8kv``'s runtime (the packed KV cache and quantized
    linears) on JAX's quantized tree."""
    jcfg, jqp = _jax_params(128, "int8kv")
    jt, tt, jax_tok, port_tok = _capture(
        model, jqp=jqp, tqp=to_torch(_np_tree(jqp), "cpu"),
        jqrt=jax_runtime(_recipe("int8kv", True), jcfg.depth, jcfg.width),
        qrt=build_runtime(_recipe("int8kv"), jcfg.depth, jcfg.width, "cpu"))
    for a, b in zip(port_tok, jax_tok):
        np.testing.assert_array_equal(a, b)
    _assert_taps_close(tt, jt)


def test_capture_condition_matches_jax(model):
    labels = np.arange(0, 1000, 97)
    theirs = JCal.capture_condition(model.jp, model.jcfg, labels)
    ours = CAL.capture_condition(model.tp, model.cfg, labels)
    assert ours.dtype == np.float32 and ours.shape == (len(labels), 128)
    np.testing.assert_allclose(ours, np.asarray(theirs), rtol=0, atol=1e-6)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_calibration_store_interchange(captured, writer):
    """Each package reads the other's store file for file (the same
    ``{kind}_block{b}_step{s}.npz`` names, array ``x``)."""
    src = captured.jstore if writer == "jax" else captured.tstore
    other = (CAL.CalibrationStore if writer == "jax"
             else JCal.CalibrationStore)(src.root)
    names = sorted(os.listdir(src.root))
    assert len(names) == 4 * 2 * 3
    assert names[0] == "fc1_block0_step0.npz"
    for kind in CAL.LAYER_KINDS:
        for blk in range(2):
            assert other.steps(kind, blk) == src.steps(kind, blk) == 3
            for st in range(3):
                np.testing.assert_array_equal(other.load(kind, blk, st),
                                              src.load(kind, blk, st))


def test_calibration_store_appends(captured, tmp_path):
    store = CAL.CalibrationStore(str(tmp_path))
    store.append_run(captured.tt)
    store.append_run(captured.tt[:2])
    jstore = JCal.CalibrationStore(str(tmp_path))
    for st, rows in ((0, 12), (1, 12), (2, 6)):
        x = jstore.load("mat_qkv", 1, st)
        assert x.shape[0] == rows
        np.testing.assert_array_equal(x[:6], captured.tt[st]["mat_qkv"][1])
        np.testing.assert_array_equal(x[6:], captured.tt[st]["mat_qkv"][1][
            : rows - 6])


# ---------------------------------------------------------------------------
# Format search
# ---------------------------------------------------------------------------

def _assert_same_results(ours, theirs, rtol):
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert set(o) == set(t) == {"block_idx", "weight_format",
                                    "activation_format", "loss"}
        assert (o["block_idx"], o["weight_format"], o["activation_format"]) \
            == (t["block_idx"], t["weight_format"], t["activation_format"])
        assert isinstance(o["loss"], float) and o["loss"] >= 0
        np.testing.assert_allclose(o["loss"], t["loss"], rtol=rtol, atol=0)


@pytest.mark.parametrize("kind,max_samples,bits", [
    ("fc1", 1024, 4), ("mat_qkv", 40, 4), ("fc2", 40, 6)])
def test_search_formats_matches_jax(model, captured, kind, max_samples,
                                    bits):
    """On the store JAX wrote, with JAX's row draws where rows exceed
    ``max_samples`` (84 rows a block)."""
    w = np.asarray(model.jp["blocks"][f"{kind}_w"], np.float32)
    space = (JSe.FP4_SPACE, S.FP4_SPACE) if bits == 4 else (
        JSe.FP6_SPACE, S.FP6_SPACE)
    theirs = JSe.search_formats(captured.jstore, w, kind, space[0],
                                max_samples=max_samples)
    ours = S.search_formats(CAL.CalibrationStore(captured.jstore.root), w,
                            kind, space[1], max_samples=max_samples,
                            device="cpu")
    _assert_same_results(ours, theirs, SEARCH_RTOL)


@pytest.mark.parametrize("granularity", ["per_token", "per_group"])
def test_search_ada_formats_matches_jax(model, granularity):
    cond = JCal.capture_condition(model.jp, model.jcfg, np.arange(8))
    ada_w = np.asarray(model.jp["blocks"]["ada_lin"]["w"], np.float32)
    theirs = JSe.search_ada_formats(np.asarray(cond), ada_w,
                                    granularity=granularity)
    ours = S.search_ada_formats(
        CAL.capture_condition(model.tp, model.cfg, np.arange(8)),
        torch.from_numpy(ada_w.copy()), granularity=granularity,
        device="cpu")
    _assert_same_results(ours, theirs, SEARCH_RTOL)


def test_formats_json_and_mixed_config(tmp_path):
    results = [{"block_idx": 0, "weight_format": "e2m1",
                "activation_format": "e3m0", "loss": 0.25},
               {"block_idx": 1, "weight_format": "e1m2",
                "activation_format": "e2m1", "loss": 1e-7}]
    S.save_formats_json(str(tmp_path / "p.json"), results)
    JSe.save_formats_json(str(tmp_path / "j.json"), results)
    assert (tmp_path / "p.json").read_text() == (
        tmp_path / "j.json").read_text()
    assert S.load_formats_json(str(tmp_path / "j.json")) == results
    assert S.formats_to_mixed_config(results) == \
        JSe.formats_to_mixed_config(results) == ("fp_e3", "fp_e2")
    fp6 = [dict(r, activation_format="e3m2") for r in results]
    assert S.formats_to_mixed_config(fp6, S.FP6_SPACE) == \
        JSe.formats_to_mixed_config(fp6, JSe.FP6_SPACE)


# ---------------------------------------------------------------------------
# GALT
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("w_bit,width,out", [(4, 128, 512), (6, 256, 384)])
def test_quant_error_and_gradient_match_jax(w_bit, width, out):
    rng = np.random.default_rng(w_bit)
    x = rng.standard_normal((40, width)).astype(np.float32)
    w = (rng.standard_normal((out, width)) * 0.02).astype(np.float32)
    s = np.exp(0.2 * rng.standard_normal(width)).astype(np.float32)
    qb = block_hadamard_block(128, 42)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda ss: JG.quant_error(jnp.asarray(x), jnp.asarray(w), ss,
                                  jnp.asarray(qb, jnp.float32),
                                  JG.make_quant_ste(w_bit))))(jnp.asarray(s))
    st = torch.from_numpy(s).requires_grad_(True)
    loss = G.quant_error(torch.from_numpy(x), torch.from_numpy(w), st,
                         torch.from_numpy(qb).float(), G.make_quant_ste(w_bit))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=QERR_RTOL)
    gref = np.asarray(jg)
    np.testing.assert_allclose(st.grad.numpy(), gref, rtol=0,
                               atol=QERR_RTOL * np.abs(gref).max())


def _acts(store, kind, blk):
    return [store.load(kind, blk, s).reshape(-1, 128)
            for s in range(store.steps(kind, blk))]


@pytest.mark.parametrize("kind", ["mat_qkv", "fc1"])
def test_train_galt_block_matches_jax(model, captured, kind):
    """Three epochs of block 1.  The training is discontinuous in its
    inputs (an activation or weight at a near-tie of the grid takes the
    other code, and Adam's first steps move each channel by about ``lr``
    whatever the gradient's size), so the bound is the larger of
    ``GALT_S_ATOL`` (``GALT_LOSS_RTOL``) and twice JAX's own response to a
    one-ulp change of the activations, measured here (1.6e-3 in ``s`` for
    ``fc1``'s block 1)."""
    w = np.asarray(model.jp["blocks"][f"{kind}_w"], np.float32)[1]
    acts = _acts(captured.jstore, kind, 1)
    js, jl = JG.train_galt_block(acts, w, epochs=3)
    js_ulp, jl_ulp = JG.train_galt_block(
        [a * np.float32(1 + 2.0 ** -23) for a in acts], w, epochs=3)
    s, loss = G.train_galt_block(acts, w, epochs=3, device="cpu")
    assert s.dtype == np.float32 and s.shape == (128,)
    assert not np.allclose(s, 1.0)             # it moved
    s_tol = max(GALT_S_ATOL, 2 * float(np.abs(js_ulp - js).max()))
    loss_tol = max(GALT_LOSS_RTOL, 2 * abs(jl_ulp - jl) / jl)
    np.testing.assert_allclose(s, js, rtol=0, atol=s_tol)
    np.testing.assert_allclose(loss, jl, rtol=loss_tol)


@pytest.fixture(scope="module")
def galt_pair(model, captured):
    """JAX's ``train_galt`` for both kinds over its store (one epoch, 16
    rows a step: JAX's row draws), and the port's over the port's store."""
    out = {}
    for kind in ("mat_qkv", "fc1"):
        w = np.asarray(model.jp["blocks"][f"{kind}_w"], np.float32)
        out[kind] = (
            JG.train_galt(captured.jstore, w, kind, epochs=1,
                          max_samples_per_step=16),
            G.train_galt(captured.tstore, torch.from_numpy(w), kind,
                         epochs=1, max_samples_per_step=16, device="cpu"))
    return out


def test_train_galt_matches_jax(galt_pair):
    for kind, (theirs, ours) in galt_pair.items():
        assert ours.shape == theirs.shape == (2, 128), kind
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=GALT_S_ATOL,
                                   err_msg=kind)


def test_best_s_artifacts(tmp_path):
    s = np.random.default_rng(0).random((2, 128)).astype(np.float32)
    d = tmp_path / "best"
    d.mkdir()
    torch.save([torch.from_numpy(r.copy()) for r in s * 2],
               str(d / "mat_qkv_best_s_fp4.pt"))
    np.testing.assert_array_equal(
        G.load_reference_best_s(str(d / "mat_qkv_best_s_fp4.pt")), s * 2)
    with pytest.raises(FileNotFoundError) as ours:
        G.load_best_s_pair(str(d), 4)
    with pytest.raises(FileNotFoundError) as theirs:
        JG.load_best_s_pair(str(d), 4)
    assert str(ours.value) == str(theirs.value)
    G.save_best_s(str(d / "fc1_best_s_fp4.npz"), s)
    qkv, fc1 = G.load_best_s_pair(str(d), 4)
    np.testing.assert_array_equal(qkv, s * 2)           # the .pt alone
    np.testing.assert_array_equal(fc1, s)
    G.save_best_s(str(d / "mat_qkv_best_s_fp4.npz"), s)  # npz before .pt
    for ours_, theirs_ in zip(G.load_best_s_pair(str(d), 4),
                              JG.load_best_s_pair(str(d), 4)):
        np.testing.assert_array_equal(ours_, theirs_)
        np.testing.assert_array_equal(ours_, s)


# ---------------------------------------------------------------------------
# The whole chain
# ---------------------------------------------------------------------------

def test_offline_chain_matches_jax(model, galt_pair, monkeypatch):
    """capture -> GALT -> quantize_var_params(int8) -> generate: JAX's
    chain and the port's give the same tokens at top_k=1, both transforms
    given JAX's GALT vectors."""
    s = (galt_pair["mat_qkv"][0], galt_pair["fc1"][0])
    jq = _recipe("int8", jax_side=True)
    jqp = jax_quantize(model.jp, model.jcfg, jq, galt=s)
    qp = quantize_var_params(model.tp, model.cfg, _recipe("int8"), galt=s)
    jax_tok, port_tok = [], []
    jax_sample, port_sample = JV.sample_with_top_k_top_p, \
        V.sample_with_top_k_top_p

    def jax_rec(key, logits, top_k=0, top_p=0.0):
        idx = jax_sample(key, logits, top_k, top_p)
        jax.debug.callback(lambda v: jax_tok.append(np.asarray(v)), idx,
                           ordered=True)
        return idx

    def port_rec(logits, top_k=0, top_p=0.0, generator=None, gumbel=None):
        idx = port_sample(logits, top_k, top_p, generator, gumbel)
        port_tok.append(idx.numpy())
        return idx

    monkeypatch.setattr(JV, "sample_with_top_k_top_p", jax_rec)
    monkeypatch.setattr(V, "sample_with_top_k_top_p", port_rec)
    JaxGenerator(model.jcfg, jq, JaxGenerateConfig(**TOP1),
                 cache_dtype=jnp.float32, compute_dtype=jnp.float32).generate(
        jqp, model.jvae, jnp.asarray(LABELS), jax.random.PRNGKey(2),
        return_fhat=True)
    jax.effects_barrier()
    img = VARGenerator(model.cfg, _recipe("int8"), GenerateConfig(**TOP1),
                       cache_dtype=torch.float32, compute_dtype=torch.float32,
                       device="cpu").generate(qp, model.tvae, LABELS)
    assert len(port_tok) == len(jax_tok) == 3
    for si, (a, b) in enumerate(zip(port_tok, jax_tok)):
        np.testing.assert_array_equal(a, b, err_msg=f"scale {si}")
    assert bool(torch.isfinite(img).all())


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def test_cli_chain(tmp_path, capsys):
    """calibrate (a subprocess) -> search_formats -> train_galt (both
    kinds) -> convert_checkpoint under the int8 recipe with the GALT
    vectors -> load_params -> generate, at --tiny --device cpu, as the JAX
    package's CLI test runs its scripts."""
    calib = tmp_path / "calib"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "fpqvar_tpu_torch.tools.calibrate", "--tiny",
         "--num-classes", "3", "--batch", "2", "--out", str(calib),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "random init (smoke-test mode)" in r.stderr
    assert (calib / "condition.npz").exists()
    assert np.load(calib / "fc1_block1_step2.npz")["x"].shape == (6, 9, 128)
    assert np.load(calib / "condition.npz")["cond"].shape == (3, 128)

    fmts = tmp_path / "formats_fc1.json"
    search_formats.main(["--tiny", "--kind", "fc1", "--calib", str(calib),
                         "--max-samples", "16", "--out", str(fmts),
                         "--device", "cpu"])
    data = json.loads(fmts.read_text())
    assert [r["block_idx"] for r in data] == [0, 1]
    assert all(r["activation_format"] in S.FP4_SPACE for r in data)

    best = tmp_path / "best_s"
    best.mkdir()
    for kind in ("mat_qkv", "fc1"):
        train_galt.main(["--tiny", "--kind", kind, "--calib", str(calib),
                         "--epochs", "1", "--max-samples-per-step", "16",
                         "--out", str(best / f"{kind}_best_s_fp4.npz"),
                         "--device", "cpu"])
    ck = tmp_path / "q.npz"
    convert_checkpoint.main(["--tiny", "--quant", "--backend", "int8",
                             "--rotate", "--block_rotate", "--transform",
                             "--best-s-dir", str(best), "--out", str(ck),
                             "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"wrote {ck}" in out and "shape (2, 128)" in out
    qp = C.load_params(str(ck), "cpu")
    assert qp["blocks"]["fc1_w"].codes.dtype == torch.int8
    assert qp["class_emb"].dtype == torch.bfloat16     # cast before quantize
    fc1_s = torch.from_numpy(G.load_best_s(str(best / "fc1_best_s_fp4.npz")))
    assert torch.equal(qp["blocks"]["fc1_s"], fc1_s.to(torch.bfloat16))
    img = VARGenerator(var_tiny(), _recipe("int8"), device="cpu").generate(
        qp, init_vqvae_params(var_tiny().vae, seed=1, device="cpu"), [1, 2])
    assert img.shape == (2, 3, 6, 6) and bool(torch.isfinite(img).all())


def test_cli_search_ada_shared_aln(tmp_path):
    """``--kind ada`` on a shared-AdaLN (512-family) model: one entry, the
    ``shared_ada_lin``."""
    out = tmp_path / "ada.json"
    search_formats.main(["--kind", "ada", "--depth", "2", "--resolution",
                         "512", "--labels", "4", "--calib", str(tmp_path),
                         "--out", str(out), "--device", "cpu"])
    data = json.loads(out.read_text())
    assert len(data) == 1 and data[0]["weight_format"] in S.FP4_SPACE


def test_cli_convert_upstream_checkpoints(tmp_path):
    """``convert_checkpoint`` on seeded upstream ``.pth`` files: the npz
    holds the converters' trees (float32, no transform)."""
    cfg = var_tiny()
    var_sd = {k: torch.from_numpy(v)
              for k, v in _var_state_dict(jax_var_tiny()).items()}
    vae_sd = {k: torch.from_numpy(v) for k, v in _vqvae_state_dict(
        vqvae_params(jax_var_tiny().vae)[0], "partially_shared").items()}
    torch.save(var_sd, str(tmp_path / "var.pth"))
    torch.save({"state_dict": vae_sd}, str(tmp_path / "vae.pth"))
    out = tmp_path / "var.npz"
    convert_checkpoint.main(["--tiny", "--var-ckpt", str(tmp_path / "var.pth"),
                             "--vae-ckpt", str(tmp_path / "vae.pth"),
                             "--out", str(out), "--device", "cpu"])
    _assert_port_equal(C.load_params(str(out), "cpu"),
                       C.convert_var_state_dict(var_sd, cfg, "cpu"))
    _assert_port_equal(C.load_params(str(tmp_path / "var_vae.npz"), "cpu"),
                       C.convert_vqvae_state_dict(vae_sd, cfg.vae, "cpu"))
