"""The teacher-forcing forward and the VQVAE encoder against the JAX package.

The same seeded numpy inputs go through JAX's function and the port's, on
JAX-initialized params carried over by the bridge (quantized by JAX's
``quantize_var_params`` where a recipe is on; JAX's int8 and packed linears
run their CPU routes, the port its kernels' plain versions):

- ``attn_bias_for_masking`` equal to JAX's (``-inf`` included), and built
  once per (cfg, device);
- ``var_forward`` logits within 1e-5 (values of order 1; float32 sums in
  another order, as ``test_torch_generate`` holds its logits) at
  ``var_tiny`` under ``bf16`` and ``fake`` and at width 256 (every grouped
  linear has two scale groups) under ``int8``, ``packed`` and ``int8ch``;
- the KV-cached scale loop equal to one masked forward within JAX's own
  bound for it (``tests/test_var_model.py``: atol 2e-5, rtol 1e-4, float32);
- ``run_blocks(capture=True)``'s taps, ``[depth, B, l, C]`` (fc2 ``4C``),
  within 1e-5 of JAX's without a cache and scale by scale with one (dense,
  and packed under ``int8kv``), under mixed block formats too;
- ``remat`` gradients equal to the plain ones (the CPU recomputes each
  block bit for bit);
- the encoder's feature map within 1e-5 of JAX's, and the tokens of
  ``f_to_idxBl`` (on JAX's feature map) and of ``img_to_idxBl`` (each on
  its own) equal to JAX's except at near-ties (``vqvae.token_agreement``:
  scale by scale along the port's tokens, a differing token must score
  within the bound ``vqvae.near_tie_bound`` derives of the port's, in
  float64: the float32 rounding of the squared distance or the cosine,
  plus the rows' difference between the two sides; an image's later
  scales, whose residuals then differ, are left out and counted).  The
  differing tokens must be under 2% of the compared ones, and a token
  moved to a far code is caught;
- ``idxBl_to_var_input`` within 1e-6 on the same tokens;
- ``init_vqvae_params`` has JAX's whole tree (``encoder`` and
  ``quant_conv`` included), and the decoder, quantizer and post-quant conv
  of a seed keep the values they had before the encoder was ported;
- the bridge carries JAX's encoder tree, nested and as the flat npz of
  ``save_params`` (levels with an empty ``attn`` list included).
"""
import dataclasses
import functools
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu import config as JC
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.models import vqvae as Jvq
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize
from fpqvar_tpu.quantize.runtime import build_runtime as jax_runtime
from fpqvar_tpu.utils.checkpoint import save_params

from fpqvar_tpu_torch.config import bench_recipes, paper_recipes, var_tiny
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.models import vqvae as vq
from fpqvar_tpu_torch.quantize.runtime import build_runtime
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_vqvae import CONFIGS as VQ_CONFIGS
from test_torch_vqvae import _params as vqvae_params
from torch_threads import one_torch_thread  # noqa: F401

#: sha256 of the decoder, quantizer and post-quant conv leaves that
#: ``init_vqvae_params(var_tiny().vae, seed, "cpu")`` drew before the
#: encoder was ported
DECODE_SIDE_SHA256 = {
    1: "8b184f401b645ae31a63454a1acfac81bfe1e12cbe11d69077b30d5383495c7f",
    5: "168afe9e97b05cf7ad443e4612f45f9ed9427ad4193097603dc7cbb7001d9833",
}


def _recipe(mode, jax_side=False):
    """A recipe of ``bench_recipes``, or ``fp4_mixed`` (the paper's
    ``fp4`` with the two blocks in fp_e2 and fp_e3)."""
    if mode != "fp4_mixed":
        return (JC.bench_recipes() if jax_side else bench_recipes())[mode]
    q = paper_recipes()["fp4"].replace(mixed_act_formats=("fp_e2", "fp_e3"))
    return JC.QuantConfig(**dataclasses.asdict(q)) if jax_side else q


def _galt(depth, width):
    rng = np.random.default_rng(5)
    return tuple(np.exp(0.1 * rng.standard_normal((depth, width)))
                 .astype(np.float32) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _model(width, mode):
    """JAX's params (quantized by JAX under an enabled recipe) and
    runtime, and the port's bridged params and runtime."""
    jcfg = dataclasses.replace(JC.var_tiny(), embed_dim=width,
                               num_heads=width // 64)
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)
    jp = jax.jit(functools.partial(JV.init_var_params, cfg=jcfg,
                                   adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))
    jq = _recipe(mode, jax_side=True)
    if jq.enabled:
        jp = jax_quantize(jp, jcfg, jq, galt=_galt(jcfg.depth, width))
    tp = to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return (jcfg, jp, jax_runtime(jq, jcfg.depth, jcfg.width),
            cfg, tp, build_runtime(_recipe(mode), cfg.depth, cfg.width,
                                   "cpu"))


def _inputs(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.num_classes, b)
    x = rng.standard_normal((b, cfg.L - cfg.first_l, cfg.vae.z_channels))
    return labels, x.astype(np.float32)


@pytest.mark.parametrize("patch_nums", [(1, 2, 3), JC.PATCH_NUMS_256,
                                        JC.PATCH_NUMS_512])
def test_attn_bias_for_masking_equal(patch_nums):
    jcfg = JC.VARConfig(patch_nums=patch_nums)
    cfg = dataclasses.replace(var_tiny(), patch_nums=patch_nums)
    bias = V.attn_bias_for_masking(cfg, torch.device("cpu"))
    theirs = JV.attn_bias_for_masking(jcfg)
    assert bias.dtype == torch.float32 and bias.shape == theirs.shape
    np.testing.assert_array_equal(bias.numpy(), theirs)
    assert V.attn_bias_for_masking(cfg, torch.device("cpu")) is bias


@pytest.mark.parametrize("width,mode", [(128, "bf16"), (128, "fake"),
                                        (256, "int8"), (256, "packed"),
                                        (256, "int8ch")])
def test_var_forward_matches_jax(width, mode):
    jcfg, jp, jqrt, cfg, tp, qrt = _model(width, mode)
    labels, x = _inputs(cfg)
    theirs = jax.jit(lambda p, lb, xx: JV.var_forward(p, jcfg, jqrt, lb, xx))(
        jp, jnp.asarray(labels), jnp.asarray(x))
    ours = V.var_forward(tp, cfg, qrt, torch.from_numpy(labels),
                         torch.from_numpy(x))
    assert ours.shape == (2, cfg.L, cfg.vae.vocab_size)
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                               atol=1e-5)


def _token_maps(cfg, b, seed):
    rng = np.random.default_rng(seed)
    xs = [(rng.standard_normal((b, pn * pn, cfg.width)) * 0.1)
          .astype(np.float32) for pn in cfg.patch_nums]
    cond = (rng.standard_normal((b, cfg.width)) * 0.1).astype(np.float32)
    return xs, cond


@pytest.mark.parametrize("width", [128, 256])
def test_stepwise_equals_masked(width):
    """JAX's ``test_kv_cache_equals_full_attention`` on the port."""
    _, _, _, cfg, tp, _ = _model(width, "bf16")
    xs, cond = _token_maps(cfg, 2, 42)
    mod = V.compute_modulations(tp, cfg, torch.from_numpy(cond))
    cache = V.init_kv_cache(cfg, 2, torch.float32, "cpu")
    outs, cur = [], 0
    for x in xs:
        outs.append(V.run_blocks(tp, cfg, None, torch.from_numpy(x), mod,
                                 cache, cur))
        cur += x.shape[1]
    full = V.run_blocks(tp, cfg, None, torch.from_numpy(np.concatenate(
        xs, axis=1)), mod, attn_bias=V.attn_bias_for_masking(cfg, "cpu"))
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(),
                               atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("width,mode,cached", [
    (128, "bf16", False), (256, "int8", True), (256, "packed", False),
    (128, "int8kv", True), (128, "fp4_mixed", False),
    (128, "fp4_mixed", True)])
def test_capture_taps_match_jax(width, mode, cached):
    jcfg, jp, jqrt, cfg, tp, qrt = _model(width, mode)
    xs, cond = _token_maps(cfg, 2, 7)
    jmod = jax.jit(lambda p, c: JV.compute_modulations(p, jcfg, c, jqrt))(
        jp, jnp.asarray(cond))
    mod = V.compute_modulations(tp, cfg, torch.from_numpy(cond), qrt)
    np.testing.assert_allclose(mod.numpy(), np.asarray(jmod), rtol=0,
                               atol=1e-6)
    if cached:
        codec = jqrt.kv_codec
        jcache = JV.init_kv_cache(jcfg, 2, jnp.float32, kv_codec=codec)
        cache = V.init_kv_cache(cfg, 2, torch.float32, "cpu", qrt.kv_codec)
        steps, cur = [], 0
        for x in xs:
            steps.append((x, cur, None))
            cur += x.shape[1]
    else:
        jcache = cache = None
        full = np.concatenate(xs, axis=1)
        steps = [(full, 0, V.attn_bias_for_masking(cfg, "cpu"))]

    @functools.partial(jax.jit, static_argnums=(3,))
    def jax_blocks(p, x, c, cur, bias):
        return JV.run_blocks(p, jcfg, jqrt, x, jmod, c, cur, attn_bias=bias,
                             capture=True)

    for x, cur, bias in steps:
        jy, jcache, jtaps = jax_blocks(
            jp, jnp.asarray(x), jcache, cur,
            None if bias is None else jnp.asarray(bias.numpy()))
        y, taps = V.run_blocks(tp, cfg, qrt, torch.from_numpy(x), mod, cache,
                               cur, attn_bias=bias, capture=True)
        b, l = x.shape[:2]
        assert sorted(taps) == sorted(jtaps) == ["fc1", "fc2", "mat_qkv",
                                                 "proj"]
        for kind, tap in taps.items():
            wide = 4 if kind == "fc2" else 1
            assert tap.shape == (cfg.depth, b, l, wide * cfg.width), kind
            np.testing.assert_allclose(tap.numpy(), np.asarray(jtaps[kind]),
                                       rtol=0, atol=1e-5,
                                       err_msg=f"{kind} at {cur}")
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=0,
                                   atol=1e-5)
    # capture changes nothing else
    plain = V.run_blocks(tp, cfg, qrt, torch.from_numpy(xs[0]), mod)
    again, _ = V.run_blocks(tp, cfg, qrt, torch.from_numpy(xs[0]), mod,
                            capture=True)
    assert torch.equal(plain, again)


@pytest.mark.parametrize("mixed_precision", [False, True])
def test_remat_gradients_equal_plain(mixed_precision):
    _, _, _, cfg, tp, _ = _model(128, "bf16")
    labels, x = _inputs(cfg)

    def grads(remat):
        p = {k: v for k, v in tp.items()}
        leaves = []

        def leaf(t):
            t = t.detach().clone().requires_grad_(True)
            leaves.append(t)
            return t

        p = _map(leaf, p)
        fwd = _map(lambda t: t.to(torch.bfloat16), p) if mixed_precision \
            else p
        xx = torch.from_numpy(x)
        logits = V.var_forward(fwd, cfg, None, torch.from_numpy(labels),
                               xx.to(torch.bfloat16) if mixed_precision
                               else xx, remat=remat)
        logits.square().mean().backward()
        return [t.grad for t in leaves]

    plain, remat = grads(False), grads(True)
    assert len(plain) == len(remat)
    for a, b in zip(plain, remat):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


# ---------------------------------------------------------------------------
# VQVAE encoder and tokenizer
# ---------------------------------------------------------------------------

def _vq_configs():
    out = dict(VQ_CONFIGS)
    jz, tz = out["tiny"]
    out["tiny_znorm"] = (dataclasses.replace(jz, using_znorm=True),
                         dataclasses.replace(tz, using_znorm=True))
    return out


@pytest.mark.parametrize("name", ["tiny", "three_levels", "tiny_znorm"])
def test_encoder_and_tokens_match_jax(name):
    jcfg, cfg = _vq_configs()[name]
    jp, tp = vqvae_params(jcfg)
    side = cfg.patch_nums[-1] * cfg.downsample
    img = np.random.default_rng(11).uniform(
        -1, 1, (32, 3, side, side)).astype(np.float32)
    jf = np.asarray(jax.jit(lambda p, i: Jvq.encode(p, jcfg, i))(
        jp, jnp.asarray(img)))
    f = vq.encode(tp, cfg, torch.from_numpy(img))
    hw = cfg.patch_nums[-1]
    assert f.shape == (32, cfg.z_channels, hw, hw)
    np.testing.assert_allclose(f.numpy(), jf, rtol=0, atol=1e-5)

    tok = jax.jit(lambda p, x: Jvq.f_to_idxBl(p, jcfg, x))
    jf_t = torch.from_numpy(jf.copy())
    ours = vq.f_to_idxBl(tp["quantize"], cfg, jf_t)
    theirs = [torch.from_numpy(np.array(t))
              for t in tok(jp["quantize"], jnp.asarray(jf))]
    assert [t.shape for t in ours] == [(32, pn * pn) for pn in cfg.patch_nums]
    agree = vq.token_agreement(tp["quantize"], cfg, jf_t, ours, jf_t, theirs)
    assert agree["beyond"] == 0 and agree["differ"] <= 0.02 * agree[
        "compared"], agree

    # end to end: each side encodes the images itself
    ours_e2e = vq.img_to_idxBl(tp, cfg, torch.from_numpy(img))
    theirs_e2e = [torch.from_numpy(np.array(t)) for t in jax.jit(
        lambda p, i: Jvq.img_to_idxBl(p, jcfg, i))(jp, jnp.asarray(img))]
    agree = vq.token_agreement(tp["quantize"], cfg, f, ours_e2e, jf_t,
                               theirs_e2e)
    assert agree["beyond"] == 0 and agree["differ"] <= 0.02 * agree[
        "compared"], agree

    # the teacher-forcing input of the same tokens
    jx = np.asarray(jax.jit(lambda p, t: Jvq.idxBl_to_var_input(p, jcfg, t))(
        jp["quantize"], [jnp.asarray(t.numpy()) for t in theirs]))
    x = vq.idxBl_to_var_input(tp["quantize"], cfg, theirs)
    l = sum(pn * pn for pn in cfg.patch_nums) - cfg.patch_nums[0] ** 2
    assert x.shape == (32, l, cfg.z_channels) and x.dtype == torch.float32
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-6)


def test_near_tie_rule_flags_a_wrong_token():
    """The rule accepts a token swapped only where the two codes nearly
    tie: a token moved to the farthest code fails it."""
    jcfg, cfg = VQ_CONFIGS["tiny"]
    _, tp = vqvae_params(jcfg)
    f = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, cfg.z_channels, 3, 3)).astype(np.float32))
    ours = vq.f_to_idxBl(tp["quantize"], cfg, f)
    agree = vq.token_agreement(tp["quantize"], cfg, f, ours, f, ours)
    assert agree == {"compared": 4 * sum(p * p for p in cfg.patch_nums),
                     "differ": 0, "left_out": 0, "beyond": 0}
    z = vq.scale_inputs_along(tp["quantize"], cfg, f, ours)[1]
    worst = vq.code_scores(tp["quantize"], z, False).argmax(1)
    bad = [t.clone() for t in ours]
    bad[1][0, 0] = worst[0]
    agree = vq.token_agreement(tp["quantize"], cfg, f, ours, f, bad)
    assert agree["differ"] == agree["beyond"] == 1
    assert agree["left_out"] == cfg.patch_nums[2] ** 2


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", ["tiny", "three_levels"])
def test_init_vqvae_params_has_jax_tree(name):
    jcfg, cfg = VQ_CONFIGS[name]
    theirs = jax.eval_shape(lambda k: Jvq.init_vqvae_params(k, jcfg),
                            jax.random.PRNGKey(0))
    ours = vq.init_vqvae_params(cfg, seed=1, device="cpu")
    assert sorted(ours) == sorted(theirs)
    assert _shapes(ours) == _shapes(theirs)


@pytest.mark.parametrize("seed", sorted(DECODE_SIDE_SHA256))
def test_init_vqvae_decode_side_unchanged(seed):
    p = vq.init_vqvae_params(var_tiny().vae, seed=seed, device="cpu")
    h = hashlib.sha256()
    for key in ("decoder", "quantize", "post_quant_conv"):
        for t in _leaves(p[key]):
            h.update(t.numpy().tobytes())
    assert h.hexdigest() == DECODE_SIDE_SHA256[seed]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


@pytest.mark.parametrize("flat", [False, True])
def test_bridge_carries_the_encoder_tree(tmp_path, flat):
    jcfg, cfg = VQ_CONFIGS["three_levels"]
    jp, _ = vqvae_params(jcfg)
    assert jp["encoder"]["down"][0]["attn"] == []
    if flat:
        save_params(str(tmp_path / "vae.npz"), jp)
        tree = dict(np.load(tmp_path / "vae.npz"))
    else:
        tree = jp
    tp = to_torch(tree, "cpu")
    assert _shapes(tp) == _shapes(vq.init_vqvae_params(cfg, 0, "cpu"))
    assert tp["encoder"]["down"][0]["attn"] == []
    _assert_same(tp, jp)


def _assert_same(ours, theirs, where=""):
    if isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), where
        for k in theirs:
            _assert_same(ours[k], theirs[k], f"{where}/{k}")
    elif isinstance(theirs, list):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_same(a, b, f"{where}/{i}")
    else:
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs),
                                      err_msg=where)
