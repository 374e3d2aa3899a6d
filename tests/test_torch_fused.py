"""The engine's fused mode (``VARGenerator(fuse_steps=True)``) on the CPU.

On a card the fused mode replays CUDA graphs; on the CPU it runs the same
code without capture: the labels are copied into a static buffer, the
whole generation's Gumbel noise is drawn up front into static buffers
(``sampling.noise_plan``) and the scales read it from there.  So:

- fused generations are bit-equal to the eager loop's (``fuse_steps=
  False``) at ``var_tiny`` under ``bf16``, ``int8``, ``packed`` (fp4
  nibbles through K2's plain version, and ``fp_e1`` weights, a format
  without an in-kernel decoder), ``int8kv`` and ``fp4_kv6``, with
  ``more_smooth`` off and on: two consecutive calls from one generator,
  one call with a generator per row, and ``return_fhat``; every generator
  ends in the state the eager loop leaves it in;
- the noise plan draws the values of the eager loop's calls, in their
  order, and leaves each generator in the same state;
- at ``top_k=1`` (argmax: no RNG) the port's fused generation samples JAX's
  fused generation's tokens on the same bridged weights, with images
  within 5e-5 (``test_torch_generate``'s bound; float32 sums in another
  order);
- a server with a fused generator (at ``test_torch_serving``'s config,
  where the CPU's batched sums do not depend on a row's place) gives a
  request the same image whatever it is batched with, equal to the eager
  server's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import GenerateConfig as JaxGenerateConfig
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.models.engine import VARGenerator as JaxGenerator

from fpqvar_tpu_torch.config import (GenerateConfig, bench_recipes,
                                     fpqvar_w4a4, paper_recipes, var_tiny)
from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                     init_vqvae_params)
from fpqvar_tpu_torch.models import sampling as S
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.serving import GenerationServer
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_generate import LABELS, _jax_decode, _jax_params, _jax_vae
from test_torch_serving import TINY
from torch_threads import one_torch_thread  # noqa: F401

CFG = var_tiny()


def _recipe(mode):
    if mode == "w4a4p_e1":
        return fpqvar_w4a4().replace(backend="packed", weight_format="fp_e1")
    return {**bench_recipes(), **paper_recipes()}[mode]


def _model(mode):
    params = init_var_params(CFG, seed=0, device="cpu", adaln_gamma_std=0.02)
    vae = init_vqvae_params(CFG.vae, seed=1, device="cpu")
    q = _recipe(mode)
    rng = np.random.default_rng(2)
    galt = tuple(np.exp(0.1 * rng.standard_normal((CFG.depth, CFG.width)))
                 .astype(np.float32) for _ in range(2))
    return q, (quantize_var_params(params, CFG, q, galt=galt)
               if q.enabled else params), vae


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _run(gen, params, vae):
    """Two calls from one generator, one with a generator per row and
    return_fhat; the outputs and every generator's final state."""
    one = _gen(3)
    a = gen.generate(params, vae, [3, 5, 7], one)
    b = gen.generate(params, vae, [1, 2, 0], one)
    rows = [_gen(10 + i) for i in range(3)]
    c = gen.generate(params, vae, [4, 4, 9], rows, return_fhat=True)
    return [a, b, c], [one.get_state()] + [g.get_state() for g in rows]


@pytest.mark.parametrize("more_smooth", [False, True])
@pytest.mark.parametrize("mode", ["bf16", "int8", "packed", "w4a4p_e1",
                                  "int8kv", "fp4_kv6"])
def test_fused_equals_eager(mode, more_smooth):
    q, params, vae = _model(mode)
    g = GenerateConfig(more_smooth=more_smooth)
    eager = VARGenerator(CFG, q, g, device="cpu", fuse_steps=False)
    fused = VARGenerator(CFG, q, g, qrt=eager.qrt, device="cpu")
    assert fused.fuse_steps and fused.qrt is eager.qrt
    outs_e, states_e = _run(eager, params, vae)
    outs_f, states_f = _run(fused, params, vae)
    assert outs_f[0].shape == (3, 3, 6, 6) and outs_f[2].shape[0] == 3
    for x, y in zip(outs_e, outs_f):
        assert x.dtype == y.dtype and torch.equal(x, y)
    for x, y in zip(states_e, states_f):
        assert torch.equal(x, y)
    assert not torch.equal(outs_f[0], outs_f[1])
    # the fused output is the caller's: a later call does not overwrite it
    kept = outs_f[0].clone()
    fused.generate(params, vae, [0, 0, 0], _gen(4))
    assert torch.equal(outs_f[0], kept)
    with pytest.raises(ValueError, match="generators"):
        fused.generate(params, vae, [3, 5], [_gen(1)])


@pytest.mark.parametrize("more_smooth", [False, True])
@pytest.mark.parametrize("per_row", [False, True])
def test_noise_plan_draws_the_eager_noise(per_row, more_smooth):
    sizes, vocab, b = [1, 4, 9], 32, 3

    def gens():
        return [_gen(20 + i) for i in range(b)] if per_row else _gen(20)

    plan_gens, eager_gens = gens(), gens()
    plan = S.noise_plan(sizes, vocab, b, plan_gens, more_smooth, "cpu")
    out = [tuple(torch.empty((b, l, vocab)) if i == 0 or more_smooth
                 else None for i in range(2)) for l in sizes]
    copied = S.noise_plan(sizes, vocab, b, gens(), more_smooth, "cpu", out)
    assert len(plan) == len(sizes)
    for (sample, blend), l, (cs, cb), (bs, bb) in zip(plan, sizes, copied,
                                                      out):
        assert sample.shape == (b, l, vocab) and cs is bs
        assert torch.equal(sample, S.gumbel_noise((b, l, vocab), eager_gens,
                                                  "cpu"))
        assert torch.equal(cs, sample)
        if more_smooth:
            assert torch.equal(blend, S.gumbel_noise((b, l, vocab),
                                                     eager_gens, "cpu"))
            assert cb is bb and torch.equal(cb, blend)
        else:
            assert blend is None and cb is None
    for p, e in zip(plan_gens if per_row else [plan_gens],
                    eager_gens if per_row else [eager_gens]):
        assert torch.equal(p.get_state(), e.get_state())


@pytest.mark.parametrize("width,mode", [(128, "bf16"), (256, "int8")])
def test_fused_generation_matches_jax_fused(monkeypatch, width, mode):
    """Both packages' fused engines at ``top_k=1`` on the same weights
    (JAX's, bridged), float32 compute and cache: the same tokens at every
    scale, ``f_hat`` within 1e-5 and images within 5e-5."""
    jcfg, jqp = _jax_params(width, mode)
    jvae = _jax_vae()
    jgen = JaxGenerator(jcfg, _jax_recipe(mode),
                        JaxGenerateConfig(top_k=1, top_p=0.0),
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32,
                        fuse_steps=True)
    jax_tokens, port_tokens = [], []
    jax_sample, port_sample = JV.sample_with_top_k_top_p, \
        V.sample_with_top_k_top_p

    def jax_rec(key, logits, top_k=0, top_p=0.0):
        idx = jax_sample(key, logits, top_k, top_p)
        jax.debug.callback(lambda v: jax_tokens.append(np.asarray(v)), idx,
                           ordered=True)
        return idx

    def port_rec(logits, top_k=0, top_p=0.0, generator=None, gumbel=None):
        assert generator is None and gumbel is not None   # the plan's
        idx = port_sample(logits, top_k, top_p, generator, gumbel)
        port_tokens.append(idx.numpy())
        return idx

    monkeypatch.setattr(JV, "sample_with_top_k_top_p", jax_rec)
    monkeypatch.setattr(V, "sample_with_top_k_top_p", port_rec)
    jf = jgen.generate(jqp, jvae, jnp.asarray(LABELS), jax.random.PRNGKey(2),
                       return_fhat=True)
    jimg = np.asarray(_jax_decode(jcfg.vae)(jvae, jf))
    jax.effects_barrier()

    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)
    gen = VARGenerator(cfg, bench_recipes()[mode],
                       GenerateConfig(top_k=1, top_p=0.0),
                       cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu")
    tqp = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    tvae = to_torch(jax.tree_util.tree_map(np.asarray, jvae), "cpu")
    tf = gen.generate(tqp, tvae, LABELS, _gen(0), return_fhat=True)
    assert len(jax_tokens) == len(port_tokens) == cfg.num_scales
    for si in range(cfg.num_scales):
        np.testing.assert_array_equal(port_tokens[si], jax_tokens[si],
                                      err_msg=f"scale {si}")
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    timg = gen.generate(tqp, tvae, LABELS, _gen(0))
    np.testing.assert_allclose(timg.numpy(), jimg, rtol=0, atol=5e-5)


def _jax_recipe(mode):
    from fpqvar_tpu.config import bench_recipes as jax_recipes

    return jax_recipes()[mode]


@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_fused_server_matches_eager_server(mode):
    """A request served by a fused generator at the serving tests' config:
    the same image alone and in a mixed batch (under the depth-2
    pipeline), and the eager server's image for the same request and base
    seed."""
    params = init_var_params(TINY, seed=0, device="cpu", adaln_gamma_std=0.02)
    vae = init_vqvae_params(TINY.vae, seed=1, device="cpu")
    q = bench_recipes()[mode]
    galt = tuple(np.ones((TINY.depth, TINY.width), np.float32)
                 for _ in range(2))
    if q.enabled:
        params = quantize_var_params(params, TINY, q, galt=galt)
    images = {}
    for fuse in (True, False):
        gen = VARGenerator(TINY, q, device="cpu", fuse_steps=fuse)
        srv = GenerationServer(gen, params, vae, max_batch=4, max_wait_ms=100)
        try:
            alone = srv.submit(3, seed=7).result(timeout=60)
            before = srv.stats()
            futs = [srv.submit(i % 8, seed=100 + i) for i in range(9)]
            futs.append(srv.submit(3, seed=7))
            imgs = [f.result(timeout=120) for f in futs]
            after = srv.stats()
        finally:
            srv.stop()
        assert torch.equal(imgs[-1], alone)
        assert after["served"] - before["served"] == 10
        assert after["pipelined"] > before["pipelined"]
        images[fuse] = (alone, imgs)
    assert torch.equal(images[True][0], images[False][0])
    for a, b in zip(images[True][1], images[False][1]):
        assert torch.equal(a, b)
