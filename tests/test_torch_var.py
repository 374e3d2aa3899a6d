"""The port's VAR transformer pieces and sampler against the JAX package.

Seeded numpy inputs go through both packages.  ``top_k_top_p_filter`` must
be bit-equal (ties at the k-th value included), and the sampler with the
same injected Gumbel noise must draw the same tokens.  One ``block_forward``
step with a KV cache runs under ``bf16`` (float weights) and ``int8``
(IntPack weights through the bridge) at width 128, where every linear has
one scale group, and at width 256, where the grouped route runs: float32
matmuls sum in another order, so the block output and the cache rows agree
within 2e-5 (values of order 1).  One more step runs the ``packed`` recipe
(PackedTensor weights through K2's plain version) at width 256 and
bfloat16 compute, as generation does on the card: JAX's CPU path rounds
``grid * scale`` to bfloat16 before one dense product, where the port
takes exact grid values and scales each group's float32 partial, so the
two differ by bfloat16 roundings (8 significant bits): within 2^-7 of each
value plus 2^-8.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import bench_recipes as jax_recipes
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import sampling as JS
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize
from fpqvar_tpu.quantize.runtime import build_runtime as jax_runtime

from fpqvar_tpu_torch.config import bench_recipes, var_tiny
from fpqvar_tpu_torch.models import sampling as S
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor
from fpqvar_tpu_torch.quantize import build_runtime, quantize_var_params
from fpqvar_tpu_torch.utils.bridge import to_torch


def _logits(seed, rows=3, vocab=4096):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, vocab)) * 3.0).astype(np.float32)
    # ties at the k-th (900th largest) value: copy it to a few more slots
    for r in range(rows):
        kth = np.sort(x[r])[vocab - 900]
        x[r, rng.choice(vocab, 4, replace=False)] = kth
    return x


@pytest.mark.parametrize("top_k,top_p", [(900, 0.96), (900, 0.0), (0, 0.96),
                                         (1, 0.0)])
def test_top_k_top_p_filter_bit_equal(top_k, top_p):
    x = _logits(0)
    theirs = jax.jit(functools.partial(
        JS.top_k_top_p_filter, top_k=top_k, top_p=top_p))(jnp.asarray(x))
    ours = S.top_k_top_p_filter(torch.from_numpy(x), top_k, top_p)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_sampler_with_injected_gumbel_noise():
    x = _logits(1, rows=8)
    key = jax.random.PRNGKey(7)
    theirs = np.asarray(jax.jit(functools.partial(
        JS.sample_with_top_k_top_p, top_k=900, top_p=0.96))(
        key, jnp.asarray(x)))
    noise = np.asarray(jax.random.gumbel(key, x.shape, jnp.float32))
    ours = S.sample_with_top_k_top_p(torch.from_numpy(x), 900, 0.96,
                                     gumbel=torch.from_numpy(noise.copy()))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    # from a torch.Generator: the draw stays inside the filtered set
    gen = torch.Generator().manual_seed(0)
    drawn = S.sample_with_top_k_top_p(torch.from_numpy(x), 900, 0.96, gen)
    filt = S.top_k_top_p_filter(torch.from_numpy(x), 900, 0.96)
    assert torch.isfinite(filt.gather(1, drawn[:, None])).all()


def test_per_row_sampler_and_gumbel_softmax_with_injected_noise():
    """``gumbel_softmax`` (the soft form generation uses) against JAX's on
    JAX's own noise for the key, within float32 rounding of the softmax
    (values in [0, 1]); the per-row sampler draws row i from generator i
    alone, and injected per-row noise still gives JAX's per-row tokens."""
    x = _logits(2, rows=4)
    key = jax.random.PRNGKey(8)
    for tau in (0.27, 0.0135):
        theirs = np.asarray(jax.jit(functools.partial(
            JS.gumbel_softmax, tau=tau))(key, jnp.asarray(x)))
        noise = np.asarray(jax.random.gumbel(key, x.shape, jnp.float32))
        ours = S.gumbel_softmax(torch.from_numpy(x), tau,
                                gumbel=torch.from_numpy(noise.copy()))
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    theirs = np.asarray(jax.vmap(lambda kk, lg: JS.sample_with_top_k_top_p(
        kk, lg, 900, 0.96))(keys, jnp.asarray(x)))
    noise = np.stack([np.asarray(jax.random.gumbel(kk, x.shape[1:],
                                                   jnp.float32))
                      for kk in keys])
    ours = S.sample_with_top_k_top_p(torch.from_numpy(x), 900, 0.96,
                                     gumbel=torch.from_numpy(noise))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    gens = [torch.Generator().manual_seed(s) for s in (1, 2, 3, 4)]
    rows = S.gumbel_noise((4, 7), gens, "cpu")
    alone = S.gumbel_noise((1, 7), [torch.Generator().manual_seed(3)], "cpu")
    assert torch.equal(rows[2], alone[0])
    with pytest.raises(ValueError, match="generators"):
        S.gumbel_noise((3, 7), gens, "cpu")


@functools.lru_cache(maxsize=None)
def _float_params(width):
    jcfg = dataclasses.replace(jax_var_tiny(), embed_dim=width,
                               num_heads=width // 64)
    return jcfg, jax.jit(functools.partial(
        JV.init_var_params, cfg=jcfg, adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _setup(width, mode):
    jcfg, jparams = _float_params(width)
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, width)))
                 .astype(np.float32) for _ in range(2))
    jq, q = jax_recipes()[mode], bench_recipes()[mode]
    jqp = jax_quantize(jparams, jcfg, jq, galt=galt) if jq.enabled else jparams
    tqp = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    jrt = jax_runtime(jq, jcfg.depth, jcfg.width)
    return jcfg, cfg, jqp, tqp, jrt, build_runtime(q, cfg.depth, cfg.width,
                                                   device="cpu")


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_block_forward_step_with_cache(width, mode):
    jcfg, cfg, jqp, tqp, jrt, qrt = _setup(width, mode)
    if mode == "int8":
        assert isinstance(tqp["blocks"]["fc2_w"], IntPack)
    b, cur, l, c, L = 2, 5, 9, cfg.width, cfg.L      # the last scale, pn 3
    rng = np.random.default_rng(6)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    mod = (rng.standard_normal((6, b, 1, c)) * 0.1).astype(np.float32)
    kc = np.zeros((b, L, c), np.float32)
    vc = np.zeros((b, L, c), np.float32)
    kc[:, :cur] = rng.standard_normal((b, cur, c))
    vc[:, :cur] = rng.standard_normal((b, cur, c))
    i = 1
    jbp = jax.tree_util.tree_map(lambda a: a[i], jqp["blocks"])

    @jax.jit
    def theirs_fn(x, mod, kc, vc):
        return JV.block_forward(x, jbp, mod, jrt, jcfg,
                                {"k": kc, "v": vc}, cur)[:2]

    jx, upd = theirs_fn(*map(jnp.asarray, (x, mod, kc, vc)))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    ours = V.block_forward(torch.from_numpy(x), V.block_params(tqp["blocks"], i),
                           torch.from_numpy(mod), qrt, cfg, cache, cur)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jx), rtol=0, atol=2e-5)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name][:, cur:cur + l].numpy(),
                                   np.asarray(upd[name][0]), rtol=0, atol=2e-5)
        np.testing.assert_array_equal(cache[name][:, :cur].numpy(),
                                      (kc if name == "k" else vc)[:, :cur])


def test_packed_block_forward_bf16():
    jcfg, cfg, jqp, tqp, jrt, qrt = _setup(256, "packed")
    assert isinstance(tqp["blocks"]["fc1_w"], PackedTensor)
    b, cur, l, c, L = 2, 5, 9, cfg.width, cfg.L
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, l, c)).astype(np.float32)
    mod = (rng.standard_normal((6, b, 1, c)) * 0.1).astype(np.float32)
    kc = np.zeros((b, L, c), np.float32)
    vc = np.zeros((b, L, c), np.float32)
    kc[:, :cur] = rng.standard_normal((b, cur, c))
    vc[:, :cur] = rng.standard_normal((b, cur, c))
    i = 1
    jbp = jax.tree_util.tree_map(lambda a: a[i], jqp["blocks"])

    @jax.jit
    def theirs_fn(x, mod, kc, vc):
        return JV.block_forward(x, jbp, mod, jrt, jcfg,
                                {"k": kc, "v": vc}, cur)[:2]

    jx, upd = theirs_fn(*(jnp.asarray(a).astype(jnp.bfloat16)
                          for a in (x, mod, kc, vc)))

    def bf16(a):
        return torch.from_numpy(a).to(torch.bfloat16)

    cache = {"k": bf16(kc), "v": bf16(vc)}
    ours = V.block_forward(bf16(x), V.block_params(tqp["blocks"], i),
                           bf16(mod), qrt, cfg, cache, cur)
    assert ours.dtype == torch.bfloat16

    def close(a, b):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   rtol=2 ** -7, atol=2 ** -8)

    close(ours, jx)
    close(cache["k"][:, cur:cur + l], upd["k"][0])
    close(cache["v"][:, cur:cur + l], upd["v"][0])


def test_prepare_generation_and_head_match_jax():
    jcfg, cfg, jqp, tqp, _, _ = _setup(128, "bf16")
    labels = np.array([3, 5, 999])
    jc, jm, jl, jf = JV.prepare_generation(jqp, jcfg, jnp.asarray(labels))
    tc, tm, tl, tf = V.prepare_generation(tqp, cfg, torch.from_numpy(labels))
    for ours, theirs in ((tc, jc), (tm, jm), (tl, jl), (tf, jf)):
        assert tuple(ours.shape) == tuple(theirs.shape)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0,
                                   atol=1e-6)
    x = np.random.default_rng(7).standard_normal((6, 4, cfg.width)
                                                 ).astype(np.float32)
    np.testing.assert_allclose(
        V.head_logits(tqp, cfg, torch.from_numpy(x), tc).numpy(),
        np.asarray(JV.head_logits(jqp, jcfg, jnp.asarray(x), jc)),
        rtol=0, atol=1e-5)


def test_runtime_rejects_unported_recipes():
    """The recipes the port once refused now build as JAX's do (a full-size
    rotation, mixed formats, the pure INT recipe, a fake KV cache under the
    int8 backends); a full-size rotation without ``width`` and mixed
    formats without ``depth`` are ``ValueError``s in both.  The refusals
    left are JAX's: a packed ``int_sym`` KV cache (``NotImplementedError``,
    as JAX's ``_build_kv``) and ``attn_int8`` without a packed value-codes
    cache (``ValueError``, as JAX's ``_check_attn_int8``)."""
    fake, jfake = bench_recipes()["fake"], jax_recipes()["fake"]
    for kw in ({"block_rotate": False},
               {"mixed_act_formats": ("fp_e2", "fp_e1")},
               {"int_quant": True}):
        rt = build_runtime(fake.replace(**kw), 2, 128, device="cpu")
        jrt = jax_runtime(jfake.replace(**kw), 2, 128)
        assert rt.act_fmts == jrt.act_fmts
        assert rt.mixed_idx == jrt.mixed_idx
        assert (rt.rotation_full is None) == (jrt.rotation_full is None)
        if "int_quant" not in kw:
            with pytest.raises(ValueError):
                build_runtime(fake.replace(**kw), device="cpu")
            with pytest.raises(ValueError):
                jax_runtime(jfake.replace(**kw))
    for name in ("int8", "int8ch"):
        rt = build_runtime(bench_recipes()[name].replace(kv_bit=4),
                           device="cpu")
        jrt = jax_runtime(jax_recipes()[name].replace(kv_bit=4), 2, 128)
        assert rt.kv_q is not None and jrt.kv_q is not None
        assert rt.kv_codec is None and jrt.kv_codec is None
    # the same refusals as JAX's runtime
    for name, kw, err in (
            ("int8ch", {"kv_bit": 8, "kv_backend": "packed"},
             NotImplementedError),
            ("int8ch", {"attn_int8": True}, ValueError),
            ("int8kv", {"kv_format": "fp6_e3m2", "attn_int8": True},
             ValueError)):
        with pytest.raises(err):
            build_runtime(bench_recipes()[name].replace(**kw), device="cpu")
        with pytest.raises(err):
            jax_runtime(jax_recipes()[name].replace(**kw), 2, 128)
    # per-token activations pair with per-channel weights, as in JAX
    with pytest.raises(ValueError, match="per-token"):
        build_runtime(bench_recipes()["int8"].replace(act_quant="per_token"),
                      device="cpu")
    rt = build_runtime(bench_recipes()["int8"], device="cpu")
    assert rt.act_fmts == {"mat_qkv": "fp_e2", "proj": "fp_e2",
                           "fc1": "fp_e2", "fc2": "fp_e1m2_neg_e2m1_pos"}
    assert rt.transform and tuple(rt.rotation_block.shape) == (128, 128)
    assert all(v is None for v in rt.act_q.values())
    for mode in ("fake", "packed"):
        rt = build_runtime(bench_recipes()[mode], device="cpu")
        assert all(callable(v) for v in rt.act_q.values()), mode
        assert rt.transform and rt.rotation_block is not None
    rt = build_runtime(bench_recipes()["w4a16p"], device="cpu")
    assert all(v is None for v in rt.act_q.values())
    assert not rt.transform and rt.rotation_block is None
