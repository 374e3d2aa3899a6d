"""The paper's recipes through the whole slice against the JAX package.

As in ``test_torch_generate.py``: JAX builds the ``var_tiny`` params
(``adaln_gamma_std=0.02``; width 192 with three heads for the full-size
rotation) and quantizes them with its ``quantize_var_params`` (seeded GALT
vectors); the port's own ``quantize_var_params`` on the bridged float
params must give the same tree bit for bit; both ``VARGenerator``s
generate at ``top_k=1`` with float32 compute and cache.  The tokens of
every scale must be identical, the CFG-mixed logits within ``LOGITS_ATOL``,
``f_hat`` within 1e-5 and the images within 5e-5.

Cases: ``fp4``, ``fp4_kv6`` (the dense fake KV cache, fp6_e2m3 per token
on append), ``fp6_kv6``, ``int4_rtn``, ``fp4_pertensor``; ``fp4`` with a
4-bit KV cache in ``kv_mode="reference"`` with the reference's grouping
(the cached prefix re-quantized at every scale step); ``int4_rtn`` with
log2 at fc2; ``fp4`` with mixed block formats (fp_e2, fp_e3) and with
``quantize_ada``; ``fp6`` with a full-size rotation at width 192;
``int8ch`` with a fake 6-bit KV cache; and a tiny ``shared_aln`` model
under ``bf16`` and under ``fp4_kv6`` with ``quantize_ada`` (the shared
AdaLN linear quantized).

Under ``fc2_log2`` the log2 quantizer's outputs differ from JAX's within a
relative 1e-5, with no log2 code moved (``test_torch_fake.py``).  The
difference reaches the next block's int4 activations, where a value at a
rounding boundary moves by a whole step (1/7 of its token's absmax): the
logits, of order 0.6, then differ by up to 2.1e-4, 7.6e-4 and 1.6e-3 at
the three scales of this generation, so that case holds them within
``LOGITS_ATOL["int4_rtn_log2"]`` (5e-3) and its tokens identical; every
other case keeps the float32-sum-order bound of 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu import config as JC
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.models.engine import VARGenerator as JaxGenerator
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize

from fpqvar_tpu_torch.config import (GenerateConfig, QuantConfig,
                                     bench_recipes, paper_recipes, var_tiny)
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_generate import LABELS, _jax_decode, _jax_vae
from test_torch_quant import _bits
from torch_threads import one_torch_thread  # noqa: F401

#: the sampler's logits bound by case (module docstring)
LOGITS_ATOL = {"int4_rtn_log2": 5e-3}


def _case(name):
    """(width, shared_aln, the port's recipe) of one case."""
    pr, width, shared = paper_recipes(), 128, False
    q = {"fp4_kv4_reference": pr["fp4"].replace(
             kv_bit=4, kv_mode="reference", kv_ref_grouping=True),
         "int4_rtn_log2": pr["int4_rtn"].replace(fc2_log2=True),
         "fp4_mixed": pr["fp4"].replace(mixed_act_formats=("fp_e2", "fp_e3")),
         "fp4_ada": pr["fp4"].replace(quantize_ada=True),
         "fp6_rot192": pr["fp6"].replace(block_rotate=False),
         "int8ch_kv6": bench_recipes()["int8ch"].replace(kv_bit=6),
         "shared_bf16": QuantConfig(),
         "shared_fp4_kv6_ada": pr["fp4_kv6"].replace(quantize_ada=True),
         }.get(name) or pr[name]
    if name == "fp6_rot192":
        width = 192
    if name.startswith("shared"):
        shared = True
    return width, shared, q


@functools.lru_cache(maxsize=None)
def _jax_float_params(width, shared):
    jcfg = dataclasses.replace(JC.var_tiny(), embed_dim=width,
                               num_heads=width // 64, shared_aln=shared)
    return jcfg, jax.jit(functools.partial(
        JV.init_var_params, cfg=jcfg, adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))


def _galt(depth, width):
    rng = np.random.default_rng(5)
    return tuple(np.exp(0.1 * rng.standard_normal((depth, width)))
                 .astype(np.float32) for _ in range(2))


def _same_tree(ours, theirs, where=""):
    """Two port trees hold the same bits in every leaf."""
    if isinstance(ours, dict):
        assert ours.keys() == theirs.keys(), where
        for k in ours:
            _same_tree(ours[k], theirs[k], f"{where}/{k}")
    elif isinstance(ours, torch.Tensor):
        assert (ours.dtype, ours.shape) == (theirs.dtype, theirs.shape), where
        assert ours.numpy().tobytes() == theirs.numpy().tobytes(), where
    elif dataclasses.is_dataclass(ours):          # IntPack, PackedTensor
        assert type(ours) is type(theirs), where
        for f in dataclasses.fields(ours):
            _same_tree(getattr(ours, f.name), getattr(theirs, f.name),
                       f"{where}.{f.name}")
    else:
        assert ours == theirs, where


@pytest.mark.parametrize("name", [
    "fp4", "fp4_kv6", "fp6_kv6", "int4_rtn", "fp4_pertensor",
    "fp4_kv4_reference", "int4_rtn_log2", "fp4_mixed", "fp4_ada",
    "fp6_rot192", "int8ch_kv6", "shared_bf16", "shared_fp4_kv6_ada"])
def test_paper_recipe_generation_matches_jax(monkeypatch, name):
    width, shared, q = _case(name)
    jq = JC.QuantConfig(**dataclasses.asdict(q))
    jcfg, jp = _jax_float_params(width, shared)
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64, shared_aln=shared)
    galt = _galt(cfg.depth, width)
    jqp = jax_quantize(jp, jcfg, jq, galt=galt) if jq.enabled else jp
    jvae = _jax_vae()

    jax_tokens, port_tokens, jax_logits, port_logits = [], [], [], []
    jax_sample = JV.sample_with_top_k_top_p
    port_sample = V.sample_with_top_k_top_p

    def jax_rec(key, logits, top_k=0, top_p=0.0):
        idx = jax_sample(key, logits, top_k, top_p)
        jax.debug.callback(
            lambda v, lg: (jax_tokens.append(np.asarray(v)),
                           jax_logits.append(np.asarray(lg))),
            idx, logits, ordered=True)
        return idx

    def port_rec(logits, top_k=0, top_p=0.0, generator=None, gumbel=None):
        idx = port_sample(logits, top_k, top_p, generator, gumbel)
        port_tokens.append(idx.numpy())
        port_logits.append(logits.numpy())
        return idx

    monkeypatch.setattr(JV, "sample_with_top_k_top_p", jax_rec)
    monkeypatch.setattr(V, "sample_with_top_k_top_p", port_rec)

    jgen = JaxGenerator(jcfg, jq, JC.GenerateConfig(top_k=1, top_p=0.0),
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    jf = jgen.generate(jqp, jvae, jnp.asarray(LABELS), jax.random.PRNGKey(2),
                       return_fhat=True)
    jimg = np.asarray(_jax_decode(jcfg.vae)(jvae, jf))
    jax.effects_barrier()

    tqp = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    tvae = to_torch(jax.tree_util.tree_map(np.asarray, jvae), "cpu")
    if shared:
        assert "shared_ada_lin" in tqp and "ada_gss" in tqp["blocks"]
        assert "ada_lin" not in tqp["blocks"]
    if q.enabled:
        ours = quantize_var_params(to_torch(jp, "cpu"), cfg, q, galt=galt)
        _same_tree(ours, tqp)
    gen = VARGenerator(cfg, q, GenerateConfig(top_k=1, top_p=0.0),
                       cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu")
    tf = gen.generate(tqp, tvae, LABELS, return_fhat=True)
    assert len(jax_tokens) == len(port_tokens) == cfg.num_scales
    for si in range(cfg.num_scales):
        np.testing.assert_array_equal(port_tokens[si], jax_tokens[si],
                                      err_msg=f"scale {si}")
        np.testing.assert_allclose(port_logits[si], jax_logits[si], rtol=0,
                                   atol=LOGITS_ATOL.get(name, 1e-5),
                                   err_msg=f"scale {si}")
    timg = gen.generate(tqp, tvae, LABELS)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    assert timg.shape == (3, 3, 6, 6) and timg.dtype == torch.float32
    np.testing.assert_allclose(timg.numpy(), jimg, rtol=0, atol=5e-5)


def test_bridge_carries_shared_adaln():
    """A JAX ``shared_aln`` tree (float and ``quantize_ada``-quantized)
    bridges to the port's layout: ``shared_ada_lin`` {w [6C, C], b} at the
    root, ``ada_gss`` [depth, 6, C] in the blocks, no ``ada_lin``; the
    port's own init has the same layout."""
    jcfg, jp = _jax_float_params(128, True)
    cfg = dataclasses.replace(var_tiny(), shared_aln=True)
    jqp = jax_quantize(jp, jcfg, JC.fpqvar_w4a4().replace(quantize_ada=True),
                       galt=_galt(2, 128))
    mine = V.init_var_params(cfg, seed=0, device="cpu")
    for tree in (to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu"),
                 to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu"),
                 mine):
        assert set(tree["shared_ada_lin"]) == {"w", "b"}
        assert tuple(tree["shared_ada_lin"]["w"].shape) == (768, 128)
        assert tuple(tree["blocks"]["ada_gss"].shape) == (2, 6, 128)
        assert "ada_lin" not in tree["blocks"]
    np.testing.assert_array_equal(
        _bits(to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")[
            "shared_ada_lin"]["w"].numpy()),
        _bits(np.asarray(jqp["shared_ada_lin"]["w"])))
    assert set(mine) == set(jp)
    assert set(mine["blocks"]) == set(jp["blocks"])
