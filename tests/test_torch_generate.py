"""The whole slice against the JAX package: class labels -> images.

JAX builds the params (``init_var_params(PRNGKey(0), cfg,
adaln_gamma_std=0.02)``; the VQVAE in ``init_vqvae_params``'s layout with
seeded values), quantizes them with its
``quantize_var_params`` (seeded GALT vectors), the bridge carries them
over (the port's own ``quantize_var_params`` on the bridged float params
must give the same weights bit for bit: codes and scale bits, or the
dequantized floats of ``fake``), and both ``VARGenerator``s generate at
``top_k=1`` (argmax: no RNG)
with float32 compute and cache.  The tokens of every scale must be
identical; the CFG-mixed logits that the sampler sees (values of order 1)
and ``f_hat`` (of order 0.1) must agree within 1e-5 and the images (in
[0, 1]) within 5e-5, the float32 sums running in another order.
Width 128 sends the ``int8`` linears through one scale group (JAX's
``_channel_dot`` route; the port's K4), width 256 through the grouped
route.  The per-channel recipes (``int8ch`` at width 128, ``int8chs`` at
256, ``int8chsnr``, and the weights-only ``w4a16`` at 128) run K4's and
K3's plain versions and ``wonly_dot``.  The
``packed`` recipe (fp4 nibble codes through K2's plain version) runs at
both widths, so that every linear also has more than one scale group;
``w4a16p`` (packed weights, unquantized activations), ``fake`` (dequantized
weights, fake-quantized activations), W6A6 on the packed backend
(``w6a6p`` here: fp6 byte codes) and W4A4 on the packed backend with fp_e1
weight nibbles (``w4a4p_e1``: no in-kernel decoder, JAX's dequantize
route) at width 128.  The packed-KV recipes ``int8kv`` (``int8ch`` with a
cache of fp_e2 value codes, attention over the codes), ``int8att`` (both
attention products over int8 codes) and ``int8kv_e3m2`` (``int8kv`` with a
6-bit fp6_e3m2 cache: grid indices, decoded before attention) run at
width 128.  In ``int8kv_e3m2`` the decoded cache values are multiples of
their row's scale that sit exactly on midpoints of the next linear's fp_e2
activation grid (a value of 3.5 of the cache's largest 28 lands on 0.75,
between 0.5 and 1), so a last-bit difference in a cache scale (the keys
and values come out of float32 sums in another order) moves one
activation code by one grid step; at scale 0 that step moves logits by
1.4e-5, and the case holds its logits within ``LOGITS_ATOL`` (5e-5, a few
such steps); tokens, ``f_hat`` and images keep the bounds above.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import GenerateConfig as JaxGenerateConfig
from fpqvar_tpu.config import bench_recipes as jax_recipes
from fpqvar_tpu.config import fpqvar_w4a4 as jax_w4a4
from fpqvar_tpu.config import fpqvar_w6a6 as jax_w6a6
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.models import vqvae as Jvq
from fpqvar_tpu.models.engine import VARGenerator as JaxGenerator
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize
from fpqvar_tpu.utils.checkpoint import save_params

from fpqvar_tpu_torch.config import (GenerateConfig, bench_recipes,
                                     fpqvar_w4a4, fpqvar_w6a6, var_tiny)
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_vqvae import _params as vqvae_params
from torch_threads import one_torch_thread  # noqa: F401

LABELS = np.array([3, 5, 998])
#: the sampler's logits bound by recipe (module docstring)
LOGITS_ATOL = {"int8kv_e3m2": 5e-5}
#: quantized weight leaf of each recipe's block linears (None: floats)
LEAF = {"bf16": None, "fake": None, "int8": IntPack, "packed": PackedTensor,
        "w4a16p": PackedTensor, "w6a6p": PackedTensor,
        "w4a4p_e1": PackedTensor, "int8ch": IntPack,
        "int8chs": IntPack, "int8chsnr": IntPack, "w4a16": IntPack,
        "int8kv": IntPack, "int8att": IntPack, "int8kv_e3m2": IntPack}


def _recipe(mode, jax_side=False):
    """A recipe of ``bench_recipes``, ``w6a6p`` (W6A6 on the packed
    backend, as the JAX package's tests write it), ``w4a4p_e1`` (W4A4 on
    the packed backend with fp_e1 weights, a format K2 does not decode) or
    ``int8kv_e3m2`` (``int8kv`` with a 6-bit fp6_e3m2 KV cache, a grid
    without value codes)."""
    if mode == "w6a6p":
        return (jax_w6a6() if jax_side else fpqvar_w6a6()).replace(
            backend="packed")
    if mode == "w4a4p_e1":
        return (jax_w4a4() if jax_side else fpqvar_w4a4()).replace(
            backend="packed", weight_format="fp_e1")
    if mode == "int8kv_e3m2":
        return (jax_recipes() if jax_side else bench_recipes())[
            "int8kv"].replace(kv_format="fp6_e3m2", kv_bit=6)
    return (jax_recipes() if jax_side else bench_recipes())[mode]


@functools.lru_cache(maxsize=None)
def _jax_vae():
    """The var_tiny VQVAE in the layout of JAX's ``init_vqvae_params``,
    with the seeded values of ``test_torch_vqvae`` (the JAX init itself
    costs about 9 s on the CPU, and only its layout matters here)."""
    return vqvae_params(jax_var_tiny().vae)[0]


@functools.lru_cache(maxsize=None)
def _jax_decode(vae_cfg):
    """JAX's images from ``f_hat``, jitted once for all the tests."""
    return jax.jit(lambda p, f: (Jvq.decode(p, vae_cfg, f) + 1.0) * 0.5)


@functools.lru_cache(maxsize=None)
def _jax_float_params(width):
    jcfg = dataclasses.replace(jax_var_tiny(), embed_dim=width,
                               num_heads=width // 64)
    return jcfg, jax.jit(functools.partial(
        JV.init_var_params, cfg=jcfg, adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))


def _galt(depth, width):
    rng = np.random.default_rng(5)
    return tuple(np.exp(0.1 * rng.standard_normal((depth, width)))
                 .astype(np.float32) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _jax_params(width, mode):
    jcfg, jp = _jax_float_params(width)
    jq = _recipe(mode, jax_side=True)
    return jcfg, (jax_quantize(jp, jcfg, jq, galt=_galt(jcfg.depth, width))
                  if jq.enabled else jp)


def _assert_same_weights(ours, theirs):
    """The block linears of two port trees hold the same bits: float
    tensors, or every field of their IntPack / PackedTensor leaves."""
    for key in ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w"):
        o, t = ours[key], theirs[key]
        assert type(o) is type(t), key
        pairs = ([(o, t)] if isinstance(o, torch.Tensor) else
                 [(getattr(o, f.name), getattr(t, f.name))
                  for f in dataclasses.fields(o)])
        for a, b in pairs:
            if isinstance(a, torch.Tensor):
                assert (a.dtype, a.shape) == (b.dtype, b.shape), key
                assert a.numpy().tobytes() == b.numpy().tobytes(), key
            else:
                assert a == b, key


@pytest.mark.parametrize("width,mode", [
    (128, "bf16"), (128, "int8"), (256, "int8"), (128, "packed"),
    (256, "packed"), (128, "w4a16p"), (128, "fake"), (128, "w6a6p"),
    (128, "w4a4p_e1"),
    (128, "int8ch"), (256, "int8chs"), (128, "int8chsnr"), (128, "w4a16"),
    (128, "int8kv"), (128, "int8att"), (128, "int8kv_e3m2")])
def test_generation_matches_jax(monkeypatch, width, mode):
    jcfg, jqp = _jax_params(width, mode)
    jvae = _jax_vae()
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)

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

    jgen = JaxGenerator(jcfg, _recipe(mode, jax_side=True),
                        JaxGenerateConfig(top_k=1, top_p=0.0),
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    jf = jgen.generate(jqp, jvae, jnp.asarray(LABELS), jax.random.PRNGKey(2),
                       return_fhat=True)
    jimg = np.asarray(_jax_decode(jcfg.vae)(jvae, jf))
    jax.effects_barrier()

    tqp = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    tvae = to_torch(jax.tree_util.tree_map(np.asarray, jvae), "cpu")
    for key in ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w"):
        leaf = tqp["blocks"][key]
        assert (type(leaf) is LEAF[mode] if LEAF[mode]
                else isinstance(leaf, torch.Tensor)), key
    if _recipe(mode).enabled:
        # the port's own recipe (fold, float64 rotation, quantize) gives
        # JAX's quantized weights bit for bit
        ours = quantize_var_params(to_torch(_jax_float_params(width)[1], "cpu"),
                                   cfg, _recipe(mode),
                                   galt=_galt(cfg.depth, width))
        _assert_same_weights(ours["blocks"], tqp["blocks"])
    gen = VARGenerator(cfg, _recipe(mode),
                       GenerateConfig(top_k=1, top_p=0.0),
                       cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu")
    tf = gen.generate(tqp, tvae, LABELS, return_fhat=True)
    assert len(jax_tokens) == len(port_tokens) == cfg.num_scales
    for si in range(cfg.num_scales):
        np.testing.assert_array_equal(port_tokens[si], jax_tokens[si],
                                      err_msg=f"scale {si}")
        np.testing.assert_allclose(port_logits[si], jax_logits[si], rtol=0,
                                   atol=LOGITS_ATOL.get(mode, 1e-5),
                                   err_msg=f"scale {si}")
    timg = gen.generate(tqp, tvae, LABELS)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=0, atol=1e-5)
    assert timg.shape == (3, 3, 6, 6) and timg.dtype == torch.float32
    np.testing.assert_allclose(timg.numpy(), jimg, rtol=0, atol=5e-5)


def test_more_smooth_generation_matches_jax(monkeypatch):
    """``more_smooth``: each scale blends the codebook by a Gumbel-softmax
    of the CFG logits (the drawn index is dropped).  JAX runs its fused
    generation from one key; the port gets the blend noise JAX draws,
    rebuilt from that key's splits (``fold_in(key, 0)``, then per scale one
    split for the sample and one for the blend).  At width 128 ``bf16``,
    float32 compute, ``f_hat`` and the images are held to the default
    mode's bounds (1e-5 and 5e-5): the float32 sums run in another
    order."""
    width, mode = 128, "bf16"
    jcfg, jqp = _jax_params(width, mode)
    jvae = _jax_vae()
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)
    key = jax.random.PRNGKey(4)
    jgen = JaxGenerator(jcfg, _recipe(mode, jax_side=True),
                        JaxGenerateConfig(more_smooth=True),
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    jf = np.asarray(jgen.generate(jqp, jvae, jnp.asarray(LABELS), key,
                                  return_fhat=True))
    noise, k = [], jax.random.fold_in(key, 0)
    for pn in cfg.patch_nums:
        k, _ = jax.random.split(k)                 # the sample's key
        k, k2 = jax.random.split(k)                # the blend's key
        noise.append(np.asarray(jax.random.gumbel(
            k2, (len(LABELS), pn * pn, cfg.vae.vocab_size), jnp.float32)))
    port_soft = V.gumbel_softmax
    taken = []

    def soft_rec(logits, tau, generator=None, gumbel=None):
        g = torch.from_numpy(noise[len(taken)].copy())
        taken.append(tau)
        return port_soft(logits, tau, gumbel=g)

    monkeypatch.setattr(V, "gumbel_softmax", soft_rec)
    gen = VARGenerator(cfg, _recipe(mode),
                       GenerateConfig(more_smooth=True),
                       cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu")
    tf = gen.generate(to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu"),
                      to_torch(jax.tree_util.tree_map(np.asarray, jvae),
                               "cpu"), LABELS, torch.Generator().manual_seed(0),
                      return_fhat=True)
    assert len(taken) == cfg.num_scales
    np.testing.assert_allclose(taken, [max(0.27 * (1 - r * 0.95), 0.005)
                                       for r in (0.0, 0.5, 1.0)])
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-5)
    timg = (V.vq.decode(to_torch(jax.tree_util.tree_map(np.asarray, jvae),
                                 "cpu"), cfg.vae, tf) + 1.0) * 0.5
    jimg = np.asarray(_jax_decode(jcfg.vae)(jvae, jnp.asarray(jf)))
    np.testing.assert_allclose(timg.numpy(), jimg, rtol=0, atol=5e-5)


def test_bridge_reads_save_params_files(tmp_path):
    """The flat npz of ``utils/checkpoint.save_params`` bridges to the same
    tensors as the nested tree (IntPack leaves and empty lists included)."""
    _, jqp = _jax_params(128, "int8")
    tree = {"var": jqp, "vae": _jax_vae()}
    save_params(str(tmp_path / "p.npz"), tree)
    flat = to_torch(dict(np.load(tmp_path / "p.npz")), "cpu")
    nested = to_torch(jax.tree_util.tree_map(np.asarray, tree), "cpu")

    def same(a, b, where=""):
        assert type(a) is type(b), where
        if isinstance(a, dict):
            assert a.keys() == b.keys(), where
            for k in a:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}/{i}")
        elif isinstance(a, IntPack):
            assert (a.fmt, a.shape, a.group_size) == (
                b.fmt, b.shape, b.group_size), where
            assert torch.equal(a.codes, b.codes), where
            assert torch.equal(a.scales, b.scales), where
        else:
            assert torch.equal(a, b), where

    same(flat, nested)
    pack = nested["var"]["blocks"]["fc1_w"]
    # JAX codes [d, K, N] arrive in the port's [d, N, K] layout
    assert tuple(pack.codes.shape) == (2, 512, 128)
    assert tuple(pack.scales.shape) == (2, 1, 512)
    assert nested["vae"]["decoder"]["up"][0]["attn"] == []


def test_bridge_carries_packed_trees(tmp_path):
    """A JAX ``packed`` tree, nested and through the ``save_params`` npz,
    becomes the port's PackedTensor leaves with JAX's exact codes (the
    nibble bytes keep their ``[d, N/2, K]`` layout; the scales arrive
    transposed to ``[d, G, N]``), never IntPacks."""
    _, jqp = _jax_params(128, "packed")
    save_params(str(tmp_path / "p.npz"), jqp)
    nested = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    flat = to_torch(dict(np.load(tmp_path / "p.npz")), "cpu")
    for key in ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w"):
        theirs = jqp["blocks"][key]
        for tree in (nested, flat):
            ours = tree["blocks"][key]
            assert type(ours) is PackedTensor, key
            assert (ours.fmt, ours.shape, ours.group_size,
                    ours.nibble_packed) == (theirs.fmt, theirs.shape,
                                            theirs.group_size, True), key
            np.testing.assert_array_equal(ours.codes.numpy(),
                                          np.asarray(theirs.codes))
            np.testing.assert_array_equal(
                ours.scales.numpy(), np.swapaxes(np.asarray(theirs.scales),
                                                 -1, -2))
    assert tuple(nested["blocks"]["fc1_w"].codes.shape) == (2, 256, 128)
    assert tuple(nested["blocks"]["fc1_w"].scales.shape) == (2, 1, 512)


def test_bridge_carries_per_channel_intpacks(tmp_path):
    """A JAX per-channel ``int8ch`` tree (codes ``[d, K, N]``, scales
    ``[d, 1, N]``), nested and through the ``save_params`` npz, becomes the
    port's IntPack leaves with JAX's exact codes in ``[d, N, K]`` and its
    scales as they are, one group per layer."""
    _, jqp = _jax_params(128, "int8ch")
    save_params(str(tmp_path / "p.npz"), jqp)
    nested = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    flat = to_torch(dict(np.load(tmp_path / "p.npz")), "cpu")
    for key, k in (("mat_qkv_w", 128), ("proj_w", 128), ("fc1_w", 128),
                   ("fc2_w", 512)):
        theirs = jqp["blocks"][key]
        assert theirs.group_size == k and theirs.scales.shape[-2] == 1, key
        for tree in (nested, flat):
            ours = tree["blocks"][key]
            assert type(ours) is IntPack, key
            assert (ours.fmt, ours.shape, ours.group_size) == (
                theirs.fmt, theirs.shape, theirs.group_size), key
            np.testing.assert_array_equal(
                ours.codes.numpy(), np.swapaxes(np.asarray(theirs.codes),
                                                -1, -2))
            np.testing.assert_array_equal(ours.scales.numpy(),
                                          np.asarray(theirs.scales))
    assert tuple(nested["blocks"]["fc2_w"].codes.shape) == (2, 128, 512)
    assert tuple(nested["blocks"]["fc2_w"].scales.shape) == (2, 1, 128)
