"""The port's ``{dp, tp}`` mesh against the JAX package's mesh paths.

The JAX side runs here, on the 8 virtual CPU devices of ``conftest.py``
(a dp 2 x tp 2 mesh of the first four, ``parallel.make_mesh``).  The port
runs on gloo ranks, one process each (``torch_mesh_worker.py``, started
with torchrun's environment variables): four ranks once (the dp 2 x tp 2
mesh and a dp 4 mesh) and two ranks once (a tp 2 mesh), every case inside
those ranks.  Both sides take the same weights: JAX's, quantized by JAX
and carried over by ``utils/bridge.py``, at the width-256 config of
``tests/test_sharding.py``'s quantized TP test (2 heads, vocabulary 256),
so that every linear splits over tp = 2, and at width 128 (``var_tiny``),
where ``mat_qkv`` (N = 384) and ``proj`` (K = 128) fall back to a
replicated pack.

- Shards: on rank (d, t) every leaf of a float, an ``int8``, an
  ``int8ch`` (per channel: ``proj`` and ``fc2`` split their codes on K and
  replicate their one scale row) and a ``packed`` tree, and of the width-128
  ``int8`` and ``packed`` trees, equals JAX's ``shard_params`` shard on
  mesh device (d, t), carried over by the bridge (codes and scales bit for
  bit).
- Generation at ``top_k=1`` in float32 under ``bf16``, ``int8``,
  ``int8ch``, ``packed`` and ``int8kv`` on dp 2 x tp 2: the tokens of
  every scale equal JAX's ``VARGenerator(mesh=...)`` tokens (recorded
  through its sampler); ``f_hat`` within 1e-5 and the images within 5e-5
  of JAX's, the bounds of ``test_torch_generate.py`` (float32 sums in
  another order).  Against the port's own one-device run: the same
  tokens, the sampler's logits within 1e-5, ``f_hat`` and images within
  the bounds above.
- Exact cases.  At tp 2 (dp 1) ``f_hat`` and the images are ``torch.equal``
  to the one-device run under every recipe (they depend on the tokens
  alone).  The logits are not, even under ``int8ch`` and ``int8kv``, whose
  GEMMs are exact under tp (the column GEMMs' outputs are columns of the
  whole product, the row split sums int32 exactly): the CPU's attention
  einsum rounds its scores differently over one head than over two (at
  some shapes: ``[8, 4, H, 128] x [8, 5, H, 128]``, one thread), so they
  are held within 1e-5, as ``bf16``, ``int8`` and ``packed``, which also sum f32 partials
  in another order.  Once dp >= 2 nothing is exact on the CPU: its GEMMs
  and the VQVAE's convolutions round differently for another number of
  rows.
- Kernel calls per rank and generation (depth 2 x 3 scales = 6 block
  steps), counted at the wrappers (on the CPU they run their plain
  versions), as JAX routes a mesh (``int8_matmul.py:669-676, 706-719``):
  ``int8`` K1 5 a block step (qkv, proj, fc1 and fc2's two halves), K5 0;
  ``packed`` K2 4; ``int8ch`` / ``int8kv`` K3 2 a block step at tp 2 (the
  column splits; the row splits are the plain int32 product) and 5 at dp 4
  (tp 1), K4 0.  The KV cache of a rank holds its rows and heads: the
  one-device cache's batch dim divided by dp and its heads dim by tp.
- Sampling (the default top-k / top-p, ``bf16``) on dp 2 x tp 2 draws the
  one-device run's noise, with one generator for the batch and with one
  per row: the same tokens at every scale.
- A column linear's bias shard on tp 2 under each quantized route, with
  the pack split and with the pack whole while ``fc1_b`` splits.
- Errors: ``make_mesh`` on a world smaller than dp * tp raises
  ``ValueError``; a fused generator under a mesh ``NotImplementedError``.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from fpqvar_tpu.config import GenerateConfig as JaxGenerateConfig
from fpqvar_tpu.config import MeshConfig as JaxMeshConfig
from fpqvar_tpu.config import VARConfig as JaxVARConfig
from fpqvar_tpu.config import VQVAEConfig as JaxVQVAEConfig
from fpqvar_tpu.config import bench_recipes as jax_recipes
from fpqvar_tpu.config import var_tiny as jax_var_tiny
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.models import vqvae as Jvq
from fpqvar_tpu.models.engine import VARGenerator as JaxGenerator
from fpqvar_tpu.parallel import make_mesh as jax_make_mesh
from fpqvar_tpu.parallel import shard_params as jax_shard_params
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize

from fpqvar_tpu_torch.config import MeshConfig, bench_recipes
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor
from fpqvar_tpu_torch.parallel import Mesh, make_mesh
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_vqvae import _params as vqvae_params
from torch_mesh_worker import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

CFG = JaxVARConfig(
    depth=2, embed_dim=256, num_heads=2, patch_nums=(1, 2, 3),
    vae=JaxVQVAEConfig(vocab_size=256, z_channels=8, ch=16, ch_mult=(1, 2),
                       num_res_blocks=1, patch_nums=(1, 2, 3)))
RECIPES = ("bf16", "int8", "int8ch", "packed", "int8kv")
#: trees of the shard test: (recipe, width)
TREES = {"float": ("bf16", 256), "int8": ("int8", 256),
         "int8ch": ("int8ch", 256), "packed": ("packed", 256),
         "int8_w128": ("int8", 128), "packed_w128": ("packed", 128)}
LABELS = np.array([3, 5, 7, 9])
BLOCK_STEPS = CFG.depth * len(CFG.patch_nums)
#: kernel calls per rank and block step under a mesh, by recipe and mesh
CALLS = {("int8", "2x2"): {"K1": 5}, ("int8", "4x1"): {"K1": 5},
         ("packed", "2x2"): {"K2": 4}, ("packed", "4x1"): {"K2": 4},
         ("int8ch", "2x2"): {"K3": 2}, ("int8ch", "4x1"): {"K3": 5},
         ("int8kv", "2x2"): {"K3": 2}, ("int8kv", "4x1"): {"K3": 5},
         ("bf16", "2x2"): {}, ("bf16", "4x1"): {}}


def _cfg(width):
    if width == 256:
        return CFG
    return dataclasses.replace(jax_var_tiny(), embed_dim=width,
                               num_heads=width // 64)


@functools.lru_cache(maxsize=None)
def _jax_tree(recipe, width):
    jcfg = _cfg(width)
    jp = jax.jit(functools.partial(JV.init_var_params, cfg=jcfg,
                                   adaln_gamma_std=0.02))(
        jax.random.PRNGKey(1))
    q = jax_recipes()[recipe]
    if not q.enabled:
        return jp
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((jcfg.depth, width)))
                 .astype(np.float32) for _ in range(2))
    return jax_quantize(jp, jcfg, q, galt=galt)


@functools.lru_cache(maxsize=None)
def _jax_vae():
    return vqvae_params(CFG.vae)[0]


def _port(tree):
    return to_torch(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _port_cfg(width):
    from fpqvar_tpu_torch.config import VARConfig, VQVAEConfig

    j = _cfg(width)
    return VARConfig(depth=j.depth, embed_dim=j.embed_dim,
                     num_heads=j.num_heads, patch_nums=j.patch_nums,
                     vae=VQVAEConfig(**dataclasses.asdict(j.vae)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The port's results on four ranks (dp 2 x tp 2, dp 4) and on two
    (tp 2)."""
    trees = {name: _port(_jax_tree(*rw)) for name, rw in TREES.items()}
    base = dict(cfg=_port_cfg(256), vae=_port(_jax_vae()), trees=trees,
                recipes={r: bench_recipes()[r] for r in RECIPES},
                labels=torch.from_numpy(LABELS))
    four = [(f"shards-{n}", "shards", dict(tree=n, dp=2, tp=2))
            for n in TREES]
    four += [(f"gen-{r}-{m}", "generate",
              dict(tree="float" if r == "bf16" else r if r != "int8kv"
                   else "int8ch", recipe=r, dp=dp, tp=tp))
             for r in RECIPES for m, (dp, tp) in (("2x2", (2, 2)),
                                                  ("4x1", (4, 1)))]
    four += [(f"sampled-{g}", "generate",
              dict(tree="float", recipe="bf16", dp=2, tp=2, sampled=g))
             for g in ("one", "row")]
    four.append(("errors", "errors", {}))
    two = [(f"gen-{r}-1x2", "generate",
            dict(tree="float" if r == "bf16" else r if r != "int8kv"
                 else "int8ch", recipe=r, dp=1, tp=2)) for r in RECIPES]
    two += [(f"col-bias-{n}", "col_bias", dict(n=n)) for n in (128, 256)]
    tmp = tmp_path_factory.mktemp("mesh")
    return {4: run_ranks(4, dict(base, cases=four), str(tmp / "four")),
            2: run_ranks(2, dict(base, cases=two), str(tmp / "two"))}


def _jax_mesh():
    return jax_make_mesh(JaxMeshConfig(dp=2, tp=2))


def _jax_shard(leaf, device):
    return next(np.asarray(s.data) for s in leaf.addressable_shards
                if s.device == device)


def _same(ours, theirs, where):
    assert type(ours) is type(theirs), where
    if isinstance(ours, dict):
        assert ours.keys() == theirs.keys(), where
        for k in ours:
            _same(ours[k], theirs[k], f"{where}/{k}")
    elif isinstance(ours, list):
        assert len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _same(a, b, f"{where}/{i}")
    elif isinstance(ours, (IntPack, PackedTensor)):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if isinstance(a, torch.Tensor):
                assert a.shape == b.shape and a.dtype == b.dtype, where
                assert a.numpy().tobytes() == b.numpy().tobytes(), where
            else:
                assert a == b, (where, f.name)
    else:
        assert ours.shape == theirs.shape, where
        assert ours.numpy().tobytes() == theirs.numpy().tobytes(), where


@pytest.mark.parametrize("tree", list(TREES))
def test_shards_match_jax(ranks, tree):
    """Rank (d, t)'s shard of every leaf is JAX's shard on device (d, t)
    (module docstring)."""
    mesh = _jax_mesh()
    jsp = jax_shard_params(_jax_tree(*TREES[tree]), mesh)
    is_pack = (lambda x: hasattr(x, "codes") and hasattr(x, "group_size"))
    split = 0
    for rank in range(4):
        dev = mesh.devices[rank // 2, rank % 2]

        def local(leaf):
            if is_pack(leaf):
                return dataclasses.replace(
                    leaf, codes=_jax_shard(leaf.codes, dev),
                    scales=_jax_shard(leaf.scales, dev))
            return _jax_shard(leaf, dev)

        theirs = _port(jax.tree_util.tree_map(local, jsp, is_leaf=is_pack))
        ours = ranks[4][rank][f"shards-{tree}"]
        _same(ours, theirs, tree)
        full = _port(_jax_tree(*TREES[tree]))["blocks"]
        split += sum(ours["blocks"][k].codes.numel() < full[k].codes.numel()
                     if is_pack(full[k]) else
                     ours["blocks"][k].numel() < full[k].numel()
                     for k in ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w"))
    # width 128: mat_qkv and proj fall back to replicated packs
    assert split == 4 * (2 if tree.endswith("w128") else 4)


def _rows(results, name, key, si):
    """A mesh run's ``key`` at scale ``si``, the dp ranks' rows stacked."""
    dp = results[0][name]["rows"][1]
    tp = len(results) // dp
    return torch.cat([results[d * tp][name][key][si] for d in range(dp)])


@functools.lru_cache(maxsize=None)
def _jax_mesh_generation(recipe):
    """JAX's dp 2 x tp 2 generation: tokens per scale, f_hat, images."""
    tokens = []
    sample = JV.sample_with_top_k_top_p

    def rec(key, logits, top_k=0, top_p=0.0):
        idx = sample(key, logits, top_k, top_p)
        jax.debug.callback(lambda v: tokens.append(np.asarray(v)), idx)
        return idx

    mesh = _jax_mesh()
    tree = _jax_tree("bf16" if recipe == "bf16" else
                     "int8ch" if recipe == "int8kv" else recipe, 256)
    JV.sample_with_top_k_top_p = rec
    try:
        gen = JaxGenerator(CFG, jax_recipes()[recipe],
                           JaxGenerateConfig(top_k=1, top_p=0.0), mesh=mesh,
                           cache_dtype=jnp.float32, compute_dtype=jnp.float32)
        labels = jax.device_put(jnp.asarray(LABELS, jnp.int32),
                                NamedSharding(mesh, JP("dp")))
        with mesh:
            f = gen.generate(jax_shard_params(tree, mesh), _jax_vae(), labels,
                             jax.random.PRNGKey(2), return_fhat=True)
        f = np.asarray(f)
        jax.effects_barrier()
    finally:
        JV.sample_with_top_k_top_p = sample
    img = np.asarray(jax.jit(lambda p, x: (Jvq.decode(p, CFG.vae, x) + 1.0)
                             * 0.5)(_jax_vae(), f))
    return tokens, f, img


@pytest.mark.parametrize("recipe", RECIPES)
def test_mesh_generation_matches_jax(ranks, recipe):
    """dp 2 x tp 2 at top_k=1: JAX's mesh tokens, f_hat and images, and
    the port's one-device run (module docstring)."""
    res, name = ranks[4], f"gen-{recipe}-2x2"
    jtok, jf, jimg = _jax_mesh_generation(recipe)
    one = res[0][name]["one"]
    assert len(jtok) == len(one["tokens"]) == CFG.num_scales
    for si in range(CFG.num_scales):
        tok = _rows(res, name, "tokens", si)
        np.testing.assert_array_equal(tok.numpy(), jtok[si],
                                      err_msg=f"scale {si}")
        assert torch.equal(tok, one["tokens"][si]), si
        np.testing.assert_allclose(_rows(res, name, "logits", si).numpy(),
                                   one["logits"][si].numpy(), rtol=0,
                                   atol=1e-5)
    for r in res:                      # every rank holds the whole batch
        np.testing.assert_allclose(r[name]["f_hat"].numpy(), jf, rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(r[name]["images"].numpy(), jimg, rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(r[name]["images"].numpy(),
                                   one["images"].numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("generators", ["one", "row"])
def test_mesh_sampling_draws_the_one_device_noise(ranks, generators):
    """Sampled generation (top_k 900, top_p 0.96) on dp 2 x tp 2 with one
    generator for the batch (each rank keeps its rows of the whole
    batch's noise plan) or one per row (each rank takes its rows'): the
    one-device run's tokens at every scale."""
    res, name = ranks[4], f"sampled-{generators}"
    one = res[0][name]["one"]
    for si in range(CFG.num_scales):
        assert torch.equal(_rows(res, name, "tokens", si),
                           one["tokens"][si]), si
    np.testing.assert_allclose(res[0][name]["images"].numpy(),
                               one["images"].numpy(), rtol=0, atol=5e-5)


@pytest.mark.parametrize("recipe", RECIPES)
def test_tp_only_generation_exact(ranks, recipe):
    """tp 2, dp 1: f_hat and images ``torch.equal`` to the one-device run,
    the logits within 1e-5."""
    res, name = ranks[2], f"gen-{recipe}-1x2"
    for r in res:
        out, one = r[name], r[name]["one"]
        assert torch.equal(out["f_hat"], one["f_hat"])
        assert torch.equal(out["images"], one["images"])
        for si in range(CFG.num_scales):
            assert torch.equal(out["tokens"][si], one["tokens"][si])
            np.testing.assert_allclose(out["logits"][si].numpy(),
                                       one["logits"][si].numpy(), rtol=0,
                                       atol=1e-5)
        assert out["calls"] == {k: BLOCK_STEPS * n for k, n in {
            "K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
            **CALLS[(recipe, "2x2")]}.items()}


@pytest.mark.parametrize("recipe,mesh", sorted(CALLS))
def test_mesh_kernel_calls_and_cache(ranks, recipe, mesh):
    """Kernel calls per rank and generation, and each rank's KV cache
    (module docstring)."""
    dp, tp = (int(v) for v in mesh.split("x"))
    want = {k: BLOCK_STEPS * n for k, n in {
        "K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0,
        **CALLS[(recipe, mesh)]}.items()}
    # (batch dim, heads dim) of each cache leaf: the dense [depth, B, L,
    # H*c] cache, the packed codes [depth, B, H, L, c] and scales
    specs = ({k: (1, 2) for k in ("kc", "vc", "ks", "vs")}
             if recipe == "int8kv" else {k: (1, 3) for k in ("k", "v")})
    for r in ranks[4]:
        out = r[f"gen-{recipe}-{mesh}"]
        assert out["calls"] == want
        for key, (dd, td) in specs.items():
            whole = list(out["one"]["cache"][key])
            whole[dd] //= dp
            whole[td] //= tp
            assert out["cache"][key] == tuple(whole), key


@pytest.mark.parametrize("n", [128, 256])
def test_column_bias_shard(ranks, n):
    """A column linear's bias shard on tp 2, under each quantized route:
    at ``n = 256`` the pack splits and the shard is added to the rank's
    columns before their gather (within 1e-5: the CPU's products round
    differently for fewer columns); at ``n = 128`` the pack stays whole
    while ``fc1_b`` splits, as in JAX's specs, and the output equals the
    one-device linear's."""
    for r in ranks[2]:
        for name, (mesh_out, one, width) in r[f"col-bias-{n}"].items():
            assert width == n // 2, name
            if n == 128:
                assert torch.equal(mesh_out, one), name
            else:
                torch.testing.assert_close(mesh_out, one, rtol=0, atol=1e-5,
                                           msg=name)


def test_mesh_errors(ranks):
    errs = ranks[4][0]["errors"]
    assert "needs 8 ranks, have 4" in errs["make_mesh"]
    assert "ROADMAP" in errs["fused"]
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh(MeshConfig(dp=2, tp=1))     # no process group here
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VARGenerator(_port_cfg(256), bench_recipes()["int8"], device="cpu",
                     mesh=Mesh(dp=1, tp=1, rank=0))
