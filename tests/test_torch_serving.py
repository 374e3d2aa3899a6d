"""The serving path of the port against the JAX package.

``GenerationServer`` and per-row generators on the CPU, at the tiny config
of ``tests/test_serving.py``: the four server tests of that file (a
request's image is the same whatever it is batched with, exactly; requests
coalesce into batches; a burst runs the depth-2 pipeline), and a row's
image depends only on its own generator (exactly, as
``tests/test_var_model.py::test_per_row_keys_batch_independent``).  Then
the port's server against JAX's ``GenerationServer`` on the same weights
at width 256 under ``int8`` (every grouped linear has two scale groups and
runs K5's plain version), ``top_k=1`` (argmax: no RNG) and float32 compute:
images within 5e-5, as ``test_torch_generate.test_generation_matches_jax``
holds whole generations (the float32 sums run in another order).  Under
``int8att`` (the packed KV cache and attention over int8 codes) a request
served in a mixed batch equals, exactly, the same request served alone:
the KV codec and the q and softmax-weight quantizers work per row, and
the integer contractions are exact.  The serving bench's Poisson phase
reads every completion time only once it is stamped.
"""
import dataclasses
import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.config import GenerateConfig as JaxGenerateConfig
from fpqvar_tpu.models.engine import VARGenerator as JaxGenerator
from fpqvar_tpu.serving import GenerationServer as JaxServer

from fpqvar_tpu_torch.config import (PATCH_NUMS_512, GenerateConfig,
                                     QuantConfig, VARConfig, VQVAEConfig,
                                     bench_recipes, paper_recipes, var_tiny)
from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                     init_vqvae_params)
from fpqvar_tpu_torch.ops import int8_matmul as K
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.serving import GenerationServer, row_seed
from fpqvar_tpu_torch.tools import serving_bench
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_generate import _jax_params, _jax_vae, _recipe
from torch_threads import one_torch_thread  # noqa: F401

TINY = VARConfig(
    depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2), num_classes=8,
    vae=VQVAEConfig(vocab_size=32, z_channels=8, ch=16, ch_mult=(1, 2),
                    num_res_blocks=1, patch_nums=(1, 2)),
)


@pytest.fixture(scope="module")
def tiny_model():
    params = init_var_params(TINY, seed=0, device="cpu",
                             adaln_gamma_std=0.02)
    vae = init_vqvae_params(TINY.vae, seed=1, device="cpu")
    return params, vae


@pytest.fixture(scope="module")
def server(tiny_model):
    params, vae = tiny_model
    gen = VARGenerator(TINY, QuantConfig(), device="cpu")
    srv = GenerationServer(gen, params, vae, max_batch=4, max_wait_ms=100)
    yield srv
    srv.stop()


def test_single_request(server):
    img = server.submit(3, seed=1).result(timeout=60)
    assert img.shape == (3, 4, 4) and img.dtype == torch.float32
    assert img.device.type == "cpu"
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0


def test_same_request_reproducible_across_batch_mixes(server):
    a1 = server.submit(3, seed=7).result(timeout=60)          # likely alone
    futs = [server.submit(i % 8, seed=100 + i) for i in range(3)]
    a2 = server.submit(3, seed=7).result(timeout=60)          # mixed batch
    for f in futs:
        f.result(timeout=60)
    assert torch.equal(a1, a2)


def test_requests_are_batched(server):
    before = server.stats()["batches"]
    futs = [server.submit(i % 8, seed=i) for i in range(4)]
    imgs = [f.result(timeout=60) for f in futs]
    assert all(im.shape == (3, 4, 4) for im in imgs)
    after = server.stats()
    # 4 requests arriving together coalesce into few batches
    assert after["batches"] - before <= 2
    assert after["served"] >= 5


def test_pipelined_under_load_reproducible(server):
    """Under a burst the worker queues batch N+1 before fetching batch N;
    results still match the same request served alone, and the pipelined
    counter advances."""
    alone = server.submit(5, seed=42).result(timeout=60)
    before = server.stats()
    futs = [server.submit(i % 8, seed=200 + i) for i in range(12)]
    futs.append(server.submit(5, seed=42))
    imgs = [f.result(timeout=120) for f in futs]
    assert all(im.shape == (3, 4, 4) for im in imgs)
    assert torch.equal(imgs[-1], alone)
    after = server.stats()
    assert after["served"] - before["served"] == 13
    # 13 requests / max_batch 4 -> >= 4 batches; at least one pair overlaps
    # (the burst is queued before the first fetch)
    assert after["pipelined"] >= 1


def test_int8att_request_equal_alone_and_in_a_mixed_batch(tiny_model):
    params, vae = tiny_model
    q = bench_recipes()["int8att"]
    galt = tuple(np.ones((TINY.depth, TINY.width), np.float32)
                 for _ in range(2))
    gen = VARGenerator(TINY, q, device="cpu")
    assert gen.qrt.attn_int8 and gen.qrt.kv_codec.value_codes
    srv = GenerationServer(gen, quantize_var_params(params, TINY, q,
                                                    galt=galt),
                           vae, max_batch=4, max_wait_ms=100)
    try:
        alone = srv.submit(3, seed=7).result(timeout=60)
        before = srv.stats()
        futs = [srv.submit(i % 8, seed=100 + i) for i in range(3)]
        futs.append(srv.submit(3, seed=7))
        imgs = [f.result(timeout=60) for f in futs]
        after = srv.stats()
    finally:
        srv.stop()
    assert after["served"] - before["served"] == 4
    assert after["batches"] - before["batches"] < 4      # batched together
    assert all(im.shape == (3, 4, 4) for im in imgs)
    assert torch.equal(imgs[-1], alone)
    assert not torch.equal(imgs[0], alone)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_per_row_generators_batch_independent(tiny_model):
    """A row's image depends only on its own generator, not on the batch
    it is in nor on its place there."""
    params, vae = tiny_model
    gen = VARGenerator(TINY, QuantConfig(), device="cpu")
    one = gen.generate(params, vae, [3, 1], [_gen(7), _gen(8)])
    two = gen.generate(params, vae, [5, 3], [_gen(9), _gen(7)])
    assert torch.equal(one[0], two[1])
    assert not torch.equal(one[1], two[0])
    # under more_smooth too: each row draws its sample, then its blend
    soft = VARGenerator(TINY, QuantConfig(),
                        GenerateConfig(more_smooth=True), device="cpu")
    one = soft.generate(params, vae, [3, 1], [_gen(7), _gen(8)])
    two = soft.generate(params, vae, [5, 3], [_gen(9), _gen(7)])
    assert torch.equal(one[0], two[1])
    with pytest.raises(ValueError, match="generators"):
        gen.generate(params, vae, [3, 1], [_gen(7)])


def test_row_seed_is_pure_and_distinct():
    seeds = {row_seed(b, s) for b in range(3) for s in range(100)}
    assert len(seeds) == 300
    assert row_seed(0, 7) == row_seed(0, 7) == row_seed(2 ** 32, 7)
    assert all(0 <= v < 2 ** 63 for v in seeds)


def test_server_matches_jax_server(monkeypatch):
    """Both servers, same weights and requests: width 256 ``int8`` (K5's
    route with two groups), top_k=1, float32 compute and cache."""
    width, mode = 256, "int8"
    jcfg, jqp = _jax_params(width, mode)
    jvae = _jax_vae()
    requests = [(3, 1), (5, 2), (998, 3)]
    jgen = JaxGenerator(jcfg, _recipe(mode, jax_side=True),
                        JaxGenerateConfig(top_k=1, top_p=0.0),
                        cache_dtype=jnp.float32, compute_dtype=jnp.float32)
    jsrv = JaxServer(jgen, jqp, jvae, max_batch=4, max_wait_ms=100)
    try:
        theirs = [np.asarray(f.result(timeout=300)) for f in
                  [jsrv.submit(lbl, s) for lbl, s in requests]]
    finally:
        jsrv.stop()

    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64)
    tqp = to_torch(jax.tree_util.tree_map(np.asarray, jqp), "cpu")
    tvae = to_torch(jax.tree_util.tree_map(np.asarray, jvae), "cpu")
    gen = VARGenerator(cfg, bench_recipes()[mode],
                       GenerateConfig(top_k=1, top_p=0.0),
                       cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device="cpu")
    routes = []
    nd = K.int8_group_gemm_nd
    monkeypatch.setattr(K, "int8_group_gemm_nd",
                        lambda *a, **k: routes.append("K5") or nd(*a, **k))
    srv = GenerationServer(gen, tqp, tvae, max_batch=4, max_wait_ms=100)
    try:
        ours = [f.result(timeout=300) for f in
                [srv.submit(lbl, s) for lbl, s in requests]]
    finally:
        srv.stop()
    assert routes and set(routes) == {"K5"}
    for o, t in zip(ours, theirs):
        assert o.shape == t.shape == (3, 6, 6)
        np.testing.assert_allclose(o.numpy(), t, rtol=0, atol=5e-5)



def test_serving_bench_runs_its_phases_on_cpu():
    """The bench's unloaded, saturated and Poisson phases at the tiny
    config, with burst-only counters; the d30 and d36 presets are VAR-d30
    and VAR-d36-512 (shared AdaLN), and the bench takes the paper's
    recipes by name."""
    vae = init_vqvae_params(TINY.vae, seed=1, device="cpu")
    res = serving_bench.run_recipe(TINY, bench_recipes()["int8"], vae,
                                   salt=7, n=4, poisson=3, max_batch=2,
                                   unloaded=1, device="cpu")
    assert len(res["saturated_ms"]["samples_ms"]) == 4
    assert len(res["poisson_ms"]["samples_ms"]) == 3
    assert res["unloaded_ms"]["p50"] > 0 and res["saturated_imgs_per_s"] > 0
    assert res["batches"] >= 2
    d30, d36 = serving_bench.PRESETS["d30"](), serving_bench.PRESETS["d36"]()
    assert (d30.depth, d30.width, d30.L, d30.shared_aln) == (30, 1920, 680,
                                                             False)
    assert (d36.depth, d36.width, d36.heads, d36.L, d36.shared_aln) == (
        36, 2304, 36, 2240, True)
    assert d36.vae.patch_nums == d36.patch_nums == PATCH_NUMS_512
    assert serving_bench.recipes()["fp4_kv6"] == paper_recipes()["fp4_kv6"]
    assert serving_bench.recipes()["int8"] == bench_recipes()["int8"]


def test_serving_bench_poisson_waits_for_every_completion_stamp(monkeypatch):
    """A future's done-callbacks run after ``set_result`` has woken its
    waiters, so ``result()`` can return before the callback that stamps
    the request's completion time.  With every callback delayed, the
    Poisson phase still returns one positive latency per request (reading
    an unstamped time would raise ``TypeError``)."""
    invoke = Future._invoke_callbacks

    def late(self):
        time.sleep(0.05)
        invoke(self)

    monkeypatch.setattr(Future, "_invoke_callbacks", late)
    vae = init_vqvae_params(TINY.vae, seed=1, device="cpu")
    res = serving_bench.run_recipe(TINY, bench_recipes()["bf16"], vae,
                                   salt=9, n=2, poisson=4, max_batch=2,
                                   unloaded=0, device="cpu")
    lat = res["poisson_ms"]["samples_ms"]
    assert len(lat) == 4 and all(v > 0 for v in lat)
