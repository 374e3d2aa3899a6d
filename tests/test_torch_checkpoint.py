"""Checkpoint I/O of the port against the JAX package's ``utils/checkpoint``.

The repository holds no upstream ``.pth``, so the converters run on state
dicts built from a seed with each upstream key and shape:

- ``expected_var_keys`` equal to JAX's, with and without ``shared_aln``;
- ``convert_var_state_dict`` and ``convert_vqvae_state_dict`` equal to
  JAX's leaf for leaf (``np.array_equal``: the converters only stack and
  regroup), the VQVAE under each ``quant_resi`` layout (partially shared,
  shared, not shared);
- ``load_torch_state_dict`` equal to JAX's on a ``.pth`` saved bare and
  inside a ``{"state_dict": ...}`` wrapper;
- npz interchange in both directions for float32, bfloat16, ``IntPack``
  (float32 and bfloat16 scales), ``PackedTensor`` (nibble and byte codes)
  and empty containers: a file JAX wrote loads in the port equal to
  ``bridge.to_torch`` of the same tree, bit for bit, with bfloat16 leaves
  kept bfloat16; a file the port wrote (uncompressed and compressed)
  loads in JAX equal to the tree JAX started from; the port's save ->
  load is ``torch.equal`` with the same dtypes;
- a quantized ``int8`` tree that JAX wrote generates, after the port's
  ``load_params``, the tokens of JAX's generation at ``top_k=1``.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fpqvar_tpu import config as JC
from fpqvar_tpu.ops import packing as JP
from fpqvar_tpu.utils import checkpoint as JCk

from fpqvar_tpu_torch.config import GenerateConfig, var_tiny
from fpqvar_tpu_torch.models import VARGenerator
from fpqvar_tpu_torch.models import var as V
from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor
from fpqvar_tpu_torch.utils import checkpoint as C
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_generate import _jax_params, _jax_vae, _recipe
from test_torch_generate import LABELS, JaxGenerateConfig, JaxGenerator
from test_torch_vqvae import CONFIGS as VQ_CONFIGS
from test_torch_vqvae import _params as vqvae_params
from torch_threads import one_torch_thread  # noqa: F401


def _var_cfgs(shared):
    jcfg = dataclasses.replace(JC.var_tiny(), shared_aln=shared)
    return jcfg, dataclasses.replace(var_tiny(), shared_aln=shared)


def _var_state_dict(jcfg, seed=0):
    """Every upstream VAR key with its shape, seeded normal values."""
    c, d, heads = jcfg.width, jcfg.depth, jcfg.heads
    shapes = {
        "word_embed.weight": (c, jcfg.vae.z_channels),
        "word_embed.bias": (c,),
        "class_emb.weight": (jcfg.num_classes + 1, c),
        "pos_start": (1, jcfg.first_l, c), "pos_1LC": (1, jcfg.L, c),
        "lvl_embed.weight": (jcfg.num_scales, c),
        "head_nm.ada_lin.1.weight": (2 * c, c),
        "head_nm.ada_lin.1.bias": (2 * c,),
        "head.weight": (jcfg.vae.vocab_size, c),
        "head.bias": (jcfg.vae.vocab_size,),
        "shared_ada_lin.1.weight": (6 * c, c),
        "shared_ada_lin.1.bias": (6 * c,),
    }
    for i in range(d):
        p = f"blocks.{i}."
        shapes.update({
            p + "attn.mat_qkv.weight": (3 * c, c),
            p + "attn.q_bias": (c,), p + "attn.v_bias": (c,),
            p + "attn.scale_mul_1H11": (1, heads, 1, 1),
            p + "attn.proj.weight": (c, c), p + "attn.proj.bias": (c,),
            p + "ffn.fc1.weight": (4 * c, c), p + "ffn.fc1.bias": (4 * c,),
            p + "ffn.fc2.weight": (c, 4 * c), p + "ffn.fc2.bias": (c,),
            p + "ada_lin.1.weight": (6 * c, c), p + "ada_lin.1.bias": (6 * c,),
            p + "ada_gss": (1, 1, 6, c),
        })
    keys = set(JCk.expected_var_keys(jcfg))
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items() if k in keys}


#: ``quant_resi`` layout -> the upstream key of phi k (None: no such key)
PHI_LAYOUTS = {
    "partially_shared": lambda k: f"quantize.quant_resi.qresi_ls.{k}",
    "non_shared": lambda k: f"quantize.quant_resi.{k}",
    "shared": lambda k: "quantize.quant_resi.qresi" if k == 0 else None,
}


def _vqvae_state_dict(jp, layout):
    """The upstream keys of a JAX-layout VQVAE tree (the inverse of the
    converter), with phi under ``layout``."""
    sd = {}
    for k, v in JCk._flatten(jp).items():
        if "__empty" in k:
            continue
        m = re.fullmatch(r"quantize/phi/(\d+)/([wb])", k)
        if m:
            name = PHI_LAYOUTS[layout](int(m.group(1)))
            if name is not None:
                sd[f"{name}.{'weight' if m.group(2) == 'w' else 'bias'}"] = v
            continue
        if k == "quantize/embedding":
            sd["quantize.embedding.weight"] = v
            continue
        k = re.sub(r"/w$", ".weight", k)
        k = re.sub(r"/b$", ".bias", k)
        k = re.sub(r"(downsample|upsample)\.", r"\1.conv.", k.replace("/", "."))
        sd[k] = np.asarray(v)
    return sd


def _assert_tree_equal(ours, theirs, where=""):
    """A port tree (tensors) equal leaf for leaf to a numpy tree."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and ours.keys() == theirs.keys(), where
        for k in theirs:
            _assert_tree_equal(ours[k], theirs[k], f"{where}/{k}")
    elif isinstance(theirs, list):
        assert isinstance(ours, list) and len(ours) == len(theirs), where
        for i, (a, b) in enumerate(zip(ours, theirs)):
            _assert_tree_equal(a, b, f"{where}/{i}")
    else:
        b = np.asarray(theirs)
        assert ours.device.type == "cpu", where
        assert ours.numpy().dtype == b.dtype, where
        assert np.array_equal(ours.numpy(), b), where


@pytest.mark.parametrize("shared", [False, True])
def test_expected_var_keys_match_jax(shared):
    jcfg, cfg = _var_cfgs(shared)
    assert C.expected_var_keys(cfg) == JCk.expected_var_keys(jcfg)
    assert set(_var_state_dict(jcfg)) == set(C.expected_var_keys(cfg))


@pytest.mark.parametrize("shared", [False, True])
def test_convert_var_state_dict_matches_jax(shared):
    jcfg, cfg = _var_cfgs(shared)
    sd = _var_state_dict(jcfg)
    theirs = JCk.convert_var_state_dict(sd, jcfg)
    ours = C.convert_var_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, "cpu")
    _assert_tree_equal(ours, theirs)          # exact: stacks and regroups
    # numpy values convert as well
    _assert_tree_equal(C.convert_var_state_dict(sd, cfg, "cpu"), theirs)


@pytest.mark.parametrize("layout", sorted(PHI_LAYOUTS))
@pytest.mark.parametrize("name", sorted(VQ_CONFIGS))
def test_convert_vqvae_state_dict_matches_jax(name, layout):
    jcfg, cfg = VQ_CONFIGS[name]
    sd = _vqvae_state_dict(vqvae_params(jcfg)[0], layout)
    theirs = JCk.convert_vqvae_state_dict(sd, jcfg)
    ours = C.convert_vqvae_state_dict(
        {k: torch.from_numpy(v) for k, v in sd.items()}, cfg, "cpu")
    assert len(ours["quantize"]["phi"]) == (1 if layout == "shared" else 4)
    _assert_tree_equal(ours, theirs)          # exact


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_torch_state_dict_matches_jax(tmp_path, wrapped):
    jcfg, _ = _var_cfgs(False)
    sd = {k: torch.from_numpy(v) for k, v in _var_state_dict(jcfg).items()}
    sd["head.weight"] = sd["head.weight"].to(torch.bfloat16)
    obj = {"state_dict": sd} if wrapped else dict(sd, step=3)
    path = str(tmp_path / "var.pth")
    torch.save(obj, path)
    ours = C.load_torch_state_dict(path)
    theirs = JCk.load_torch_state_dict(path)
    assert ours.keys() == theirs.keys() == sd.keys()
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32, k
        assert np.array_equal(ours[k].numpy(), v), k


# ---------------------------------------------------------------------------
# npz interchange
# ---------------------------------------------------------------------------

def _jax_tree(kind):
    """A JAX tree holding one kind of leaf (and a float32 leaf beside)."""
    rng = np.random.default_rng(1)

    def w(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32))

    leaf = {
        "f32": lambda: {"w": w(3, 5), "l": [w(2), w(4, 1)]},
        "bf16": lambda: {"w": w(2, 8).astype(jnp.bfloat16),
                         "s": [w(6).astype(jnp.bfloat16)]},
        "intpack": lambda: JP.pack_int_codes(w(2, 384, 256), "fp_e2"),
        "intpack_bf16_scales": lambda: jax.tree_util.tree_map(
            lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32
            else a, JP.pack_int_codes(w(2, 128, 256), "fp_e2")),
        "packed_nibble": lambda: JP.pack_stacked(w(2, 256, 256), "fp_e2"),
        "packed_byte": lambda: JP.pack_stacked(w(2, 96, 256), "fp6_e2m3"),
        "empty": lambda: {"attn": [], "opt": {}, "up": [{"attn": []}]},
    }[kind]()
    return {"x": w(4), kind: leaf}


KINDS = ("f32", "bf16", "intpack", "intpack_bf16_scales", "packed_nibble",
         "packed_byte", "empty")


def _assert_port_equal(a, b, where=""):
    """Two port trees equal: same structure, leaf types, dtypes and bits."""
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_port_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_port_equal(x, y, f"{where}/{i}")
    elif isinstance(a, (IntPack, PackedTensor)):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor):
                _assert_port_equal(x, y, f"{where}.{f.name}")
            else:
                assert x == y, f"{where}.{f.name}"
    else:
        assert a.dtype == b.dtype, where
        assert torch.equal(a, b), where


def _widened(tree):
    """A port tree with its bfloat16 tensors widened to float32."""
    if isinstance(tree, dict):
        return {k: _widened(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_widened(v) for v in tree]
    if isinstance(tree, (IntPack, PackedTensor)):
        return dataclasses.replace(tree, scales=_widened(tree.scales))
    return tree.float() if tree.dtype == torch.bfloat16 else tree


def _bf16_leaves(tree):
    if isinstance(tree, dict):
        return sum((_bf16_leaves(v) for v in tree.values()), [])
    if isinstance(tree, list):
        return sum((_bf16_leaves(v) for v in tree), [])
    if isinstance(tree, (IntPack, PackedTensor)):
        return _bf16_leaves(tree.scales)
    return [tree] if tree.dtype == torch.bfloat16 else []


def _assert_jax_equal(a, b, where=""):
    """Two JAX-package trees (numpy / jax leaves) equal bit for bit."""
    assert type(a) is type(b) or not isinstance(a, (dict, list)), where
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_jax_equal(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_jax_equal(x, y, f"{where}/{i}")
    elif isinstance(a, (JP.IntPack, JP.PackedTensor)):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if f.name in ("codes", "scales"):
                _assert_jax_equal(x, y, f"{where}.{f.name}")
            else:
                assert tuple(x) == tuple(y) if f.name == "shape" else x == y
    else:
        x, y = np.asarray(a), np.asarray(b)
        assert x.dtype == y.dtype and x.shape == y.shape, where
        if x.dtype == ml_dtypes.bfloat16:
            x, y = x.view(np.uint16), y.view(np.uint16)
        assert np.array_equal(x, y), where


@pytest.mark.parametrize("kind", KINDS)
def test_port_loads_jax_npz(tmp_path, kind):
    tree = _jax_tree(kind)
    JCk.save_params(str(tmp_path / "j.npz"), tree)
    ours = C.load_params(str(tmp_path / "j.npz"), "cpu")
    ref = to_torch(jax.tree_util.tree_map(np.asarray, tree), "cpu")
    _assert_port_equal(_widened(ours), ref)
    n_bf16 = len(_bf16_leaves(ours))
    assert n_bf16 == {"bf16": 2, "intpack_bf16_scales": 1}.get(kind, 0)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_jax_loads_port_npz(tmp_path, kind, compress):
    tree = _jax_tree(kind)
    JCk.save_params(str(tmp_path / "j.npz"), tree)
    ours = C.load_params(str(tmp_path / "j.npz"), "cpu")
    C.save_params(str(tmp_path / "p.npz"), ours, compress=compress)
    _assert_jax_equal(JCk.load_params(str(tmp_path / "p.npz")),
                      jax.tree_util.tree_map(np.asarray, tree))


@pytest.mark.parametrize("kind", KINDS)
def test_port_save_load_roundtrip(tmp_path, kind):
    JCk.save_params(str(tmp_path / "j.npz"), _jax_tree(kind))
    ours = C.load_params(str(tmp_path / "j.npz"), "cpu")
    C.save_params(str(tmp_path / "p.npz"), ours)
    _assert_port_equal(C.load_params(str(tmp_path / "p.npz"), "cpu"), ours)


def test_int8_npz_from_jax_generates_jax_tokens(tmp_path, monkeypatch):
    """JAX quantizes ``var_tiny`` under ``int8`` and writes the npz; the
    port's ``load_params`` tree generates JAX's tokens at ``top_k=1``."""
    from fpqvar_tpu.models import var as JV

    jcfg, jqp = _jax_params(128, "int8")
    JCk.save_params(str(tmp_path / "q.npz"), jqp)
    jax_tokens, port_tokens = [], []
    jax_sample, port_sample = JV.sample_with_top_k_top_p, \
        V.sample_with_top_k_top_p

    def jax_rec(key, logits, top_k=0, top_p=0.0):
        idx = jax_sample(key, logits, top_k, top_p)
        jax.debug.callback(lambda v: jax_tokens.append(np.asarray(v)), idx,
                           ordered=True)
        return idx

    def port_rec(logits, top_k=0, top_p=0.0, generator=None, gumbel=None):
        idx = port_sample(logits, top_k, top_p, generator, gumbel)
        port_tokens.append(idx.numpy())
        return idx

    monkeypatch.setattr(JV, "sample_with_top_k_top_p", jax_rec)
    monkeypatch.setattr(V, "sample_with_top_k_top_p", port_rec)
    jvae = _jax_vae()
    JaxGenerator(jcfg, _recipe("int8", jax_side=True),
                 JaxGenerateConfig(top_k=1, top_p=0.0),
                 cache_dtype=jnp.float32, compute_dtype=jnp.float32).generate(
        jqp, jvae, jnp.asarray(LABELS), jax.random.PRNGKey(2),
        return_fhat=True)
    jax.effects_barrier()
    qp = C.load_params(str(tmp_path / "q.npz"), "cpu")
    assert isinstance(qp["blocks"]["fc1_w"], IntPack)
    VARGenerator(var_tiny(), _recipe("int8"),
                 GenerateConfig(top_k=1, top_p=0.0),
                 cache_dtype=torch.float32, compute_dtype=torch.float32,
                 device="cpu").generate(
        qp, to_torch(jax.tree_util.tree_map(np.asarray, jvae), "cpu"),
        LABELS, return_fhat=True)
    assert len(jax_tokens) == len(port_tokens) == jcfg.num_scales
    for si, (a, b) in enumerate(zip(port_tokens, jax_tokens)):
        np.testing.assert_array_equal(a, b, err_msg=f"scale {si}")
