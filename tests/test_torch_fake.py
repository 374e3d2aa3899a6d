"""The rest of the fake backend against the JAX package.

Inputs are made with numpy from a seed and fed to both packages; the JAX
functions run under ``jit``, the form its recipe and generation run them
in.

- Bit-equal: ``fake_quant_int_sym`` and ``fake_quant_int_asym`` at 4 and 8
  bits per token, per group and per tensor, float32 and bfloat16;
  ``fake_quant_neg_reverse``; ``fake_quant_fp`` and ``fake_quant_dual``
  per tensor; ``fake_quant_kv`` for ``kv_bit`` 4 (per 64-wide row and the
  reference's flat grouping), 6 and 8 (``int_sym``); the activation and
  weight quantizers of every ``make_*_quantizer`` branch; ``torch_signs``
  at sizes 256, 1024, 1920 and 2304 with seeds 0 and 42;
  ``hadamard_matrix`` at every Paley-based order a VAR width needs, 1920
  and 2304 among them; the runtime's quantizers and rotations; and
  ``quantize_var_params`` under ``int4_rtn``, a full-size rotation at width
  192 (16 x 12, three heads; ``fp6``, per channel, since 192 is no multiple
  of the 128-wide groups) and ``quantize_ada`` (``ada_lin`` and
  ``shared_ada_lin``).
- Within a relative 1e-5 (float32): ``fake_quant_log2``, whose
  ``log2`` / ``exp2`` differ from XLA's in the last bits.
- ``paper_recipes()`` equals the definitions of ``scripts/acceptance.py``
  and ``scripts/quality_ladder.py`` field by field.
"""
import ast
import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu import config as JC
from fpqvar_tpu.models import var as JV
from fpqvar_tpu.ops import hadamard as JH
from fpqvar_tpu.ops import quantizers as JQ
from fpqvar_tpu.quantize import quantize_var_params as jax_quantize
from fpqvar_tpu.quantize.runtime import build_runtime as jax_runtime

from fpqvar_tpu_torch.config import (QuantConfig, bench_recipes,
                                     paper_recipes, var_tiny)
from fpqvar_tpu_torch.ops import hadamard as H
from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.quantize import build_runtime, quantize_var_params
from fpqvar_tpu_torch.utils.bridge import to_torch
from test_torch_quant import _act, _bits
from torch_threads import one_torch_thread  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: fake_quant_log2's bound against JAX's, relative to JAX's value
LOG2_RTOL = 1e-5


def _input(seed, shape=(4, 3, 512)):
    """Gaussian activations with an all-zero group, rows of other
    magnitudes and a run of integers (exact INT code ties)."""
    rng = np.random.default_rng(seed)
    x = _act(rng, shape) * np.exp(rng.standard_normal(shape[:-1] + (1,))
                                  ).astype(np.float32)
    x[0, 0, 300:400] = np.round(x[0, 0, 300:400])
    return x


def _pair(ours_fn, theirs_fn, x, dtype):
    """(ours, theirs) as float32 numpy arrays of ``x`` in ``dtype``."""
    tdt, jdt = DTYPES[dtype]
    ours = ours_fn(torch.from_numpy(x).to(tdt))
    theirs = jax.jit(theirs_fn)(jnp.asarray(x).astype(jdt))
    assert ours.dtype == tdt and theirs.dtype == jdt
    return ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))


def _assert_bit_equal(ours_fn, theirs_fn, x, dtype):
    ours, theirs = _pair(ours_fn, theirs_fn, x, dtype)
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("granularity", ["per_token", "per_group",
                                         "per_tensor"])
@pytest.mark.parametrize("n_bits", [4, 8])
@pytest.mark.parametrize("fn", ["fake_quant_int_sym", "fake_quant_int_asym"])
def test_int_quantizers_bit_equal(fn, n_bits, granularity, dtype):
    kw = dict(n_bits=n_bits, granularity=granularity, group_size=128)
    _assert_bit_equal(functools.partial(getattr(Q, fn), **kw),
                      functools.partial(getattr(JQ, fn), **kw),
                      _input(20), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_neg_reverse_bit_equal(dtype):
    """At float32 XLA contracts JAX's last two lines into fused
    multiply-adds, which the port rounds as one (``_fma``)."""
    x = _input(21, (6, 5, 1024))
    _assert_bit_equal(Q.fake_quant_neg_reverse, JQ.fake_quant_neg_reverse,
                      x, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", ["fp_e2", "fp6_e2m3", "fp_e1m2_neg_e2m1_pos",
                                 "fp6_int_neg_e2m3_pos"])
def test_per_tensor_fp_and_dual_bit_equal(fmt, dtype):
    fn = "fake_quant_dual" if fmt in Q.G.DUAL_GRIDS else "fake_quant_fp"
    kw = dict(fmt=fmt, granularity="per_tensor")
    _assert_bit_equal(functools.partial(getattr(Q, fn), **kw),
                      functools.partial(getattr(JQ, fn), **kw),
                      _input(22), dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kv_bit,ref_grouping", [(4, False), (4, True),
                                                 (6, False), (8, False)])
def test_kv_quantizer_bit_equal(kv_bit, ref_grouping, dtype):
    """``fake_quant_kv`` on ``[B, T, H, c]`` keys (c = 64): fp_e2 per row
    of 64 or in the reference's flat groups of 128 (two tokens of one
    head), fp6_e2m3 per token, int8 per token in float32."""
    rng = np.random.default_rng(23)
    x = (rng.standard_normal((6, 9, 2, 64)) * 0.3).astype(np.float32)
    x[1, 2, 0] = 0.0                               # an all-zero row
    qj = JC.QuantConfig(kv_bit=kv_bit, kv_ref_grouping=ref_grouping)
    qt = QuantConfig(kv_bit=kv_bit, kv_ref_grouping=ref_grouping)
    _assert_bit_equal(functools.partial(Q.fake_quant_kv, qcfg=qt),
                      functools.partial(JQ.fake_quant_kv, qcfg=qj), x, dtype)


@pytest.mark.parametrize("granularity", ["per_token", "per_group"])
def test_log2_quantizer_within_tolerance(granularity):
    """float32: ``torch.log2`` / ``exp2`` differ from XLA's in the last
    bits (34% and 37% of the outputs here, by at most 8.4e-7 and 1.1e-6
    relative), within ``LOG2_RTOL``; the zeros stay exact zeros."""
    x = _input(24, (8, 5, 1024))
    kw = dict(n_bits=4, granularity=granularity, group_size=128)
    ours, theirs = _pair(functools.partial(Q.fake_quant_log2, **kw),
                         functools.partial(JQ.fake_quant_log2, **kw),
                         x, "float32")
    np.testing.assert_allclose(ours, theirs, rtol=LOG2_RTOL, atol=0)
    assert (ours[x == 0] == 0).all() and (theirs[x == 0] == 0).all()


@pytest.mark.parametrize("fmt,kw", [
    ("int", {"symmetric": True}), ("int", {}), ("int_sym", {}),
    ("int_asym", {"granularity": "per_tensor"}),
    ("fp_neg_reverse_quant", {}), ("fp_e2", {"granularity": "per_tensor"}),
    ("fp_e1m2_neg_e2m1_pos", {"granularity": "per_tensor"})])
def test_act_quantizer_branches_bit_equal(fmt, kw):
    x = _input(25)
    _assert_bit_equal(Q.make_act_quantizer(fmt, 4, **kw),
                      JQ.make_act_quantizer(fmt, 4, **kw), x, "float32")


@pytest.mark.parametrize("fmt,granularity", [
    ("int_sym", "per_channel"), ("int", "per_group"),
    ("int_sym", "per_tensor"), ("fp_e2", "per_tensor")])
def test_weight_quantizer_branches_bit_equal(fmt, granularity):
    rng = np.random.default_rng(26)
    w = (rng.standard_normal((2, 256, 384)) * 0.02).astype(np.float32)
    w[0, 5] *= 400.0
    _assert_bit_equal(
        Q.make_weight_quantizer(fmt, 4, granularity=granularity),
        JQ.make_weight_quantizer(fmt, 4, granularity=granularity), w,
        "float32")


def test_unknown_formats_raise():
    with pytest.raises(ValueError, match="unknown activation format"):
        Q.make_act_quantizer("fp5", 4)
    with pytest.raises(ValueError, match="unknown weight format"):
        Q.make_weight_quantizer("log2", 4)


@pytest.mark.parametrize("seed", [0, 42])
@pytest.mark.parametrize("size", [256, 1024, 1920, 2304])
def test_torch_signs_bit_equal(size, seed):
    """The port's generator draws the stream of JAX's seeded global RNG,
    and leaves the global RNG as it found it."""
    state = torch.random.get_rng_state()
    ours = H.torch_signs(size, seed)
    assert torch.equal(torch.random.get_rng_state(), state)
    theirs = JH.torch_signs(size, seed)
    assert ours.dtype == theirs.dtype == np.float64
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(H.torch_signs(128, 42),
                                  JH.torch_signs(128, 42))


@pytest.mark.parametrize("order", [12, 20, 28, 36, 40, 52, 60, 108, 140, 480,
                                   1920, 2304])
def test_hadamard_matrix_bit_equal(order):
    """Paley I and II bases (28 and 52 over GF(27) and GF(25)) with
    Sylvester doubling: 1920 = 4 x 480 (q = 479), 2304 = 64 x 36 (q = 17)."""
    ours = H.hadamard_matrix(order)
    np.testing.assert_array_equal(ours, JH.hadamard_matrix(order))
    np.testing.assert_array_equal(ours @ ours.T, order * np.eye(order))


def test_random_and_block_hadamard_bit_equal():
    for size, seed in ((192, 42), (1920, 0)):
        ours = H.random_hadamard_matrix(size, seed)
        np.testing.assert_array_equal(ours, JH.random_hadamard_matrix(
            size, seed))
        np.testing.assert_allclose(ours @ ours.T, np.eye(size), atol=1e-12)
    np.testing.assert_array_equal(H.block_hadamard_matrix(384),
                                  JH.block_hadamard_matrix(384))
    with pytest.raises(ValueError):
        H.hadamard_matrix(156)                  # Williamson-type, as in JAX


def _jax_recipe(name):
    return {**_acceptance_recipes(), **_ladder_recipes()}[name]


@pytest.mark.parametrize("name,kw", [
    ("int4_rtn", {}), ("int4_rtn", {"fc2_log2": True}),
    ("fp4_kv6", {"kv_mode": "reference"}),
    ("fp4", {"kv_bit": 4, "kv_ref_grouping": True}),
    ("fp4", {"block_rotate": False, "quantize_ada": True}),
    ("fp4", {"mixed_act_formats": ("fp_e2", "fp_e3", "fp_e2")}),
    ("fp6_kv6", {"quantize_ada": True, "int_quant": True, "act_sym": False})])
def test_runtime_matches_jax(name, kw):
    """``build_runtime`` (depth 3, width 384) resolves the recipe as JAX's:
    the same quantizer in each slot (its output bit-equal on one input, or
    within ``LOG2_RTOL`` for fc2's log2 under ``fc2_log2``), the KV
    quantizer and mode, the rotations and the mixed variants."""
    ours = build_runtime(paper_recipes()[name].replace(**kw), 3, 384,
                         device="cpu")
    theirs = jax_runtime(_jax_recipe(name).replace(**kw), 3, 384)
    x = _input(27, (2, 5, 384))

    def same_q(o, t, log2=False):
        assert (o is None) == (t is None)
        if o is None:
            return
        if log2:
            np.testing.assert_allclose(*_pair(o, t, x, "float32"),
                                       rtol=LOG2_RTOL, atol=0)
        else:
            _assert_bit_equal(o, t, x, "float32")

    def same_act_q(o, t):
        assert o.keys() == t.keys()
        for k in o:
            same_q(o[k], t[k], log2=k == "fc2" and kw.get("fc2_log2", False))

    same_act_q(ours.act_q, theirs.act_q)
    assert ours.act_fmts == theirs.act_fmts
    assert ours.kv_mode == theirs.kv_mode
    assert ours.transform == theirs.transform
    same_q(ours.kv_q and (lambda t: ours.kv_q(t.reshape(2, 5, 6, 64))),
           theirs.kv_q and (lambda t: theirs.kv_q(t.reshape(2, 5, 6, 64))))
    for attr in ("rotation_block", "rotation_full"):
        o, t = getattr(ours, attr), getattr(theirs, attr)
        assert (o is None) == (t is None), attr
        if o is not None:
            np.testing.assert_array_equal(o.numpy(), np.asarray(t))
    assert ours.mixed_idx == theirs.mixed_idx
    if ours.mixed_act_q is not None:
        for i in range(3):
            same_act_q(ours.for_block(i).act_q, theirs.for_block(i).act_q)


def test_runtime_refusals_match_jax():
    for q, err in ((paper_recipes()["fp4"].replace(block_rotate=False),
                    "width"),
                   (paper_recipes()["fp4"].replace(
                       mixed_act_formats=("fp_e2",)), "one entry"),
                   (bench_recipes()["int8"].replace(int_quant=True),
                    "per-group or per-token"),
                   (bench_recipes()["int8"].replace(
                       mixed_act_formats=("fp_e2", "fp_e3")), "mixed")):
        with pytest.raises(ValueError, match=err):
            build_runtime(q, None if err == "width" else 3, None,
                          device="cpu")
    rt = build_runtime(bench_recipes()["int8ch"].replace(kv_bit=6,
                                                         quantize_ada=True),
                       2, 128, device="cpu")
    assert rt.kv_q is not None and rt.kv_codec is None
    assert callable(rt.act_q["ada"])
    assert all(rt.act_q[k] is None for k in ("mat_qkv", "proj", "fc1", "fc2"))


@functools.lru_cache(maxsize=None)
def _jax_params(width, shared):
    jcfg = dataclasses.replace(JC.var_tiny(), embed_dim=width,
                               num_heads=width // 64, shared_aln=shared)
    return jcfg, jax.jit(functools.partial(
        JV.init_var_params, cfg=jcfg, adaln_gamma_std=0.02))(
        jax.random.PRNGKey(0))


def _galt(depth, width):
    rng = np.random.default_rng(5)
    return tuple(np.exp(0.1 * rng.standard_normal((depth, width)))
                 .astype(np.float32) for _ in range(2))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("width,shared,name,kw", [
    (128, False, "int4_rtn", {}),
    (192, False, "fp6", {"block_rotate": False}),
    (128, False, "fp4", {"quantize_ada": True}),
    (128, True, "int4_rtn", {"quantize_ada": True})])
def test_quantize_var_params_bit_equal(width, shared, name, kw):
    """The port's offline recipe on the bridged float params gives JAX's
    tree bit for bit: the block linears, and under ``quantize_ada`` the
    fake-quantized ``ada_lin`` or ``shared_ada_lin`` weights."""
    jcfg, jp = _jax_params(width, shared)
    cfg = dataclasses.replace(var_tiny(), embed_dim=width,
                              num_heads=width // 64, shared_aln=shared)
    galt = _galt(cfg.depth, width)
    theirs = to_torch(jax.tree_util.tree_map(np.asarray, jax_quantize(
        jp, jcfg, _jax_recipe(name).replace(**kw), galt=galt)), "cpu")
    float_params = to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    ours = quantize_var_params(float_params, cfg,
                               paper_recipes()[name].replace(**kw), galt=galt)
    o_leaves, t_leaves = dict(_leaves(ours)), dict(_leaves(theirs))
    assert o_leaves.keys() == t_leaves.keys()
    for key, o in o_leaves.items():
        t = t_leaves[key]
        assert o.dtype == t.dtype and o.shape == t.shape, key
        np.testing.assert_array_equal(_bits(o.numpy()), _bits(t.numpy()),
                                      err_msg=key)
    ada = ("shared_ada_lin/w" if shared else "/blocks/ada_lin/w")
    ada = "/" + ada.lstrip("/")
    changed = not np.array_equal(o_leaves[ada].numpy(),
                                 dict(_leaves(float_params))[ada].numpy())
    assert changed == bool(kw.get("quantize_ada")), ada


def _acceptance_recipes():
    spec = importlib.util.spec_from_file_location(
        "acceptance", REPO / "scripts" / "acceptance.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return {n: mod.recipe_config(n) for n in ("fp4", "fp4_kv6", "fp6",
                                              "fp6_kv6")}


def _ladder_recipes():
    """``int4_rtn`` and ``fp4_pertensor`` from the ``stages`` dict of
    ``scripts/quality_ladder.py``'s ``main``, evaluated with JAX's config
    (the script builds them inside ``main``)."""
    tree = ast.parse((REPO / "scripts" / "quality_ladder.py").read_text())
    stages = next(n.value for n in ast.walk(tree)
                  if isinstance(n, ast.Assign)
                  and any(isinstance(t, ast.Name) and t.id == "stages"
                          for t in n.targets)
                  and isinstance(n.value, ast.Dict))
    env = {"QuantConfig": JC.QuantConfig, "fp4": JC.fpqvar_w4a4()}
    out = {}
    for k, v in zip(stages.keys, stages.values):
        if k.value in ("int4_rtn", "fp4_pertensor"):
            out[k.value] = eval(compile(ast.Expression(v.elts[0]),
                                        "quality_ladder.py", "eval"), env)
    return out


def test_paper_recipes_equal_the_scripts():
    ours = paper_recipes()
    theirs = {**_acceptance_recipes(), **_ladder_recipes()}
    assert set(ours) == set(theirs) == {"fp4", "fp4_kv6", "fp6", "fp6_kv6",
                                        "int4_rtn", "fp4_pertensor"}
    for name in ours:
        assert (dataclasses.asdict(ours[name])
                == dataclasses.asdict(theirs[name])), name
