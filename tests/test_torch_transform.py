"""The device-side weight transform of the port against the JAX package's.

``transform_blocks_traced`` (fold -> float32 rotation -> quantize) on the
same seeded numpy blocks through JAX's jitted ``transform_blocks_traced``
and the port's, at ``var_tiny``'s width 128 (block-diagonal rotation) and
at width 192 (a full-size rotation, Paley basis; per-channel weights or
groups of 64, since 192 is no multiple of 128), for ``int8`` per group and
per channel, ``packed``, ``fake`` (also with ``int_quant`` and
``quantize_ada``, and from bf16 inputs), the paper's ``fp6`` and the
``enabled=False`` path:

- the rotated weights agree within the float32 bound of two sums in
  different orders: each output element is a sum of ``n`` products (``n``
  the rotation's length, 128 or the width), and a float32 sum of ``n``
  terms lies within ``n * u * sum|w * q|`` of the exact one (``u = 2^-24``,
  the unit roundoff), so the two lie within ``2 * n * u * sum|w * q|`` of
  each other; the fold ``w / s`` is one IEEE division on both sides;
- the quantize stage, given JAX's rotated weights, is bit-equal to JAX's
  (codes, scales, dequantized weights);
- tree structure, leaf types and dtypes equal JAX's (fake weights in the
  input dtype, bf16 from bf16 inputs).

``synth_device_params`` on the CPU returns JAX's structure and dtypes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu import config as JC
from fpqvar_tpu.ops import packing as JP
from fpqvar_tpu.quantize import recipe as JR

from fpqvar_tpu_torch.config import (bench_recipes, fpqvar_w4a4,
                                     paper_recipes, var_tiny)
from fpqvar_tpu_torch.models import init_var_params
from fpqvar_tpu_torch.ops import hadamard as H
from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor
from fpqvar_tpu_torch.quantize import recipe as R
from fpqvar_tpu_torch.utils.bridge import to_torch
from torch_threads import one_torch_thread  # noqa: F401

U = 2.0 ** -24


def _recipe(mode, jax_side=False):
    """(port or JAX) recipe of each case name."""
    br = JC.bench_recipes() if jax_side else bench_recipes()
    pr = JC.paper_recipes() if jax_side else paper_recipes()
    w4a4 = JC.fpqvar_w4a4() if jax_side else fpqvar_w4a4()
    return {
        "int8": br["int8"], "int8ch": br["int8ch"], "packed": br["packed"],
        "fake": br["fake"],
        "fake_int_ada": br["fake"].replace(int_quant=True, quantize_ada=True),
        "disabled": w4a4.replace(enabled=False),
        "fp6": pr["fp6"],
        "packed_g64": br["packed"].replace(group_size=64),
        "fake_int_ada_ch": br["fake"].replace(
            int_quant=True, quantize_ada=True, weight_quant="per_channel"),
    }[mode]


def _cfg(width):
    return dataclasses.replace(var_tiny(), embed_dim=width,
                               num_heads=width // 64)


def _jcfg(width):
    return dataclasses.replace(JC.var_tiny(), embed_dim=width,
                               num_heads=width // 64)


def _inputs(width, dtype):
    """Seeded blocks (numpy) and GALT vectors of a width."""
    cfg = _cfg(width)
    blocks = init_var_params(cfg, seed=11, device="cpu",
                             adaln_gamma_std=0.02)["blocks"]
    np_blocks = {k: ({kk: vv.numpy() for kk, vv in v.items()}
                     if isinstance(v, dict) else v.numpy())
                 for k, v in blocks.items()}
    rng = np.random.default_rng(12)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, width)))
                 .astype(np.float32) for _ in range(2))
    cast = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jblocks = jax.tree_util.tree_map(lambda a: jnp.asarray(a, cast),
                                     np_blocks)
    tblocks = to_torch(jax.tree_util.tree_map(np.asarray, jblocks), "cpu")
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    tblocks = {k: ({kk: vv.to(tdt) for kk, vv in v.items()}
                   if isinstance(v, dict) else v.to(tdt))
               for k, v in tblocks.items()}
    return jblocks, tblocks, galt


def _jax_transform(jblocks, width, jq, galt):
    return jax.jit(lambda b: JR.transform_blocks_traced(
        b, _jcfg(width), jq, galt=galt))(jblocks)


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def _same_structure(ours, theirs, where=""):
    """Keys, leaf types (IntPack / PackedTensor / array) and dtypes."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and ours.keys() == theirs.keys(), where
        for k in theirs:
            _same_structure(ours[k], theirs[k], f"{where}/{k}")
        return
    if isinstance(theirs, (JP.IntPack, JP.PackedTensor)):
        kind = IntPack if isinstance(theirs, JP.IntPack) else PackedTensor
        assert type(ours) is kind, where
        assert (ours.fmt, tuple(ours.shape), ours.group_size) == (
            theirs.fmt, tuple(theirs.shape), theirs.group_size), where
        for f in ("codes", "scales"):
            assert _dtype_name(getattr(ours, f)) == _dtype_name(
                getattr(theirs, f)), f"{where}.{f}"
        return
    assert isinstance(ours, torch.Tensor), where
    assert _dtype_name(ours) == _dtype_name(theirs), where
    assert tuple(ours.shape) == tuple(theirs.shape), where


def _same_bits(ours, theirs, where=""):
    """Every tensor of the port's tree equals the bridged JAX tree's, bit
    for bit (bf16 values compare through their exact float32 widening)."""
    if isinstance(theirs, dict):
        for k in theirs:
            _same_bits(ours[k], theirs[k], f"{where}/{k}")
        return
    if isinstance(theirs, (IntPack, PackedTensor)):
        for f in ("codes", "scales"):
            a, b = getattr(ours, f), getattr(theirs, f)
            assert torch.equal(a, b.to(a.dtype)), f"{where}.{f}"
        return
    a = ours.to(torch.float32) if ours.is_floating_point() else ours
    assert a.numpy().tobytes() == theirs.to(a.dtype).numpy().tobytes(), where


CASES = [(128, "int8", "float32"), (128, "int8ch", "float32"),
         (128, "packed", "float32"), (128, "fake", "float32"),
         (128, "fake", "bfloat16"), (128, "fake_int_ada", "float32"),
         (128, "disabled", "float32"), (128, "disabled", "bfloat16"),
         (192, "int8ch", "float32"), (192, "packed_g64", "float32"),
         (192, "fp6", "bfloat16"), (192, "fake_int_ada_ch", "float32"),
         (192, "disabled", "float32")]


@pytest.mark.parametrize("width,mode,dtype", CASES)
def test_transform_matches_jax(width, mode, dtype):
    q = _recipe(mode)
    if width == 192:
        q = q.replace(block_rotate=False)
    jq = JC.QuantConfig(**dataclasses.asdict(q))
    jblocks, tblocks, galt = _inputs(width, dtype)
    theirs = _jax_transform(jblocks, width, jq, galt)
    ours = R.transform_blocks_traced(tblocks, _cfg(width), q, galt)
    _same_structure(ours, theirs)

    # the rotated weights: within the bound of two float32 sums
    f32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), jblocks)
    j_rot = to_torch(jax.tree_util.tree_map(np.asarray, _jax_transform(
        f32, width, jq.replace(enabled=False), galt)), "cpu")
    t_rot = R._rotate_f32(tblocks, _cfg(width), q, galt)
    qmat = np.abs(H.block_hadamard_block(128, 42) if q.block_rotate
                  else H.random_hadamard_matrix(width, 42))
    n = qmat.shape[0]
    for key, g in zip(("mat_qkv_w", "fc1_w"), galt):
        w = tblocks[key].to(torch.float64).numpy()
        if q.transform:
            w = w / g[:, None, :]
        d, o, i = w.shape
        size = (np.abs(w).reshape(d, o, i // n, n) @ qmat).reshape(d, o, i)
        bound = 2 * n * U * size
        diff = np.abs(t_rot[key].numpy().astype(np.float64)
                      - j_rot[key].numpy())
        assert t_rot[key].dtype == torch.float32
        assert (diff <= bound).all(), (key, float((diff / bound).max()))

    # the quantize stage, given JAX's rotated weights, is bit-equal
    staged = dict(t_rot)
    for key in ("mat_qkv_w", "fc1_w"):
        staged[key] = j_rot[key]
    ours_q = R._quantize_traced(staged, q, tblocks["mat_qkv_w"].dtype)
    _same_bits(ours_q, to_torch(jax.tree_util.tree_map(np.asarray, theirs),
                                "cpu"))


@pytest.mark.parametrize("mode", ["int8", "packed", "fake", "bf16"])
def test_synth_device_params_structure_matches_jax(mode):
    """The port's ``synth_device_params(device="cpu")`` against JAX's:
    the same keys, leaf types, shapes and dtypes (bf16 init; int8 codes
    and float32 scales; bf16 fake weights); values come from each
    package's own RNG."""
    cfg, jcfg = _cfg(128), _jcfg(128)
    q = bench_recipes()[mode]
    jq = JC.QuantConfig(**dataclasses.asdict(q))
    galt = tuple(np.ones((cfg.depth, cfg.width), np.float32)
                 for _ in range(2))
    theirs = JR.synth_device_params(jcfg, jq, jax.random.PRNGKey(0),
                                    galt=galt)
    ours = R.synth_device_params(cfg, q, seed=0, galt=galt, device="cpu")
    _same_structure(ours, theirs)
