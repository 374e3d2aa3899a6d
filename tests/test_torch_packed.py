"""The ``packed`` and ``fake`` backends' pieces against the JAX package.

Inputs are made with numpy from a seed and fed to both packages.

- ``pack`` / ``pack_stacked`` codes and scales, ``unpack_codes`` and
  ``dequantize`` are bit-equal to JAX's functions under ``jit`` (the form in
  which its recipe packs weights), for fp_e2 in row-split nibbles
  (rows % 128 == 0), fp_e2 one code per byte (rows % 128 != 0) and fp6_e2m3.
- The select-tree decoders equal the grids.
- The fake quantizers (``make_act_quantizer``'s grid and dual-grid
  branches, ``make_weight_quantizer``'s grid branch) are bit-equal to JAX's
  under ``jit``, per group and per token (where the fp4 formats clamp to
  [-3, 3]) at float32, and per group (the recipes' activations) at
  bfloat16, on activations with planted exact midpoints and an all-zero
  group.
- ``packed_matmul_ref`` (K2's plain version) agrees with JAX's K2
  (``_packed_matmul_2d``) in interpret mode within ``K2_REL_TOL`` of
  ``sum_g |s| * sum_k |x * grid[code]|`` per element: both take exact group
  products and differ only in the float32 order of the sums.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.ops import grids as JG
from fpqvar_tpu.ops import packing as JP
from fpqvar_tpu.ops import quantizers as JQ
from fpqvar_tpu.ops.pallas import quant_matmul as JK

from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quant_matmul as QM
from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.ops._checks import bf16_gap
from test_torch_quant import _act, _bits
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _as_np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("fmt,rows,nibble", [("fp_e2", 256, True),
                                             ("fp_e2", 192, False),
                                             ("fp6_e2m3", 256, False)])
def test_pack_stacked_bit_equal(fmt, rows, nibble):
    rng = np.random.default_rng(10)
    w = (rng.standard_normal((2, rows, 384)) * 0.02).astype(np.float32)
    w[0, :, :128] = 0.0                              # all-zero groups
    w[1, 3, 128:256] = JG.GRIDS[fmt].max() * 1e-3    # planted grid values
    theirs = jax.jit(lambda a: JP.pack_stacked(a, fmt, 128))(jnp.asarray(w))
    ours = P.pack_stacked(torch.from_numpy(w), fmt, 128)
    assert ours.nibble_packed == theirs.nibble_packed == nibble
    assert ours.shape == theirs.shape == (rows, 384)
    assert ours.codes.dtype == torch.int8
    np.testing.assert_array_equal(ours.codes.numpy(), np.asarray(theirs.codes))
    # JAX keeps scales [d, rows, G]; the port [d, G, rows]
    np.testing.assert_array_equal(
        _bits(ours.scales), _bits(np.swapaxes(np.asarray(theirs.scales), 1, 2)))
    for i in range(2):
        jb = JP.PackedTensor(theirs.codes[i], theirs.scales[i], fmt,
                             theirs.shape, 128, theirs.nibble_packed)
        np.testing.assert_array_equal(P.unpack_codes(ours.block(i)).numpy(),
                                      np.asarray(JP.unpack_codes(jb)))
        np.testing.assert_array_equal(_bits(P.dequantize(ours.block(i))),
                                      _bits(JP.dequantize(jb)))


def test_decoders_equal_grids():
    e2m1 = torch.arange(15)
    e2m3 = torch.arange(63)
    np.testing.assert_array_equal(P.decode_fp4_e2m1(e2m1).numpy(),
                                  JG.GRIDS["fp_e2"])
    np.testing.assert_array_equal(P.decode_fp6_e2m3(e2m3).numpy(),
                                  JG.GRIDS["fp6_e2m3"])


def _act_input(fmt, rng):
    grid = JG.GRIDS.get(fmt)
    if grid is None:                                 # dual grid: both halves
        x = _act(rng, (4, 3, 512))
        x[..., 256:384] = np.abs(x[..., 256:384])    # a group with no negatives
        x[..., 384:] = -np.abs(x[..., 384:])         # a group with no positives
        return x
    return _act(rng, (4, 3, 512), grid)


@pytest.mark.parametrize("granularity,dtype", [("per_group", "float32"),
                                               ("per_token", "float32"),
                                               ("per_group", "bfloat16")])
@pytest.mark.parametrize("fmt", ["fp_e2", "fp6_e2m3", "fp_e1m2_neg_e2m1_pos",
                                 "fp6_int_neg_e2m3_pos"])
def test_act_quantizer_bit_equal(fmt, granularity, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _act_input(fmt, np.random.default_rng(11))
    xt = torch.from_numpy(x).to(tdt)
    xj = jnp.asarray(x).astype(jdt)
    ours = Q.make_act_quantizer(fmt, 4, granularity=granularity,
                                group_size=128)(xt)
    theirs = jax.jit(JQ.make_act_quantizer(fmt, 4, granularity=granularity,
                                           group_size=128))(xj)
    assert ours.dtype == tdt and theirs.dtype == jdt
    np.testing.assert_array_equal(_bits(ours.float()), _bits(_as_np(theirs)))
    if granularity == "per_group":
        assert (ours[..., :128] == 0).all()          # the all-zero group


def test_fake_quant_fp_clip_abs_bit_equal():
    x = _act(np.random.default_rng(12), (5, 384), JG.GRIDS["fp_e2"])
    for gran in ("per_group", "per_token"):
        ours = Q.fake_quant_fp(torch.from_numpy(x), "fp_e2", granularity=gran,
                               clip_abs=1.5)
        theirs = jax.jit(functools.partial(
            JQ.fake_quant_fp, fmt="fp_e2", granularity=gran, clip_abs=1.5))(
            jnp.asarray(x))
        np.testing.assert_array_equal(_bits(ours), _bits(theirs))
        assert float(ours.abs().max()) <= 1.5


@pytest.mark.parametrize("fmt,granularity", [("fp_e2", "per_group"),
                                             ("fp_e2", "per_channel"),
                                             ("fp6_e2m3", "per_group")])
def test_weight_quantizer_bit_equal(fmt, granularity):
    rng = np.random.default_rng(13)
    w = (rng.standard_normal((2, 256, 384)) * 0.02).astype(np.float32)
    w[0, 5] *= 400.0                   # a row past the per-channel clamp
    ours = Q.make_weight_quantizer(fmt, 4, granularity=granularity)(
        torch.from_numpy(w))
    theirs = jax.jit(JQ.make_weight_quantizer(fmt, 4, granularity=granularity))(
        jnp.asarray(w))
    np.testing.assert_array_equal(_bits(ours), _bits(theirs))


def test_unported_quantizers_raise():
    """Every quantizer of the JAX package is ported (``test_torch_fake.py``
    holds them to JAX's); what neither package knows raises ``ValueError``,
    as JAX's dispatch does."""
    for fmt in ("int", "log2", "fp_neg_reverse_quant"):
        assert callable(Q.make_act_quantizer(fmt, 4))
    assert callable(Q.make_weight_quantizer("int_sym", 4))
    x = torch.ones(4, 128)
    x[0, 0], x[0, 1] = 12.0, 5.0       # one scale, 12 / 6, for the tensor
    y = Q.fake_quant_fp(x, "fp_e2", granularity="per_tensor")
    # 1 / 2 is on the grid; 5 / 2 ties between 2 and 3 and snaps up
    assert y[0, :2].tolist() == [12.0, 6.0] and float(y[1, 1]) == 1.0
    for fmt in ("fp5", "int4"):
        with pytest.raises(ValueError, match="unknown activation format"):
            Q.make_act_quantizer(fmt, 4)
    with pytest.raises(ValueError, match="unknown weight format"):
        Q.make_weight_quantizer("fp_neg_reverse_quant", 4)
    with pytest.raises(ValueError, match="unknown granularity"):
        Q.fake_quant_fp(x, "fp_e2", granularity="per_row")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", ["fp_e2", "fp6_e2m3"])
def test_plain_k2_matches_jax_kernel(fmt, dtype):
    tdt, jdt = DTYPES[dtype]
    m, k, n = 37, 384, 256                           # ragged M, G = 3
    rng = np.random.default_rng(14)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    jpw = jax.jit(lambda a: JP.pack(a, fmt, 128))(jnp.asarray(w))
    xj = jnp.asarray(x).astype(jdt)
    theirs = JK._packed_matmul_2d(
        xj, jpw.codes, jpw.scales.T, fmt=fmt, group_size=128, n=n, k_dim=k,
        nibble=jpw.nibble_packed, interpret=True)

    pw = P.pack(torch.from_numpy(w), fmt, 128)
    assert pw.nibble_packed == (fmt == "fp_e2")
    xt = torch.from_numpy(x).to(tdt)
    ops = (xt, pw.codes, pw.scales, fmt, 128, pw.nibble_packed)
    before = QM.launches
    ours = QM.packed_matmul(*ops)
    assert QM.launches == before                     # CPU: the plain version
    assert ours.shape == (m, n) and ours.dtype == torch.float32
    err = np.abs(ours.numpy() - np.asarray(theirs))
    tol = QM.packed_matmul_tolerance(*ops).numpy()
    assert (err <= tol).all(), f"max err/tol {(err / tol).max()}"
    # packed_linear: N-D x, x.dtype out, the same numbers
    y = QM.packed_linear(xt[None], pw)
    assert y.shape == (1, m, n) and y.dtype == tdt
    np.testing.assert_array_equal(y[0].float().numpy(),
                                  ours.to(tdt).float().numpy())


def test_plain_k2_takes_formats_without_a_decoder():
    """fp_e1 and fp_e3 (no select-tree decoder) go through the grid table,
    nibble-packed; the weight they decode to is JAX's ``dequantize``."""
    rng = np.random.default_rng(15)
    w = (rng.standard_normal((128, 256)) * 0.02).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    for fmt in ("fp_e1", "fp_e3"):
        pw = P.pack(torch.from_numpy(w), fmt, 128)
        assert pw.nibble_packed
        jpw = jax.jit(lambda a: JP.pack(a, fmt, 128))(jnp.asarray(w))
        np.testing.assert_array_equal(_bits(P.dequantize(pw)),
                                      _bits(JP.dequantize(jpw)))
        ref = x @ P.dequantize(pw).T
        out = QM.packed_matmul(x, pw.codes, pw.scales, fmt, 128, True)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fmt", ["fp_e1", "fp_e3", "fp6_e3m2"])
def test_packed_linear_without_decoder_matches_jax(monkeypatch, fmt, dtype):
    """Formats outside ``KERNEL_FMTS`` take JAX's own route on every
    device (``_packed_call``: dequantize to ``x.dtype``, one product) and
    never reach K2, whose wrapper raises for them on the card.  The
    dequantized weights are bit-equal, so the products differ only in
    their float32 sums: within ``2 K 2^-24 * (|x| @ |w|^T)`` at float32,
    and one bfloat16 gap at that size at bfloat16 (each side rounds its
    float32 sum to bfloat16 once)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(16)
    k, n = 384, 256
    x = rng.standard_normal((3, 7, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    jpw = jax.jit(lambda a: JP.pack(a, fmt, 128))(jnp.asarray(w))
    theirs = _as_np(jax.jit(functools.partial(JK.packed_linear,
                                              force_jnp=True))(
        jnp.asarray(x).astype(jdt), jpw))

    def no_kernel(*args, **kwargs):
        raise AssertionError("packed_linear reached K2")

    monkeypatch.setattr(QM, "packed_matmul", no_kernel)
    pw = P.pack(torch.from_numpy(w), fmt, 128)
    assert pw.nibble_packed == (fmt != "fp6_e3m2")
    xt = torch.from_numpy(x).to(tdt)
    ours = QM.packed_linear(xt, pw)
    assert ours.shape == (3, 7, n) and ours.dtype == tdt
    wd = P.dequantize(pw, tdt).float()
    size = xt.float().abs().reshape(-1, k) @ wd.abs().T
    tol = (2 * k * 2.0 ** -24 * size).reshape(3, 7, n)
    if tdt == torch.bfloat16:
        tol = bf16_gap(ours.float(), tol)
    err = (ours.float() - torch.from_numpy(theirs.copy())).abs()
    assert (err <= tol).all(), f"max err/tol {(err / tol).max()}"
