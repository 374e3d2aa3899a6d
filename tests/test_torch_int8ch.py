"""The per-channel int8 recipes against the JAX package: kernels K3 and K4,
the weights-only product, the per-token / per-channel codes and the
runtime.

On the CPU the K3 and K4 wrappers run their plain PyTorch versions; these
are held bit for bit against JAX's Pallas kernels in interpret mode
(``_int8ch_matmul_2d``, ``_fused_ch_matmul_2d``) and against the chain
that JAX's generation runs under ``jit`` (``_channel_dot`` of
``quant_int_codes``).  Every dot is an exact integer sum, so no tolerance
is needed.  JAX's *eager* chain divides ``absmax / gmax`` where the jitted
one multiplies by ``f32(1/gmax)``; a port that copied the division would
match the eager chain, and one test shows that the two differ.  The
weights-only product (plain PyTorch on both sides) differs from JAX's only
in the order of its float32 sums.  Inputs come from numpy seeds.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.ops import packing as JP
from fpqvar_tpu.ops.pallas import int8_matmul as JK

from fpqvar_tpu_torch.config import bench_recipes
from fpqvar_tpu_torch.ops import int8_matmul as K
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.quantize.runtime import build_runtime

FORMATS = ["fp_e2", "fp_e3", "fp_e1", "fp6_e2m3"]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.uint32)


def _rows(seed, m, k, scale=3.0):
    """Gaussian rows with an all-zero row and a row of tiny values."""
    x = np.random.default_rng(seed).standard_normal((m, k)).astype(
        np.float32) * scale
    x[m // 3] = 0.0
    x[m // 2] *= 1e-30
    return x


def _weights(seed, n, k):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)) * 0.02).astype(np.float32)


def _jit_pack(w, fmt, k):
    return jax.jit(functools.partial(JP.pack_int_codes, fmt=fmt,
                                     group_size=k))(jnp.asarray(w))


def _port_pack(jpw):
    """The JAX pack in the port's layout (codes [N, K])."""
    return (torch.from_numpy(np.ascontiguousarray(
        np.swapaxes(np.asarray(jpw.codes), -1, -2))),
            torch.from_numpy(np.array(jpw.scales)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_per_token_and_per_channel_codes_bit_equal(fmt):
    """``quant_int_codes`` with one group per row and ``pack_int_codes``
    with one scale per output channel (scales ``[1, N]``) are JAX's jitted
    functions, bit for bit."""
    x = _rows(0, 9, 384)
    codes, scales = P.quant_int_codes(torch.from_numpy(x), fmt, 384)
    jc, js = jax.jit(functools.partial(JP.quant_int_codes, fmt=fmt,
                                       group_size=384))(jnp.asarray(x))
    assert tuple(scales.shape) == (9, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(scales), _bits(js))
    w = _weights(1, 256, 384)[None].repeat(2, 0)      # depth-stacked
    w[1] *= 3.0
    ours = P.pack_int_codes(torch.from_numpy(w), fmt, 384)
    theirs = _jit_pack(w, fmt, 384)
    assert tuple(ours.scales.shape) == (2, 1, 256)
    np.testing.assert_array_equal(
        ours.codes.numpy(), np.swapaxes(np.asarray(theirs.codes), -1, -2))
    np.testing.assert_array_equal(_bits(ours.scales), _bits(theirs.scales))


@pytest.mark.parametrize("m,k,n", [(48, 384, 256), (16, 2304, 128),
                                   (37, 256, 128)])
def test_plain_k3_bit_equal_to_jax(m, k, n):
    """K3's plain version against ``_int8ch_matmul_2d`` in interpret mode
    at float32 and bfloat16 output, and against the jitted
    ``_channel_dot`` (K = 2304: the d36 width; M = 37: ragged)."""
    jac, jas = jax.jit(functools.partial(JP.quant_int_codes, fmt="fp_e2",
                                         group_size=k))(
        jnp.asarray(_rows(2, m, k)))
    jpw = _jit_pack(_weights(3, n, k), "fp_e2", k)
    ac, asc = torch.from_numpy(np.array(jac)), torch.from_numpy(np.array(jas))
    wc, ws = _port_pack(jpw)
    chain = np.asarray(jax.jit(JK._channel_dot)(jac, jas, jpw.codes,
                                                jpw.scales))
    for tdt, jdt in DTYPES.values():
        theirs = JK._int8ch_matmul_2d(jac, jas, jpw.codes, jpw.scales, n=n,
                                      k_dim=k, out_dtype=jdt, interpret=True)
        before = K.ch_launches
        ours = K.int8ch_gemm(ac, asc, wc, ws, tdt)
        assert K.ch_launches == before            # CPU tensors: plain version
        assert ours.shape == (m, n) and ours.dtype == tdt
        np.testing.assert_array_equal(_bits(ours.float()),
                                      _bits(theirs.astype(jnp.float32)))
    np.testing.assert_array_equal(_bits(K.channel_dot_ref(ac, asc, wc, ws)),
                                  _bits(chain))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_plain_k4_bit_equal_to_jax(fmt, dtype):
    """K4's plain version against ``_fused_ch_matmul_2d`` in interpret mode
    and the jitted chain ``_channel_dot(quant_int_codes(x))``, with an
    all-zero row, a row of tiny values and a ragged M."""
    tdt, jdt = DTYPES[dtype]
    m, k, n = 37, 384, 256
    x = torch.from_numpy(_rows(4, m, k)).to(tdt)
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    jpw = _jit_pack(_weights(5, n, k), fmt, k)
    wc, ws = _port_pack(jpw)
    chain = jax.jit(lambda x, wc, ws: JK._channel_dot(
        *JP.quant_int_codes(x, fmt, k), wc, ws).astype(x.dtype))(
        xj, jpw.codes, jpw.scales)
    kern = JK._fused_ch_matmul_2d(xj, jpw.codes, jpw.scales, fmt=fmt, n=n,
                                  k_dim=k, out_dtype=jdt, interpret=True)
    before = K.fused_launches
    ours = K.fused_ch_gemm(x, wc, ws, fmt, tdt)
    assert K.fused_launches == before             # CPU tensors: plain version
    assert ours.shape == (m, n) and ours.dtype == tdt
    for theirs in (chain, kern):
        np.testing.assert_array_equal(_bits(ours.float()),
                                      _bits(theirs.astype(jnp.float32)))
    assert (ours[m // 3] == 0).all()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_k4_quantize_step_bit_equal_to_jax(fmt, dtype):
    """K4's phase (a), ``fused_ch_quantize_ref``, quantizes each row once
    over its whole K: bit-equal to JAX's jitted ``quant_int_codes`` with
    one group per row, at float32 and bfloat16 input, with an all-zero row
    (scale 1, codes 0), a row of tiny values and a ragged M."""
    tdt, jdt = DTYPES[dtype]
    m, k = 37, 384
    x = torch.from_numpy(_rows(10, m, k)).to(tdt)
    xj = jnp.asarray(x.float().numpy()).astype(jdt)
    codes, rs = K.fused_ch_quantize_ref(x, fmt)
    jc, js = jax.jit(functools.partial(JP.quant_int_codes, fmt=fmt,
                                       group_size=k))(xj)
    assert codes.shape == (m, k) and codes.dtype == torch.int8
    assert tuple(rs.shape) == (m, 1) and rs.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_bits(rs), _bits(js))
    assert (codes[m // 3] == 0).all()
    assert float(rs[m // 3, 0]) == 1.0 / P.CODE_MULT[fmt]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_k4_plain_is_quantize_then_k3(fmt, dtype):
    """The composition the kernel runs: ``fused_ch_gemm_ref`` equals phase
    (a) (``fused_ch_quantize_ref``) followed by K3's plain version
    (``int8ch_gemm_ref``) exactly, at both output dtypes, and the CPU
    wrappers of K4 and K3 give the same numbers."""
    tdt, _ = DTYPES[dtype]
    m, k, n = 37, 384, 256
    x = torch.from_numpy(_rows(11, m, k)).to(tdt)
    pw = P.pack_int_codes(torch.from_numpy(_weights(12, n, k)), fmt, k)
    ac, asc = K.fused_ch_quantize_ref(x, fmt)
    for out_dtype in (tdt, torch.float32):
        want = K.int8ch_gemm_ref(ac, asc, pw.codes, pw.scales, out_dtype)
        got = K.fused_ch_gemm_ref(x, pw.codes, pw.scales, fmt, out_dtype)
        assert got.dtype == out_dtype and torch.equal(got, want)
        assert torch.equal(
            K.fused_ch_gemm(x, pw.codes, pw.scales, fmt, out_dtype),
            K.int8ch_gemm(ac, asc, pw.codes, pw.scales, out_dtype))


def test_jax_eager_chain_differs_from_k4():
    """JAX's eager chain (``absmax / gmax``, a true division) gives other
    row scales than the jitted chain and K4 (``absmax * f32(1/gmax)``):
    a port that divided would fail the bit-equality tests above."""
    m, k, n = 64, 1024, 256
    x = _rows(6, m, k)
    jpw = _jit_pack(_weights(7, n, k), "fp_e2", k)
    wc, ws = _port_pack(jpw)
    eager = np.asarray(JK._channel_dot(
        *JP.quant_int_codes(jnp.asarray(x), "fp_e2", k), jpw.codes,
        jpw.scales))
    ours = K.fused_ch_gemm(torch.from_numpy(x), wc, ws, "fp_e2").numpy()
    kern = JK._fused_ch_matmul_2d(jnp.asarray(x), jpw.codes, jpw.scales,
                                  fmt="fp_e2", n=n, k_dim=k,
                                  out_dtype=jnp.float32, interpret=True)
    np.testing.assert_array_equal(_bits(ours), _bits(kern))
    differs = (_bits(ours) != _bits(eager)).any(axis=1)
    assert differs.sum() >= 4, differs.sum()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "per_group"])
def test_wonly_dot_matches_jax(per_channel, dtype):
    """``wonly_dot`` against JAX's ``_wonly_dot`` (both round ``x`` to
    bfloat16 and take exact products): within the float32 summation order,
    (K + 2) * 2^-24 of the sum of the terms' magnitudes per element."""
    tdt, jdt = DTYPES[dtype]
    k, n = 384, 256
    gs = k if per_channel else 128
    x = np.random.default_rng(8).standard_normal((3, 11, k)).astype(
        np.float32)
    x = torch.from_numpy(x).to(tdt)
    jpw = _jit_pack(_weights(9, n, k), "fp_e2", gs)
    wc, ws = _port_pack(jpw)
    theirs = jax.jit(JK._wonly_dot, static_argnums=3)(
        jnp.asarray(x.float().numpy()).astype(jdt), jpw.codes, jpw.scales,
        gs)
    ours = K.wonly_dot(x, wc, ws, gs)
    assert ours.shape == (3, 11, n) and ours.dtype == torch.float32
    xb = x.to(torch.bfloat16).float().abs()
    if per_channel:
        mag = (xb @ wc.float().abs().T) * ws.abs()
    else:
        wdq = (wc.float().reshape(n, k // gs, gs) * ws.T[:, :, None]
               ).to(torch.bfloat16).float().reshape(n, k)
        mag = xb @ wdq.abs().T
    tol = (k + 2) * 2.0 ** -24 * mag.numpy()
    assert (np.abs(ours.numpy() - np.asarray(theirs)) <= tol).all()


def test_runtime_takes_the_per_channel_recipes():
    """``build_runtime`` accepts the four recipes with JAX's formats and
    rejects a per-channel / per-group mix with JAX's ``ValueError``."""
    rt = {mode: build_runtime(bench_recipes()[mode], device="cpu")
          for mode in ("int8ch", "int8chs", "int8chsnr", "w4a16")}
    assert rt["int8ch"].act_fmts == {
        "mat_qkv": "fp_e2", "proj": "fp_e2", "fc1": "fp_e2",
        "fc2": "fp_e1m2_neg_e2m1_pos"}
    assert set(rt["int8chs"].act_fmts.values()) == {"fp_e2"}
    assert set(rt["w4a16"].act_fmts.values()) == {"bf16"}
    for mode in ("int8ch", "int8chs"):
        assert rt[mode].transform and rt[mode].rotation_block is not None
    for mode in ("int8chsnr", "w4a16"):
        assert not rt[mode].transform and rt[mode].rotation_block is None
    assert all(v is None for r in rt.values() for v in r.act_q.values())
    with pytest.raises(ValueError, match="per-token"):
        build_runtime(bench_recipes()["int8ch"].replace(
            act_quant="per_group"), device="cpu")
    with pytest.raises(ValueError, match="per-group or per-token"):
        build_runtime(bench_recipes()["int8ch"].replace(
            act_quant="per_tensor"), device="cpu")
