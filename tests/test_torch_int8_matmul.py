"""Kernels K1 and K5 (grouped int8 GEMMs) and the int8 linears against
the JAX package.

On the CPU the wrapper runs K1's plain PyTorch version; it is held against
JAX's Pallas kernel in interpret mode and its jnp mirror.  The group dots
are exact integers on every side, so the results differ only in the f32
order of the sum over groups: the tolerance is 1e-5 of
``sum_g |sa*sw*part|`` per element (``int8_group_gemm_tolerance``); with
one group (``group_size == K``) the 2-D product is bit-equal to JAX's
``_channel_dot``, and so are the linears, which then route through K4
(K3 for the dual grid).  JAX's functions run under ``jit``, as in its
generation.  K5's plain version (K1's on the flattened ``[B*T, K]`` rows,
cast to the output dtype) is held against JAX's batch-gridded kernel
``_int8_matmul_3d`` in interpret mode, which pads T to 32 and slices the
padding off: within K1's bound for a float32 output, plus one bfloat16 gap
for a bfloat16 one (the two f32 sums may round to neighbouring bfloat16
values).  ``tests/test_torch_cuda.py`` holds the Hopper kernels against
their plain versions on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.ops import packing as JP
from fpqvar_tpu.ops.pallas import int8_matmul as JK

from fpqvar_tpu_torch.ops import int8_matmul as K
from fpqvar_tpu_torch.ops import packing as P


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    return x, w


def _assert_within(ours, theirs, tol):
    err = np.abs(np.asarray(ours, np.float32) - np.asarray(theirs, np.float32))
    tol = np.asarray(tol)
    assert (err <= tol).all(), f"max err/tol {(err / tol).max()}"


def test_plain_k1_matches_jax_kernel_and_reference():
    m, k, n = 37, 640, 384                       # ragged M, G = 5
    x, w = _operands(0, m, k, n)
    jac, jasc = jax.jit(functools.partial(
        JP.quant_int_codes, fmt="fp_e2", group_size=128))(jnp.asarray(x))
    jpw = JP.pack_int_codes(jnp.asarray(w), "fp_e2", 128)
    jkern = JK._int8_matmul_2d(jac, jasc, jpw.codes, jpw.scales,
                               group_size=128, n=n, k_dim=k, interpret=True)
    jref = JK._jnp_reference(jac, jasc, jpw.codes, jpw.scales, 128)

    ac, asc = P.quant_int_codes(torch.from_numpy(x), "fp_e2", 128)
    pw = P.pack_int_codes(torch.from_numpy(w), "fp_e2", 128)
    before = K.launches
    ours = K.int8_group_gemm(ac, asc, pw.codes, pw.scales, 128)
    assert K.launches == before                  # CPU tensors: plain version
    assert ours.shape == (m, n) and ours.dtype == torch.float32
    tol = K.int8_group_gemm_tolerance(ac, asc, pw.codes, pw.scales, 128)
    _assert_within(ours.numpy(), jkern, tol.numpy())
    _assert_within(ours.numpy(), jref, tol.numpy())


def test_plain_k1_single_group_is_channel_dot():
    """group_size == K: JAX's _channel_dot arithmetic, bit for bit."""
    m, k, n = 9, 128, 256
    x, w = _operands(1, m, k, n)

    @jax.jit
    def theirs_fn(x, w):
        ac, asc = JP.quant_int_codes(x, "fp_e2", k)
        pw = JP.pack_int_codes(w, "fp_e2", k)
        return JK._channel_dot(ac, asc, pw.codes, pw.scales)

    theirs = theirs_fn(jnp.asarray(x), jnp.asarray(w))
    ac, asc = P.quant_int_codes(torch.from_numpy(x), "fp_e2", k)
    pw = P.pack_int_codes(torch.from_numpy(w), "fp_e2", k)
    ours = K.int8_group_gemm(ac, asc, pw.codes, pw.scales, k)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("k,gs", [(256, 128), (128, 128), (384, 384)])
def test_int8_linear_matches_jax(k, gs):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 33, k)).astype(np.float32)
    w = (rng.standard_normal((192, k)) * 0.02).astype(np.float32)
    jpw = JP.pack_int_codes(jnp.asarray(w), "fp_e2", gs)
    theirs = jax.jit(functools.partial(JK.int8_linear, act_fmt="fp_e2",
                                       force_jnp=True))(jnp.asarray(x), jpw)
    pw = P.pack_int_codes(torch.from_numpy(w), "fp_e2", gs)
    ours = K.int8_linear(torch.from_numpy(x), pw, "fp_e2")
    assert ours.shape == (4, 33, 192) and ours.dtype == torch.float32
    # with one group too: XLA may fuse the two scale multiplies of its
    # N-D _channel_dot in another order
    ac, asc = P.quant_int_codes(torch.from_numpy(x.reshape(-1, k)),
                                "fp_e2", gs)
    tol = K.int8_group_gemm_tolerance(ac, asc, pw.codes, pw.scales, gs)
    _assert_within(ours.numpy().reshape(-1, 192),
                   np.asarray(theirs).reshape(-1, 192), tol.numpy())


def _jit_pack(w, fmt, gs):
    return jax.jit(functools.partial(JP.pack_int_codes, fmt=fmt,
                                     group_size=gs))(jnp.asarray(w))


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
@pytest.mark.parametrize("k", [256, 1024])
def test_int8_linear_per_channel_bit_equal(k, dual):
    """group_size == K: the port's K4 route gives JAX's jitted N-D
    ``int8_linear`` bit for bit on the same weights.  fc2's dual grid (K3
    twice, the float32 halves summed) gives the sum of JAX's two jitted
    ``_channel_dot`` halves bit for bit.  JAX's jitted ``int8_linear_dual``
    itself differs from that sum in the last bit: XLA on the CPU contracts
    ``(p_neg*s_neg)*ws + half_pos`` into one fused multiply-add, which
    skips the rounding of ``(p_neg*s_neg)*ws``: it is held within that
    rounding (2^-24 of ``|half_neg|``) and one unit in the last place of
    the sum."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 19, k)).astype(np.float32)
    x[1, 4] = 0.0                                    # an all-zero row
    w = (rng.standard_normal((256, k)) * 0.02).astype(np.float32)
    jpw = _jit_pack(w, "fp_e2", k)
    pw = P.pack_int_codes(torch.from_numpy(w), "fp_e2", k)
    fmt = "fp_e1m2_neg_e2m1_pos" if dual else "fp_e2"
    jfn = JK.int8_linear_dual if dual else JK.int8_linear
    theirs = np.asarray(jax.jit(functools.partial(jfn, act_fmt=fmt))(
        jnp.asarray(x), jpw))
    counts = (K.launches, K.ch_launches, K.fused_launches)
    ours = (K.int8_linear_dual if dual else K.int8_linear)(
        torch.from_numpy(x), pw, fmt).numpy()
    assert (K.launches, K.ch_launches, K.fused_launches) == counts  # CPU
    assert ours.shape == (3, 19, 256) and ours.dtype == np.float32
    if not dual:
        np.testing.assert_array_equal(ours.view(np.uint32),
                                      theirs.view(np.uint32))
        return

    @jax.jit
    def halves(x, wc, ws):
        cn, sn, cp, sp = JP.quant_int_codes_dual(x, fmt, k)
        return JK._channel_dot(cn, sn, wc, ws), JK._channel_dot(cp, sp, wc, ws)

    neg, pos = (np.asarray(h) for h in halves(jnp.asarray(x), jpw.codes,
                                               jpw.scales))
    np.testing.assert_array_equal(ours.view(np.uint32),
                                  (neg + pos).view(np.uint32))
    tol = 2.0 ** -24 * (np.abs(neg) + 2.0 * np.abs(ours))
    assert (np.abs(ours - theirs) <= tol).all()
    assert (ours != theirs).any()        # the contraction shows at this size


@pytest.mark.parametrize("gs", [128, 512])
def test_int8_linear_dual_matches_jax(gs):
    rng = np.random.default_rng(3)
    k = 512
    x = rng.standard_normal((2, 21, k)).astype(np.float32)
    w = (rng.standard_normal((128, k)) * 0.02).astype(np.float32)
    fmt = "fp_e1m2_neg_e2m1_pos"
    jpw = JP.pack_int_codes(jnp.asarray(w), "fp_e2", gs)
    theirs = jax.jit(functools.partial(JK.int8_linear_dual, act_fmt=fmt,
                                       force_jnp=True))(jnp.asarray(x), jpw)
    pw = P.pack_int_codes(torch.from_numpy(w), "fp_e2", gs)
    ours = K.int8_linear_dual(torch.from_numpy(x), pw, fmt)
    assert ours.shape == (2, 21, 128)
    cn, sn, cp, sp = P.quant_int_codes_dual(
        torch.from_numpy(x.reshape(-1, k)), fmt, gs)
    tol = (K.int8_group_gemm_tolerance(cn, sn, pw.codes, pw.scales, gs)
           + K.int8_group_gemm_tolerance(cp, sp, pw.codes, pw.scales, gs))
    _assert_within(ours.numpy().reshape(-1, 128),
                   np.asarray(theirs).reshape(-1, 128), tol.numpy())


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [64, 33, 1])
def test_plain_k5_matches_jax_kernel3(t, out_dtype):
    b, k, n = 3, 384, 256
    rng = np.random.default_rng(10)
    x = rng.standard_normal((b, t, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    jac, jasc = jax.jit(functools.partial(
        JP.quant_int_codes, fmt="fp_e2", group_size=128))(jnp.asarray(x))
    jpw = JP.pack_int_codes(jnp.asarray(w), "fp_e2", 128)
    theirs = JK._int8_matmul_3d(jac, jasc, jpw.codes, jpw.scales,
                                group_size=128, n=n, k_dim=k,
                                out_dtype=getattr(jnp, out_dtype),
                                interpret=True)
    ac, asc = P.quant_int_codes(torch.from_numpy(x), "fp_e2", 128)
    np.testing.assert_array_equal(ac.numpy(), np.asarray(jac))
    pw = P.pack_int_codes(torch.from_numpy(w), "fp_e2", 128)
    dt = getattr(torch, out_dtype)
    before = K.nd_launches
    ours = K.int8_group_gemm_nd(ac, asc, pw.codes, pw.scales, 128, dt)
    assert K.nd_launches == before                 # CPU tensors: plain
    assert ours.shape == (b, t, n) and ours.dtype == dt
    tol = K.int8_group_gemm_nd_tolerance(ac, asc, pw.codes, pw.scales, 128,
                                         dt)
    _assert_within(ours.float().numpy(),
                   np.asarray(theirs.astype(jnp.float32)), tol.numpy())


def _spy_routes(monkeypatch):
    """Record which GEMM wrapper each linear reaches (CPU tensors run the
    plain versions, so the launch counters stay still)."""
    routes = []
    for name, tag in (("int8_group_gemm", "K1"),
                      ("int8_group_gemm_nd", "K5")):
        real = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _r=real, _t=tag, **kw:
                            routes.append(_t) or _r(*a, **kw))
    return routes


@pytest.mark.parametrize("dual", [False, True], ids=["single", "dual"])
def test_int8_linear_bf16_nd_matches_jax(monkeypatch, dual):
    """bfloat16 ``[B, T, K]`` through the grouped route: the single grid
    reaches K5 (its output written in bfloat16), fc2's dual grid K1 twice
    (its float32 halves summed, then cast), each within the bound of JAX's
    jitted ``int8_linear`` (K1 into float32, then a cast) plus one
    bfloat16 gap."""
    rng = np.random.default_rng(11)
    k, n = 256, 192
    x = rng.standard_normal((4, 33, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jpw = JP.pack_int_codes(jnp.asarray(w), "fp_e2", 128)
    fmt = "fp_e1m2_neg_e2m1_pos" if dual else "fp_e2"
    jfn = JK.int8_linear_dual if dual else JK.int8_linear
    theirs = np.asarray(jax.jit(functools.partial(
        jfn, act_fmt=fmt, force_jnp=True))(xb, jpw).astype(jnp.float32))
    pw = P.pack_int_codes(torch.from_numpy(w), "fp_e2", 128)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    routes = _spy_routes(monkeypatch)
    ours = (K.int8_linear_dual if dual else K.int8_linear)(xt, pw, fmt)
    assert routes == (["K1", "K1"] if dual else ["K5"])
    assert ours.shape == (4, 33, n) and ours.dtype == torch.bfloat16
    x2 = xt.reshape(-1, k)
    if dual:
        cn, sn, cp, sp = P.quant_int_codes_dual(x2, fmt, 128)
        tol = (K.int8_group_gemm_tolerance(cn, sn, pw.codes, pw.scales, 128)
               + K.int8_group_gemm_tolerance(cp, sp, pw.codes, pw.scales,
                                             128))
        tol = tol + K.bf16_gap(ours.reshape(-1, n), tol)
    else:
        ac, asc = P.quant_int_codes(xt, fmt, 128)
        tol = K.int8_group_gemm_nd_tolerance(ac, asc, pw.codes, pw.scales,
                                             128).reshape(-1, n)
    _assert_within(ours.float().numpy().reshape(-1, n),
                   theirs.reshape(-1, n), tol.numpy())


def test_int8_group_gemm_rejects_bad_operands():
    ac = torch.zeros((4, 256), dtype=torch.int8)
    asc = torch.ones((4, 2))
    wc = torch.zeros((8, 256), dtype=torch.int8)
    wsc = torch.ones((2, 8))
    with pytest.raises(ValueError, match="multiples of 128"):
        K.int8_group_gemm(ac[:, :200], asc, wc[:, :200], wsc, 100)
    with pytest.raises(ValueError, match="scales"):
        K.int8_group_gemm(ac, asc[:, :1], wc, wsc, 128)
    with pytest.raises(TypeError, match="int8"):
        K.int8_group_gemm(ac.to(torch.int32), asc, wc, wsc, 128)
    with pytest.raises(TypeError, match="float32"):
        K.int8_group_gemm(ac, asc.double(), wc, wsc, 128)
    with pytest.raises(ValueError, match="K mismatch"):
        K.int8_group_gemm(ac, asc, wc[:, :128], wsc, 128)
    # K3 and K4 take one scale per row and per column only
    with pytest.raises(ValueError, match="asc"):
        K.int8ch_gemm(ac, asc, wc, wsc)
    x = torch.zeros((4, 256))
    with pytest.raises(ValueError, match="K4 quantizes"):
        K.fused_ch_gemm(x, wc, wsc[:1], "fp6_e3m2")
    with pytest.raises(TypeError, match="out_dtype"):
        K.fused_ch_gemm(x, wc, wsc[:1], "fp_e2", torch.float16)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        K.fused_ch_gemm(x.half(), wc, wsc[:1], "fp_e2")
    # K5 takes [B, T, K] codes and [B, T, G] scales
    with pytest.raises(ValueError, match="3-D"):
        K.int8_group_gemm_nd(ac, asc, wc, wsc, 128)
    with pytest.raises(ValueError, match=r"asc must be \[2, 2, G\]"):
        K.int8_group_gemm_nd(ac.reshape(2, 2, 256), asc.reshape(1, 4, 2),
                             wc, wsc, 128)
    with pytest.raises(TypeError, match="out_dtype"):
        K.int8_group_gemm_nd(ac.reshape(2, 2, 256), asc.reshape(2, 2, 2),
                             wc, wsc, 128, torch.float16)
