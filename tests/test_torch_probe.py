"""Kernels K6 and K7 (the int8 rate probe's GEMMs) against the JAX probe.

``scripts/int8_rate_probe.py`` is loaded with ``importlib``; importing it
would point JAX's persistent compilation cache at the repository, so its
``jit_cache.enable`` is replaced by a no-op for the import (no cache is
enabled and JAX's global config stays as it was).  Its Pallas kernels
``pallas_int8`` and ``pallas_bf16`` run in interpret mode: the module's
``pl`` is wrapped so that ``pallas_call`` gets ``interpret=True``; nothing
in the script changes.  The port's plain K6 (the exact integer dot, then
``.to(bfloat16)``) must equal JAX's K6 bit for bit, sums above 2^24
included: both round the int32 sum to float32 first and then to bfloat16,
and a pair of rows planted to sum to 2^24 + 2^16 + 1 shows where one
rounding would differ.  The port's plain K7 must be within
``bf16_probe_gemm_tolerance`` of JAX's K7 (both sum exact bf16 products in
float32, in other orders, then round to bfloat16).  The probe tool itself
needs a card and refuses to run without one.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fpqvar_tpu.utils import jit_cache

from fpqvar_tpu_torch.ops import probe_gemm as PG
from fpqvar_tpu_torch.tools import int8_rate_probe as probe_tool

REPO = Path(__file__).resolve().parent.parent
WITNESS = 2 ** 24 + 2 ** 16 + 1


class _Interpret:
    """``pallas`` with ``pallas_call(..., interpret=True)``."""

    def __init__(self, pl):
        self._pl = pl
        self.pallas_call = functools.partial(pl.pallas_call, interpret=True)

    def __getattr__(self, name):
        return getattr(self._pl, name)


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "int8_rate_probe_script", REPO / "scripts" / "int8_rate_probe.py")
    mod = importlib.util.module_from_spec(spec)
    enable = jit_cache.enable
    jit_cache.enable = lambda *a, **k: None
    try:
        spec.loader.exec_module(mod)
    finally:
        jit_cache.enable = enable
    mod.pl = _Interpret(mod.pl)
    return mod


def _witness_codes(m, k, n, seed):
    """Codes of +-127 whose signs mostly agree (most sums above 2^24), with
    row 0 of ``a`` and column 0 of ``b`` summing to ``WITNESS`` and row 1 of
    ``a`` to its negation.  ``b`` is returned as ``[K, N]``."""
    rng = np.random.default_rng(seed)
    a = np.where(rng.random((m, k)) < 0.9, 127, -127).astype(np.int8)
    b = np.where(rng.random((k, n)) < 0.9, 127, -127).astype(np.int8)
    a[:2], b[:, 0] = 0, 0
    a[0, :1044], b[:1044, 0] = 127, 127
    a[0, 1044], b[1044, 0] = 63, 64
    a[0, 1045], b[1045, 0] = 45, 1
    a[1] = -a[0]
    return a, b


@pytest.mark.parametrize("case", ["random", "acc>2^24"])
def test_plain_k6_equals_jax_pallas_int8(jax_probe, case):
    if case == "random":
        m, k, n, tiles = 64, 384, 256, (32, 128, 128)
        rng = np.random.default_rng(12)
        a = rng.integers(-128, 128, (m, k)).astype(np.int8)
        b = rng.integers(-128, 128, (k, n)).astype(np.int8)
    else:
        m, k, n, tiles = 64, 2048, 128, (32, 128, 512)
        a, b = _witness_codes(m, k, n, 13)
        exact = a.astype(np.int64) @ b.astype(np.int64)
        assert exact[0, 0] == WITNESS and exact[1, 0] == -WITNESS
        assert (np.abs(exact) >= 2 ** 24).mean() > 0.9
    dot = jax_probe.pallas_int8(m, n, k, *tiles)
    theirs = np.asarray(dot(jnp.asarray(a), jnp.asarray(b)))
    assert theirs.dtype == jnp.bfloat16
    before = PG.int8_launches
    ours = PG.int8_probe_gemm(torch.from_numpy(a),
                              torch.from_numpy(np.ascontiguousarray(b.T)))
    assert PG.int8_launches == before               # CPU tensors: plain
    assert ours.dtype == torch.bfloat16 and ours.shape == (m, n)
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                  theirs.view(np.int16))
    if case != "random":
        # two roundings (int32 -> f32 -> bf16) give 2^24; one would give
        # 2^24 + 2^17
        assert float(ours[0, 0]) == 2.0 ** 24
        assert float(ours[1, 0]) == -2.0 ** 24


def test_int32_to_bf16_rounds_twice_in_both_packages():
    """The conversion K6's epilogue reproduces: integers next to bfloat16
    midpoints above 2^24, converted by PyTorch and by JAX's jitted astype,
    equal the float32-then-bfloat16 rounding, not the one-step one."""
    base = [2 ** 24 + 2 ** 16, 2 ** 25 + 2 ** 17, 2 ** 30 + 2 ** 22]
    vals = np.array([v + d for v in base for d in (-1, 1)]
                    + [-(v + 1) for v in base], np.int32)
    ours = torch.from_numpy(vals).to(torch.bfloat16)
    theirs = np.asarray(jax.jit(lambda v: v.astype(jnp.bfloat16))(
        jnp.asarray(vals)))
    two_step = torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16)
    np.testing.assert_array_equal(ours.view(torch.int16).numpy(),
                                  theirs.view(np.int16))
    assert torch.equal(ours, two_step)
    assert float(ours[1]) == 2.0 ** 24           # one step: 2^24 + 2^17


def test_plain_k7_matches_jax_pallas_bf16(jax_probe):
    m, k, n = 64, 384, 256
    rng = np.random.default_rng(14)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    theirs = np.asarray(jax_probe.pallas_bf16(m, n, k, 32, 128, 128)(ja, jb)
                        .astype(jnp.float32))
    ta = torch.from_numpy(a).to(torch.bfloat16)
    tb = torch.from_numpy(np.ascontiguousarray(b.T)).to(torch.bfloat16)
    before = PG.bf16_launches
    ours = PG.bf16_probe_gemm(ta, tb)
    assert PG.bf16_launches == before
    assert ours.dtype == torch.bfloat16 and ours.shape == (m, n)
    tol = PG.bf16_probe_gemm_tolerance(ta, tb).numpy()
    err = np.abs(ours.float().numpy() - theirs)
    assert (err <= tol).all(), f"max err/tol {(err / tol).max()}"


def test_probe_wrappers_reject_bad_operands():
    a8 = torch.zeros((4, 256), dtype=torch.int8)
    with pytest.raises(ValueError, match="K mismatch"):
        PG.int8_probe_gemm(a8, a8[:, :128])
    with pytest.raises(ValueError, match="multiple of 128"):
        PG.int8_probe_gemm(a8[:, :192], a8[:, :192])
    with pytest.raises(TypeError, match="int8"):
        PG.int8_probe_gemm(a8.float(), a8)
    with pytest.raises(ValueError, match="2-D"):
        PG.int8_probe_gemm(a8[None], a8)
    a16 = torch.zeros((4, 192), dtype=torch.bfloat16)
    assert PG.bf16_probe_gemm(a16, a16).shape == (4, 4)   # K % 64 == 0
    with pytest.raises(ValueError, match="multiple of 64"):
        PG.bf16_probe_gemm(a16[:, :96], a16[:, :96])
    with pytest.raises(TypeError, match="bfloat16"):
        PG.bf16_probe_gemm(a16.float(), a16)


def test_rate_probe_needs_a_card():
    assert probe_tool.parse_shapes("4096x1920x5760,8x16x32") == [
        (4096, 1920, 5760), (8, 16, 32)]
    with pytest.raises(RuntimeError, match="CUDA"):
        probe_tool.run("64x128x64", iters=1, device="cpu")
