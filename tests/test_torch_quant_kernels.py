"""The quantizer kernels Q1-Q3 (``ops/quant_kernels.py``) checked here
without a card.

The kernels run only on the card (``tests/test_torch_cuda.py`` holds them
to their plain versions there, bit for bit); what a CPU can check is
everything around them:

(a) the host tables the wrappers pass (midpoints, value or code table,
    ``f32(1/max|grid|)``, multiplier, table size) for every grid and both
    halves of every dual grid are what the plain functions use;
(b) a numpy model of the kernels' element rule (binary lifting over the
    table, a NaN-propagating absmax or min / max, the scale rounded to
    x's dtype where the caller rounds it, IEEE float32 divisions and
    products with nothing fused, rounding to bfloat16 where PyTorch
    rounds) is bit-equal (int views; NaN where the plain version has NaN)
    to the plain compare-sum versions over every grid, bfloat16 and
    float32, 10^5 scaled normals and every midpoint, grid value, +-0,
    +-inf, NaN, +-1e30 and denormal scales with each one's neighbours;
(c) on the CPU every public quantizer runs its plain version and no
    kernel counter moves; each quantizer that the runtime builds for
    ``chip_smoke.py``'s main-path recipes and ``paper_recipes()`` names
    the kernel it takes on a card, or a named plain route; and with the
    kernel route taken on the CPU through the numpy model in place of the
    launches, a ``var_tiny`` generation equals the plain one, launching
    the kernels as often as ``chip_smoke.py``'s gates say per block
    forward;
(d) a tensor that autograd would record raises on the kernel route,
    while the STE (its delta under ``no_grad``) passes.
"""
import dataclasses
from functools import partial

import numpy as np
import pytest
import torch

from fpqvar_tpu_torch.config import (GenerateConfig, bench_recipes,
                                     paper_recipes, var_tiny)
from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                     init_vqvae_params)
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quant_kernels as QK
from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.quantize import quantize_var_params
from fpqvar_tpu_torch.quantize.runtime import build_runtime
from fpqvar_tpu_torch.quantize.ste import fp_quant_ste, int_sym_ste
from torch_threads import one_torch_thread  # noqa: F401

F32 = np.float32
#: every grid a kernel takes: (label, fmt, half or None)
ALL_GRIDS = ([(f, f, None) for f in G.GRIDS]
             + [(f"{f}-{h}", f, h) for f in G.DUAL_GRIDS
                for h in ("neg", "pos")])
#: (bf16, rule) of the model tests: the kernels' rule ("own_half": one
#: division and one table walk a value) and the rule of both halves' walks
#: for every value, which the first kernels took and the plain versions
#: spell out; ids of the second keep the tests' first names
RULES = [(False, "both_halves"), (True, "both_halves"), (False, "own_half"),
         (True, "own_half")]
RULE_IDS = ["f32", "bf16", "f32-own_half", "bf16-own_half"]


# ---------------------------------------------------------------------------
# The numpy model of the kernels' arithmetic
# ---------------------------------------------------------------------------

def rx(a, bf16: bool) -> np.ndarray:
    """``a`` (float32) rounded to x's dtype: bfloat16 to nearest even (the
    kernels' ``__float2bfloat16_rn``), float32 itself."""
    a = np.asarray(a, F32)
    if not bf16:
        return a
    u = a.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isnan(a), a, r.view(F32))


def lift(q, t: QK.GridTable) -> np.ndarray:
    """The kernels' binary lifting: the count of midpoints <= q."""
    pos = np.zeros(q.shape, np.int64)
    step = t.cap // 2
    while step:
        cand = pos + step
        m = t.mids[np.minimum(cand, t.n_mids) - 1]
        pos = np.where((cand <= t.n_mids) & (q >= m), cand, pos)
        step //= 2
    return pos


def padded(tabs) -> tuple:
    """The tables as a kernel stages them: every midpoint array padded with
    NaN to the largest table's size, and the outputs likewise (zeros),
    one after the other (the dual grid's negative half, then its positive
    half); returns ``(mids, outs, cap)``."""
    cap = max(t.cap for t in tabs)
    mids = np.full(len(tabs) * cap, np.nan, F32)
    outs = np.zeros(len(tabs) * cap, tabs[0].out.dtype)
    for i, t in enumerate(tabs):
        mids[i * cap:i * cap + t.n_mids] = t.mids
        outs[i * cap:i * cap + t.n_mids + 1] = t.out
    return mids, outs, cap


def snap(q, mids, cap: int, base=0) -> np.ndarray:
    """The kernels' binary lifting over a staged table from ``base``: no
    bound check, since ``q >= NaN`` is false for the padding."""
    pos = np.zeros(np.shape(q), np.int64)
    step = cap // 2
    while step:
        with np.errstate(invalid="ignore"):
            hit = q >= mids[base + pos + step - 1]
        pos = np.where(hit, pos + step, pos)
        step //= 2
    return pos


def _scale(amax, inv, rounded: bool):
    """``where(amax > 0, amax * inv, 1)``, the product rounded where the
    caller rounds it (``rounded`` is the rounding to bfloat16 or not)."""
    return np.where(amax > 0, rx(amax * F32(inv), rounded), F32(1.0))


def _halves(x2):
    zero = F32(0.0)
    return np.where(x2 <= 0, x2, zero), np.where(x2 > 0, x2, zero)


def _clamp(v, lo, hi):
    return np.where(np.isnan(v), v, np.minimum(np.maximum(v, F32(lo)),
                                               F32(hi))).astype(F32)


def model_q1(x, gs: int, tabs, bf16: bool, clip=None,
             rule: str = "own_half") -> np.ndarray:
    """Q1 on ``x`` (float32 values of x's dtype, flat): one table, or the
    dual grid's two.  ``rule`` is how the dual grid is taken:
    ``"own_half"`` as the kernel takes it (each value divided and walked
    on its own half's staged table only; the other half's output the
    group's constant, the half's +0 divided by its scale and walked once)
    or ``"both_halves"`` (both halves divided and walked for every value,
    over the bound-checked table)."""
    x2 = np.asarray(x, F32).reshape(-1, gs)
    with np.errstate(all="ignore"):
        if len(tabs) == 1:
            t = tabs[0]
            w = x2 if clip is None else _clamp(x2, -clip, clip)
            s = _scale(np.abs(w).max(axis=1, keepdims=True), t.inv, bf16)
            if rule == "both_halves":
                return rx(t.out[lift(w / s, t)] * s, bf16).reshape(-1)
            mids, outs, cap = padded(tabs)
            return rx(outs[snap(w / s, mids, cap)] * s, bf16).reshape(-1)
        tn, tp = tabs
        vn, vp = _halves(x2)
        sn = _scale(np.abs(vn).max(axis=1, keepdims=True), tn.inv, bf16)
        sp = _scale(np.abs(vp).max(axis=1, keepdims=True), tp.inv, bf16)
        if rule == "both_halves":
            yn = rx(tn.out[lift(vn / sn, tn)] * sn, bf16)
            yp = rx(tp.out[lift(vp / sp, tp)] * sp, bf16)
            return rx(yn + yp, bf16).reshape(-1)
        mids, outs, cap = padded(tabs)
        yn0 = rx(outs[snap(F32(0.0) / sn, mids, cap)] * sn, bf16)
        yp0 = rx(outs[cap + snap(F32(0.0) / sp, mids, cap, cap)] * sp, bf16)
        pos, w, s, base = _own_half(x2, sn, sp, cap)
        yq = rx(outs[base + snap(w / s, mids, cap, base)] * s, bf16)
        y = np.where(pos, rx(yn0 + yq, bf16), rx(yq + yp0, bf16))
        return y.reshape(-1)


def model_q2(x, gs: int, tabs, bf16: bool, round_scale: bool,
             rule: str = "own_half") -> tuple:
    """Q2 on ``x`` -> (codes int8, scales float32 per group) of each
    table; ``rule`` as for :func:`model_q1`."""
    x2 = np.asarray(x, F32).reshape(-1, gs)
    parts = [x2] if len(tabs) == 1 else list(_halves(x2))
    out, scales = [], []
    with np.errstate(all="ignore"):
        for t, v in zip(tabs, parts):
            s = _scale(np.abs(v).max(axis=1, keepdims=True), t.inv,
                       bf16 and round_scale)
            scales.append(s)
            codes = t.out[lift(v / s, t)].astype(np.int8).reshape(-1)
            out += [codes, (s / F32(t.mult))[:, 0].astype(F32)]
        if rule == "both_halves":
            return tuple(out)
        mids, outs, cap = padded(tabs)
        if len(tabs) == 1:
            out[0] = outs[snap(x2 / scales[0], mids, cap)].astype(
                np.int8).reshape(-1)
            return tuple(out)
        sn, sp = scales
        cn0 = outs[snap(F32(0.0) / sn, mids, cap)]
        cp0 = outs[cap + snap(F32(0.0) / sp, mids, cap, cap)]
        pos, w, s, base = _own_half(x2, sn, sp, cap)
        c = outs[base + snap(w / s, mids, cap, base)]
        out[0] = np.where(pos, cn0, c).astype(np.int8).reshape(-1)
        out[2] = np.where(pos, c, cp0).astype(np.int8).reshape(-1)
    return tuple(out)


def _own_half(x2, sn, sp, cap: int) -> tuple:
    """Each value's own half of a dual grid as the kernels pick it: ``x >
    0`` the positive half (its table at ``cap``), else the negative half
    with ``x`` (``x <= 0``) or +0 (NaN) -> (positive?, value, scale,
    table base)."""
    pos = x2 > 0
    w = np.where(pos | (x2 <= 0), x2, F32(0.0))
    return pos, w, np.where(pos, sp, sn), np.where(pos, cap, 0)


def model_q3(x, gs: int, n_bits: int, asym: bool, eps: float,
             bf16: bool) -> np.ndarray:
    """Q3 on ``x``: every step rounded to x's dtype as PyTorch rounds
    it."""
    q_min, q_max = Q._int_range(n_bits)
    x2 = np.asarray(x, F32).reshape(-1, gs)
    with np.errstate(all="ignore"):
        if asym:
            lo = x2.min(axis=1, keepdims=True)
            rng = rx(x2.max(axis=1, keepdims=True) - lo, bf16)
            inv = F32(Q.inv(q_max - q_min))
        else:
            rng = np.abs(x2).max(axis=1, keepdims=True)
            inv = F32(Q.inv(q_max))
        c = rx(np.where(np.isnan(rng), rng, np.maximum(rng, F32(eps))), bf16)
        s = rx(c * inv, bf16)
        q = np.rint(rx(x2 / s, bf16))
        if asym:
            zp = np.rint(rx(F32(q_min) - rx(lo / s, bf16), bf16))
            q = _clamp(rx(q + zp, bf16), q_min, q_max)
            return rx(rx(q - zp, bf16) * s, bf16).reshape(-1)
        return rx(_clamp(q, q_min, q_max) * s, bf16).reshape(-1)


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def _neighbours(v, bf16: bool) -> np.ndarray:
    """``v`` and each value's two float neighbours in x's dtype."""
    v = rx(v, bf16)
    if bf16:
        u = (v.view(np.uint32) >> 16).astype(np.int64)
        up = ((u + 1) & 0xFFFF).astype(np.uint32) << 16
        dn = ((u - 1) & 0xFFFF).astype(np.uint32) << 16
        return np.concatenate([v, up.view(F32), dn.view(F32)])
    return np.concatenate([v, np.nextafter(v, F32(np.inf)),
                           np.nextafter(v, F32(-np.inf))]).astype(F32)


def _groups(vals, lead, gs: int) -> np.ndarray:
    """``vals`` in groups of ``gs`` whose first values are ``lead`` (each
    group's absmax-setters)."""
    n = gs - len(lead)
    vals = np.resize(vals, -(-len(vals) // n) * n).reshape(-1, n)
    lead = np.broadcast_to(np.asarray(lead, F32), (len(vals), len(lead)))
    return np.concatenate([lead, vals], axis=1).reshape(-1)


def adversarial(grid, bf16: bool, seed: int, gs: int = 128,
                lead=None) -> np.ndarray:
    """10^5 normals scaled to the grid's range, then groups whose absmax
    is the grid's (scale ~1: every midpoint, grid value and +-0 lands on
    itself, with each one's neighbours), groups with +-inf, NaN and
    +-1e30, groups of a denormal scale, and groups where the absmax of
    one half (of both: the whole group's) is x's smallest subnormal, so
    that its scale rounds to 0 where the product with ``1 / max|grid|``
    can (a float32 product below half that subnormal; the bfloat16 one
    where the scale is rounded to x's dtype) and ``+0 / scale`` is
    NaN."""
    g = np.asarray(grid, F32)
    gmax = F32(np.abs(g).max())
    lead = [gmax, -gmax] if lead is None else lead
    rng = np.random.default_rng(seed)
    normals = rx(rng.standard_normal(100_096).astype(F32) * gmax / 3, bf16)
    mids = (g[1:] + g[:-1]) * F32(0.5)
    exact = _neighbours(np.concatenate([mids, g, [0.0, -0.0]]), bf16)
    wild = _neighbours(np.array([np.inf, -np.inf, np.nan, 1e30, -1e30,
                                 0.0, 1.0], F32), bf16)
    tiny = rx(normals[:4096] * F32(1e-39), bf16)
    sub = F32(2.0 ** -133 if bf16 else 2.0 ** -149)
    mag = np.abs(normals[:1024])
    zeros = np.array([0.0, -0.0, np.nan], F32)
    parts = [normals, _groups(exact, lead, gs),
             _groups(np.concatenate([wild, exact]), [], gs),
             _groups(wild[::-1], [], gs), _groups(tiny, [], gs),
             _groups(np.array([sub, -sub, 0.0, -0.0], F32), [], gs),
             _groups(np.concatenate([-mag, zeros, [sub]]), [sub], gs),
             _groups(np.concatenate([mag, zeros, [-sub]]), [-sub], gs)]
    out = np.concatenate(parts).astype(F32)
    return np.resize(out, -(-len(out) // 1024) * 1024)     # whole rows


def _torch(x, bf16: bool) -> torch.Tensor:
    return torch.from_numpy(x).to(torch.bfloat16 if bf16 else torch.float32)


def assert_bits_equal(model, plain, what: str):
    """Bit-equal as int views, NaN against NaN (the CPU's NaN payload is
    not the card's)."""
    model = np.asarray(model)
    plain = np.asarray(plain)
    assert model.shape == plain.shape, what
    if model.dtype.kind == "f":
        nan = np.isnan(plain)
        assert np.array_equal(np.isnan(model), nan), what
        model, plain = model[~nan], plain[~nan]
        bad = model.view(np.uint32) != plain.view(np.uint32)
    else:
        bad = model != plain
    assert not bad.any(), (f"{what}: {int(bad.sum())} differ, first "
                           f"model {model[bad][:4]} plain {plain[bad][:4]}")


def _f32(t: torch.Tensor) -> np.ndarray:
    return t.to(torch.float32).numpy().reshape(-1)


# ---------------------------------------------------------------------------
# (a) the host tables
# ---------------------------------------------------------------------------

def _grid(fmt, half):
    return (G.GRIDS[fmt] if half is None
            else G.DUAL_GRIDS[fmt][("neg", "pos").index(half)])


@pytest.mark.parametrize("label,fmt,half", ALL_GRIDS)
def test_value_table_is_the_plain_grid(label, fmt, half):
    g = np.asarray(_grid(fmt, half), F32)
    t = QK.value_table(fmt, half)
    mids = (g[1:] + g[:-1]) * F32(0.5)
    assert t.mids.dtype == F32 and np.array_equal(t.mids.view(np.uint32),
                                                  mids.view(np.uint32))
    assert np.all(np.diff(t.mids) > 0)
    assert t.out.dtype == F32 and np.array_equal(t.out.view(np.uint32),
                                                 g.view(np.uint32))
    assert t.inv == Q.inv_max(g) and t.mult == 1.0
    assert t.cap == min(c for c in (8, 16, 64, 256) if len(g) <= c)
    # the plain compare-sum and the table lookup agree on every position
    snapped = _f32(Q.snap_to_grid(torch.from_numpy(
        np.concatenate([g, mids, [np.nan]]).astype(F32)), g))
    looked_up = t.out[lift(np.concatenate([g, mids, [np.nan]]).astype(F32),
                           t)]
    assert_bits_equal(looked_up, snapped, label)


@pytest.mark.parametrize("fmt,half", [(f, None) for f in P.CODE_MULT]
                         + [(f, h) for f in P.DUAL_CODE_MULT
                            for h in ("neg", "pos")])
def test_code_table_is_round_grid_times_mult(fmt, half):
    g = np.asarray(_grid(fmt, half), F32)
    mult = (P.CODE_MULT[fmt] if half is None
            else P.DUAL_CODE_MULT[fmt][("neg", "pos").index(half)])
    t = QK.code_table(fmt, half)
    plain = torch.round(torch.from_numpy(g) * float(mult)).to(torch.int8)
    assert np.array_equal(t.out, plain.numpy().astype(np.int32))
    assert t.mult == float(mult) and t.inv == Q.inv_max(g)
    assert np.array_equal(t.mids, QK.value_table(fmt, half).mids)
    assert t.out.min() >= -128 and t.out.max() <= 127


@pytest.mark.parametrize("fmt", sorted(G.GRIDS))
def test_index_table_is_the_int8_index(fmt):
    t = QK.index_table(fmt)
    n = len(G.GRIDS[fmt])
    want = torch.arange(n, dtype=torch.int32).to(torch.int8).numpy()
    assert np.array_equal(t.out, want.astype(np.int32))
    assert t.mult == 1.0 and t.n_mids == n - 1
    assert t.cap == (256 if fmt == "fp8_e4m3" else 64 if n > 16 else 16)


# ---------------------------------------------------------------------------
# (b) the model against the plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16,rule", RULES, ids=RULE_IDS)
@pytest.mark.parametrize("fmt", sorted(G.GRIDS))
def test_model_q1_equals_fake_quant_fp(fmt, bf16, rule):
    x = adversarial(G.GRIDS[fmt], bf16, seed=1)
    for clip in ((None, 3.0) if fmt.startswith("fp_e") else (None,)):
        plain = Q.fake_quant_fp_ref(_torch(x, bf16), fmt,
                                    granularity="per_group", group_size=128,
                                    clip_abs=clip)
        model = model_q1(x, 128, (QK.value_table(fmt),), bf16, clip,
                         rule)
        assert_bits_equal(model, _f32(plain), f"{fmt} clip {clip}")
    # per token: one group spanning a row of 1024
    plain = Q.fake_quant_fp_ref(_torch(x[:8192], bf16).reshape(8, 1024),
                                fmt, granularity="per_token")
    assert_bits_equal(model_q1(x[:8192], 1024, (QK.value_table(fmt),),
                               bf16, rule=rule), _f32(plain),
                      f"{fmt} per token")


@pytest.mark.parametrize("bf16,rule", RULES, ids=RULE_IDS)
@pytest.mark.parametrize("fmt", sorted(G.DUAL_GRIDS))
def test_model_q1_equals_fake_quant_dual(fmt, bf16, rule):
    neg, pos = G.DUAL_GRIDS[fmt]
    lead = [F32(-np.abs(neg).max()), F32(np.abs(pos).max())]
    tabs = (QK.value_table(fmt, "neg"), QK.value_table(fmt, "pos"))
    for grid, seed in ((neg, 2), (pos, 3)):
        x = adversarial(grid, bf16, seed, lead=lead)
        plain = Q.fake_quant_dual_ref(_torch(x, bf16), fmt,
                                      granularity="per_group",
                                      group_size=128)
        assert_bits_equal(model_q1(x, 128, tabs, bf16, rule=rule),
                          _f32(plain), fmt)


@pytest.mark.parametrize("bf16,rule", RULES, ids=RULE_IDS)
@pytest.mark.parametrize("fmt", sorted(P.CODE_MULT))
def test_model_q2_equals_quant_int_codes(fmt, bf16, rule):
    x = adversarial(G.GRIDS[fmt], bf16, seed=4)
    codes, scales = P.quant_int_codes_ref(_torch(x, bf16), fmt, 128)
    mc, ms = model_q2(x, 128, (QK.code_table(fmt),), bf16, False, rule)
    assert_bits_equal(mc, codes.numpy().reshape(-1), f"{fmt} codes")
    assert_bits_equal(ms, scales.numpy().reshape(-1), f"{fmt} scales")


@pytest.mark.parametrize("bf16,rule", RULES, ids=RULE_IDS)
@pytest.mark.parametrize("fmt", sorted(P.DUAL_CODE_MULT))
def test_model_q2_equals_quant_int_codes_dual(fmt, bf16, rule):
    neg, pos = G.DUAL_GRIDS[fmt]
    lead = [F32(-np.abs(neg).max()), F32(np.abs(pos).max())]
    tabs = (QK.code_table(fmt, "neg"), QK.code_table(fmt, "pos"))
    for grid, seed in ((neg, 5), (pos, 6)):
        x = adversarial(grid, bf16, seed, lead=lead)
        plain = P.quant_int_codes_dual_ref(_torch(x, bf16), fmt, 128)
        for m, p, what in zip(model_q2(x, 128, tabs, bf16, False, rule),
                              plain,
                              ("cn", "sn", "cp", "sp")):
            assert_bits_equal(m, p.numpy().reshape(-1), f"{fmt} {what}")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_model_zero_scale_half_takes_the_real_division(bf16):
    """A dual-grid half whose absmax is x's smallest subnormal
    (``adversarial``'s last groups): its scale rounds to 0 exactly where
    the product ``sub * f32(1 / max|grid|)`` does in the scale's dtype
    (Q2's float32, Q1's x dtype), +0 / 0 is NaN, and the half's +0 there
    takes position 0.  The kernels' rule, that code and product found
    once a group by the real division, equals the plain versions; and for
    float32 x some half's position-0 code is not its code of +0, so a
    kernel that assumed position(+0) would differ."""
    sub = F32(2.0 ** -133 if bf16 else 2.0 ** -149)
    distinct = []
    for fmt in sorted(P.DUAL_CODE_MULT):
        neg, _ = G.DUAL_GRIDS[fmt]
        x = adversarial(neg, bf16, seed=12)
        xt = _torch(x, bf16)
        tabs = (QK.code_table(fmt, "neg"), QK.code_table(fmt, "pos"))
        plain = [t.numpy().reshape(-1) for t in
                 P.quant_int_codes_dual_ref(xt, fmt, 128)]
        for m, p, what in zip(model_q2(x, 128, tabs, bf16, False), plain,
                              ("cn", "sn", "cp", "sp")):
            assert_bits_equal(m, p, f"{fmt} {what}")
        other = (x > 0, ~(x > 0))       # values held by the other half
        halves = _halves(x.reshape(-1, 128))
        for h, t in enumerate(tabs):
            with np.errstate(all="ignore"):
                zero = _scale(np.abs(halves[h]).max(axis=1), t.inv,
                              False) == 0
            assert zero.any() == (sub * F32(t.inv) == 0), (fmt, h)
            held = other[h].reshape(-1, 128) & zero[:, None]
            codes = plain[2 * h].reshape(-1, 128)[held]
            assert np.all(codes == t.out[0]), (fmt, h)
            if held.any():
                distinct.append(t.out[0] != t.out[lift(np.zeros(1, F32),
                                                        t)][0])
        vt = (QK.value_table(fmt, "neg"), QK.value_table(fmt, "pos"))
        for h, t in enumerate(vt):
            with np.errstate(all="ignore"):
                zero = _scale(np.abs(halves[h]).max(axis=1), t.inv,
                              bf16) == 0
            assert zero.any() == (rx(sub * F32(t.inv), bf16) == 0)
        y = Q.fake_quant_dual_ref(xt, fmt, granularity="per_group",
                                  group_size=128)
        assert_bits_equal(model_q1(x, 128, vt, bf16), _f32(y), fmt)
    assert bf16 or any(distinct)


@pytest.mark.parametrize("bf16,rule", RULES, ids=RULE_IDS)
@pytest.mark.parametrize("fmt", sorted(G.GRIDS))
def test_model_q2_equals_pack_and_kv_index_codes(fmt, bf16, rule):
    x = adversarial(G.GRIDS[fmt], bf16, seed=7)
    t = QK.index_table(fmt)
    codes, scales = P.pack_codes_ref(_torch(x, bf16).reshape(-1, 256), fmt,
                                     128)
    mc, ms = model_q2(x, 128, (t,), bf16, True, rule)
    assert_bits_equal(mc, codes.to(torch.int8).numpy().reshape(-1),
                      f"pack {fmt}")
    assert_bits_equal(ms, scales.numpy().reshape(-1), f"pack {fmt}")
    xr = _torch(x[:64 * 1024], bf16).reshape(-1, 64)     # KV rows of 64
    codes, scales = P.grid_index_codes_ref(xr, fmt)
    mc, ms = model_q2(x[:64 * 1024], 64, (t,), bf16, False, rule)
    assert_bits_equal(mc, codes.numpy().reshape(-1), f"kv {fmt}")
    assert_bits_equal(ms, scales.numpy().reshape(-1), f"kv {fmt}")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
@pytest.mark.parametrize("n_bits", [4, 6, 8])
def test_model_q3_equals_fake_quant_int(n_bits, asym, bf16):
    q_max = F32(2 ** (n_bits - 1) - 1)
    grid = np.arange(-q_max - 1, q_max + 1, dtype=F32)
    x = adversarial(grid, bf16, seed=8 + n_bits)
    fn = Q.fake_quant_int_asym_ref if asym else Q.fake_quant_int_sym_ref
    for gs, gran in ((128, "per_group"), (1024, "per_token")):
        xs = x[:len(x) // gs * gs]
        xt = _torch(xs, bf16).reshape(-1, gs if gran == "per_token" else 256)
        plain = fn(xt, n_bits, granularity=gran, group_size=128)
        assert_bits_equal(model_q3(xs, gs, n_bits, asym, 1e-5, bf16),
                          _f32(plain), f"{gran}")


# ---------------------------------------------------------------------------
# (c) routes and counters
# ---------------------------------------------------------------------------

def _counts():
    return (QK.grid_launches, QK.codes_launches, QK.int_launches)


def test_cpu_takes_the_plain_versions_and_counts_nothing():
    before = _counts()
    x = torch.from_numpy(adversarial(G.FP4_E2M1, False, 9)[:4096]).reshape(
        16, 256)
    pairs = [
        (Q.fake_quant_fp(x, "fp_e2"), Q.fake_quant_fp_ref(x, "fp_e2")),
        (Q.fake_quant_dual(x, "fp4_afpq", granularity="per_token"),
         Q.fake_quant_dual_ref(x, "fp4_afpq", granularity="per_token")),
        (Q.fake_quant_int_sym(x, 4), Q.fake_quant_int_sym_ref(x, 4)),
        (Q.fake_quant_int_asym(x, 4), Q.fake_quant_int_asym_ref(x, 4)),
        (P.quant_int_codes(x, "fp_e2"), P.quant_int_codes_ref(x, "fp_e2")),
        (P.quant_int_codes_dual(x, "fp4_afpq"),
         P.quant_int_codes_dual_ref(x, "fp4_afpq")),
        (QK.pack_codes(x, "fp_e3"), P.pack_codes_ref(x, "fp_e3")),
        (QK.grid_index_codes(x, "fp_e1"), P.grid_index_codes_ref(x, "fp_e1")),
    ]
    for got, want in pairs:
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert _counts() == before


#: chip_smoke.py's main-path recipes and paper_recipes(): the route of the
#: activation quantizer of each layer kind (fc2 apart where it differs)
#: and of the KV cache, on a card
ROUTES = {
    "int8": {"act": "Q2", "fc2": "Q2"},
    "bf16": {},
    "packed": {"act": "Q1", "fc2": "Q1"},
    "w4a16p": {},
    "int8ch": {"act": "K4 (a)", "fc2": "Q2"},
    "int8chs": {"act": "K4 (a)", "fc2": "K4 (a)"},
    "int8chsnr": {"act": "K4 (a)", "fc2": "K4 (a)"},
    "w4a16": {"act": "none", "fc2": "none"},
    "int8kv": {"act": "K4 (a)", "fc2": "Q2", "kv": "Q2"},
    "int8att": {"act": "K4 (a)", "fc2": "Q2", "kv": "Q2"},
    "fp4": {"act": "Q1", "fc2": "Q1"},
    "fp4_kv6": {"act": "Q1", "fc2": "Q1", "kv": "Q1"},
    "fp6": {"act": "Q1", "fc2": "Q1"},
    "fp6_kv6": {"act": "Q1", "fc2": "Q1", "kv": "Q1"},
    "int4_rtn": {"act": "Q3", "fc2": "Q3"},
    "fp4_pertensor": {"act": "plain: per_tensor", "fc2": "plain: per_tensor"},
}


def int8_route(act_fmt: str, per_channel: bool) -> str:
    """The kernel that quantizes an ``int8`` linear's activation on a
    card (``ops/int8_matmul.py`` ``int8_linear``, ``int8_linear_dual``):
    none for ``bf16`` (weights only), Q2 for a dual grid (fc2) and per
    group, K4's phase (a) per channel (``fused_ch_gemm``)."""
    if act_fmt == "bf16":
        return "none"
    if act_fmt in P.DUAL_CODE_MULT or not per_channel:
        return "Q2"
    return "K4 (a)"


def _routes(q) -> dict:
    """The card routes of the runtime that ``q`` builds: of qkv, proj and
    fc1 (one route for the three), of fc2 and of the KV cache."""
    rt = build_runtime(q, 2, 256, "cpu")
    kinds = {}
    for kind in ("mat_qkv", "proj", "fc1", "fc2"):
        if q.enabled and q.backend == "int8":
            kinds[kind] = int8_route(rt.act_fmts[kind],
                                        q.act_quant == "per_token")
        elif rt.act_q.get(kind) is not None:
            kinds[kind] = QK.card_route(rt.act_q[kind])
    got = {}
    if kinds:
        assert kinds["mat_qkv"] == kinds["proj"] == kinds["fc1"]
        got = {"act": kinds["mat_qkv"], "fc2": kinds["fc2"]}
    for kv in (rt.kv_q, rt.kv_codec):
        if kv is not None:
            got["kv"] = QK.card_route(kv)
    return got


@pytest.mark.parametrize("mode", sorted(ROUTES))
def test_every_runtime_quantizer_names_its_card_route(mode):
    q = {**bench_recipes(), **paper_recipes()}[mode]
    got = _routes(q)
    assert got == ROUTES[mode]
    for route in got.values():
        assert (route in ("Q1", "Q2", "Q3", "K4 (a)", "none")
                or route.removeprefix("plain: ") in QK.PLAIN_ROUTES)


def test_plain_routes_are_named():
    assert QK.card_route(partial(Q.fake_quant_dual, fmt="fp4_afpq",
                                 clipping_strength=0.9)) == (
        "plain: clipping_strength")
    assert QK.card_route(Q.make_act_quantizer(
        "fp_neg_reverse_quant", 4)) == "plain: neg_reverse"
    assert QK.card_route(Q.make_act_quantizer("log2", 4)) == "plain: log2"
    assert QK.card_route(Q.make_act_quantizer(
        "fp_e2", 4, granularity="per_token")) == "Q1"
    assert QK.card_route(Q.make_act_quantizer("int_asym", 4)) == "Q3"
    q = bench_recipes()["int8"].replace(kv_bit=4, kv_format="fp_e1")
    assert QK.card_route(build_runtime(q, 2, 256, "cpu").kv_q) == "Q1"
    q = q.replace(kv_format="int_sym")
    assert QK.card_route(build_runtime(q, 2, 256, "cpu").kv_q) == "Q3"


class _Emulated:
    """The kernel route taken on the CPU: ``_on_card`` answers yes, and
    each launch runs the numpy model (and counts as the launch does)."""

    def __init__(self, monkeypatch):
        monkeypatch.setattr(QK, "_on_card", lambda x: True)
        monkeypatch.setattr(QK, "_run_q1", self.q1)
        monkeypatch.setattr(QK, "_run_q2", self.q2)
        monkeypatch.setattr(QK, "_run_q3", self.q3)

    @staticmethod
    def _np(x):
        return x.to(torch.float32).numpy().reshape(-1)

    def q1(self, x, n, gs, fmt, dual, clip):
        tabs = ((QK.value_table(fmt, "neg"), QK.value_table(fmt, "pos"))
                if dual else (QK.value_table(fmt),))
        y = model_q1(self._np(x), gs, tabs, x.dtype == torch.bfloat16, clip)
        QK.grid_launches += 1
        return torch.from_numpy(y).to(x.dtype).reshape(x.shape)

    def q2(self, x, n, gs, tables, round_scale):
        out = model_q2(self._np(x), gs, tables, x.dtype == torch.bfloat16,
                       round_scale)
        QK.codes_launches += 1
        return tuple(torch.from_numpy(a).reshape(x.shape) if i % 2 == 0
                     else torch.from_numpy(a) for i, a in enumerate(out))

    def q3(self, x, n, gs, n_bits, asym, eps):
        y = model_q3(self._np(x), gs, n_bits, asym, eps,
                     x.dtype == torch.bfloat16)
        QK.int_launches += 1
        return torch.from_numpy(y).to(x.dtype).reshape(x.shape)


#: per block forward on a card: launches of (Q1, Q2, Q3), as
#: ``chip_smoke.py``'s gates count them (160 block forwards a d16
#: generation)
PER_BLOCK = {"int8": (0, 4, 0), "packed": (4, 0, 0), "int8ch": (0, 1, 0),
             "int8kv": (0, 3, 0), "fp4_kv6": (6, 0, 0), "fp6_kv6": (6, 0, 0),
             "int4_rtn": (0, 0, 4), "bf16": (0, 0, 0)}


@pytest.fixture(scope="module")
def tiny():
    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    params = init_var_params(cfg, seed=4, device="cpu",
                             adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=5, device="cpu")
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, 256)))
                 .astype(F32) for _ in range(2))
    return cfg, params, vae, galt


@pytest.mark.parametrize("mode", sorted(PER_BLOCK))
def test_emulated_kernel_route_generates_the_plain_images(mode, tiny,
                                                          monkeypatch):
    """The wrappers' kernel route (shapes, groups, tables, outputs), the
    launches replaced by the numpy model: the same images as the plain
    route, and as many launches per block forward as the card's gates
    count."""
    cfg, params, vae, galt = tiny
    q = {**bench_recipes(), **paper_recipes()}[mode]
    gen_cfg = GenerateConfig(top_k=1, top_p=0.0)

    def generate():
        qp = quantize_var_params(params, cfg, q, galt=galt)
        g = VARGenerator(cfg, q, gen_cfg, compute_dtype=torch.bfloat16,
                         device="cpu", fuse_steps=False)
        return g.generate(qp, vae, [3, 5])

    plain = generate()
    _Emulated(monkeypatch)
    qp = quantize_var_params(params, cfg, q, galt=galt)
    g = VARGenerator(cfg, q, gen_cfg, compute_dtype=torch.bfloat16,
                     device="cpu", fuse_steps=False)
    before = _counts()
    imgs = g.generate(qp, vae, [3, 5])
    blocks = cfg.depth * cfg.num_scales
    assert tuple(a - b for a, b in zip(_counts(), before)) == tuple(
        n * blocks for n in PER_BLOCK[mode])
    assert torch.equal(imgs, plain)


# ---------------------------------------------------------------------------
# (d) autograd
# ---------------------------------------------------------------------------

def test_recording_autograd_graph_raises_on_the_kernel_route(monkeypatch):
    _Emulated(monkeypatch)
    x = torch.randn(4, 256, requires_grad=True)
    for fn in (partial(Q.fake_quant_fp, fmt="fp_e2"),
               partial(Q.fake_quant_dual, fmt="fp4_afpq"),
               partial(Q.fake_quant_int_sym, n_bits=4),
               partial(Q.fake_quant_int_asym, n_bits=4),
               partial(P.quant_int_codes, fmt="fp_e2"),
               partial(P.quant_int_codes_dual, fmt="fp4_afpq")):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(x)
        with torch.no_grad():
            fn(x)


@pytest.mark.parametrize("make", [fp_quant_ste, int_sym_ste])
def test_ste_runs_the_kernel_route_and_passes_gradients(make, monkeypatch):
    _Emulated(monkeypatch)
    x = torch.randn(4, 256, requires_grad=True)
    before = _counts()
    y = make()(x)
    y.sum().backward()
    assert sum(_counts()) == sum(before) + 1
    assert torch.equal(x.grad, torch.ones_like(x))
