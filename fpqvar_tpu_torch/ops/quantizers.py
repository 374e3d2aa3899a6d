"""Fake quantization: quantize, then dequantize, in the input's own dtype.

The counterpart of the JAX package's ``ops/quantizers.py``: the
nearest-grid snap, the single-grid fp quantizer, the dual-grid (fc2)
quantizer, neg-reverse, linear INT (symmetric and asymmetric), log2 and
the KV-cache quantizer, per group, per token, per channel or per tensor.
The ops run in the dtypes that JAX's functions take under ``jit``, so the
results are bit-equal to them at float32 and bfloat16 (log2 aside, see
:func:`fake_quant_log2`): ``absmax``, the scale and ``q * scale`` are
rounded to ``x.dtype``; XLA turns a division by a constant (``absmax /
gmax``, ``/ q_max``, ``/ (q_max - q_min)``) into a multiply by its float32
reciprocal (:func:`inv_max`, :func:`inv`); and it fuses the true division
``x / scale`` into the float32 snap without rounding the quotient to
``x.dtype`` (:func:`_snap_div`).

``fake_quant_fp``, ``fake_quant_dual``, ``fake_quant_int_sym`` and
``fake_quant_int_asym`` dispatch by device through
``ops/quant_kernels.py``: on a card the hand-written kernels Q1 and Q3
compute them bit for bit in one launch; on the CPU the ``*_ref``
functions here, their plain versions, run.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from fpqvar_tpu_torch.ops import grids as G


def _kernels():
    """``ops/quant_kernels.py``, the public quantizers' device dispatch
    (imported at the call: it imports this module)."""
    from fpqvar_tpu_torch.ops import quant_kernels

    return quant_kernels


def inv_max(grid) -> float:
    """``1 / max|grid|`` rounded to float32.  JAX runs its quantizers under
    ``jit``, where XLA turns ``absmax / gmax`` (a division by a constant)
    into ``absmax * f32(1 / gmax)``; the two differ in the last bit of many
    scales, so the port multiplies as the jitted JAX code does."""
    return inv(np.max(np.abs(grid)))


def inv(n: float) -> float:
    """``1 / n`` rounded to float32: XLA's multiply for a division by the
    constant ``n`` under ``jit``."""
    return float(np.float32(1.0) / np.float32(n))


def snap_to_grid(x: torch.Tensor, grid) -> torch.Tensor:
    """Map every element of ``x`` to the nearest value of a sorted grid.

    Gather-free compare-sum, in the JAX package's order:
    ``snapped = grid[0] + sum_i deltas[i] * [x >= mids[i]]`` accumulated in
    float32, so the result is bit-equal.  ``x == mid`` counts as ``>=``:
    an exact midpoint snaps to the larger value.
    """
    g = np.asarray(grid, dtype=np.float32)
    mids = (g[1:] + g[:-1]) * np.float32(0.5)
    deltas = g[1:] - g[:-1]
    xf = x.to(torch.float32)
    out = torch.full(x.shape, float(g[0]), dtype=torch.float32,
                     device=x.device)
    for m, d in zip(mids.tolist(), deltas.tolist()):
        # [x >= m] * d is exactly d or +0, as JAX's where(x >= m, d, 0)
        out = out + (xf >= m).to(torch.float32) * d
    return out.to(x.dtype)


def group_reshape(x: torch.Tensor, group_size: int) -> torch.Tensor:
    shape = tuple(x.shape)
    if shape[-1] % group_size:
        raise ValueError(
            f"last dim {shape[-1]} not divisible by group_size {group_size}")
    return x.reshape(shape[:-1] + (shape[-1] // group_size, group_size))


def safe_scale(absmax: torch.Tensor, inv: float) -> torch.Tensor:
    """``absmax * inv`` where ``absmax > 0``, else 1 (an all-zero group
    quantizes to exact zeros)."""
    return torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))


def _snap_div(xg: torch.Tensor, scale: torch.Tensor, grid) -> torch.Tensor:
    """``snap(xg / scale)`` in ``xg.dtype``.  The quotient is a float32
    true division that is not rounded to ``xg.dtype`` first: in JAX's jitted
    quantizers XLA fuses the bfloat16 division into the float32 snap."""
    q = snap_to_grid(xg.to(torch.float32) / scale.to(torch.float32), grid)
    return q.to(xg.dtype)


def _group(x: torch.Tensor, granularity: str, group_size: int):
    """``x`` grouped for ``granularity``: as it is (per token, channel or
    tensor) or ``[..., K/group_size, group_size]`` (per group)."""
    if granularity in ("per_token", "per_channel", "per_tensor"):
        return x
    if granularity == "per_group":
        return group_reshape(x, group_size)
    raise ValueError(f"unknown granularity {granularity!r}")


def _amax(t: torch.Tensor, granularity: str) -> torch.Tensor:
    """max over the whole tensor (a 0-d tensor) per tensor, else over the
    last axis (keepdim)."""
    if granularity == "per_tensor":
        return t.amax()
    return t.amax(dim=-1, keepdim=True)


def _amin(t: torch.Tensor, granularity: str) -> torch.Tensor:
    if granularity == "per_tensor":
        return t.amin()
    return t.amin(dim=-1, keepdim=True)


def _axis_absmax(x: torch.Tensor, granularity: str, group_size: int):
    """(x grouped, its absmax per group, token, channel or tensor)."""
    xg = _group(x, granularity, group_size)
    return xg, _amax(xg.abs(), granularity)


def fake_quant_fp(x: torch.Tensor, fmt: str, *, granularity: str = "per_group",
                  group_size: int = 128,
                  clip_abs: Optional[float] = None) -> torch.Tensor:
    """:func:`fake_quant_fp_ref`'s function: kernel Q1 on a card
    (``ops/quant_kernels.py``), the plain version on the CPU."""
    return _kernels().fake_quant_fp(x, fmt, granularity=granularity,
                                    group_size=group_size, clip_abs=clip_abs)


def fake_quant_fp_ref(x: torch.Tensor, fmt: str, *,
                      granularity: str = "per_group", group_size: int = 128,
                      clip_abs: Optional[float] = None) -> torch.Tensor:
    """absmax-scaled nearest-grid fake quantization:
    ``scale = absmax / max|grid|``, snap ``x / scale``, multiply back.
    ``clip_abs`` clamps ``x`` to ``[-clip_abs, clip_abs]`` first."""
    grid = G.GRIDS[fmt]
    if clip_abs is not None:
        x = x.clamp(-clip_abs, clip_abs)
    xg, absmax = _axis_absmax(x, granularity, group_size)
    scale = safe_scale(absmax, inv_max(grid))
    return (_snap_div(xg, scale, grid) * scale).reshape(x.shape)


def fake_quant_dual(x: torch.Tensor, fmt: str, *,
                    granularity: str = "per_group",
                    group_size: int = 128,
                    clipping_strength: Optional[float] = None) -> torch.Tensor:
    """:func:`fake_quant_dual_ref`'s function: kernel Q1 on a card (the
    plain version with ``clipping_strength`` or ``per_tensor``), the
    plain version on the CPU."""
    return _kernels().fake_quant_dual(x, fmt, granularity=granularity,
                                      group_size=group_size,
                                      clipping_strength=clipping_strength)


def fake_quant_dual_ref(x: torch.Tensor, fmt: str, *,
                        granularity: str = "per_group",
                        group_size: int = 128,
                        clipping_strength: Optional[float] = None
                        ) -> torch.Tensor:
    """Sign-split dual-grid quantization (the fc2 formats): ``x <= 0`` on
    the negative grid and ``x > 0`` on the positive one, each half with its
    own absmax scale; each half snaps the other half's zeros to 0, so
    ``q_neg * scale_neg + q_pos * scale_pos`` is exact.
    ``clipping_strength`` first clamps ``x`` at that fraction of the whole
    tensor's absmax."""
    neg_grid, pos_grid = G.DUAL_GRIDS[fmt]
    if clipping_strength is not None:
        cv = clipping_strength * x.abs().amax()
        x = torch.clamp(x, -cv, cv)
    xg = _group(x, granularity, group_size)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_neg = torch.where(xg <= 0, xg, zero)
    x_pos = torch.where(xg > 0, xg, zero)
    scale_n = safe_scale(_amax(x_neg.abs(), granularity), inv_max(neg_grid))
    scale_p = safe_scale(_amax(x_pos.abs(), granularity), inv_max(pos_grid))
    q_neg = _snap_div(x_neg, scale_n, neg_grid)
    q_pos = _snap_div(x_pos, scale_p, pos_grid)
    return (q_neg * scale_n + q_pos * scale_p).reshape(x.shape)


def fake_quant_neg_reverse(x: torch.Tensor, *,
                           group_size: int = 128) -> torch.Tensor:
    """Neg-reverse on the e2m1 grid, per group: the non-positive half is
    shifted up by ``|min(group)|`` and quantized with its own scale, then
    shifted back; the positive half has its own scale.  (The shifted half
    holds ``|min|`` where ``x`` is positive, as in the JAX package and its
    reference.)

    At float32, XLA on the CPU contracts JAX's jitted
    ``(q_nr * s_nr - |min|) + q_p * s_p`` into two fused multiply-adds;
    the port computes them in float64 and rounds once (:func:`_fma`).  At
    bfloat16 each product is rounded to bfloat16 first, so the ops run as
    written."""
    grid = G.FP4_E2M1
    im = inv_max(grid)
    xg = group_reshape(x, group_size)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_min_abs = xg.amin(dim=-1, keepdim=True).abs()
    x_neg_rev = torch.where(xg <= 0, xg, zero) + x_min_abs
    x_pos = torch.where(xg > 0, xg, zero)
    scale_nr = safe_scale(x_neg_rev.abs().amax(dim=-1, keepdim=True), im)
    scale_p = safe_scale(x_pos.abs().amax(dim=-1, keepdim=True), im)
    q_nr = _snap_div(x_neg_rev, scale_nr, grid)
    q_p = _snap_div(x_pos, scale_p, grid)
    if x.dtype == torch.float32:
        out = _fma(q_p, scale_p, _fma(q_nr, scale_nr, -x_min_abs))
    else:
        out = (q_nr * scale_nr - x_min_abs) + q_p * scale_p
    return out.reshape(x.shape)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors as one fused multiply-add: the
    product of two float32 values is exact in float64, and the float64 sum
    rounds far below float32's last bit, so the cast to float32 gives the
    fused result (but for a float64 rounding onto a float32 tie)."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def _int_range(n_bits: int):
    return -(2 ** (n_bits - 1)), 2 ** (n_bits - 1) - 1


def fake_quant_int_sym(x: torch.Tensor, n_bits: int, *,
                       granularity: str = "per_token", group_size: int = 128,
                       scale_eps: float = 1e-5) -> torch.Tensor:
    """:func:`fake_quant_int_sym_ref`'s function: kernel Q3 on a card, the
    plain version on the CPU."""
    return _kernels().fake_quant_int_sym(x, n_bits, granularity=granularity,
                                         group_size=group_size,
                                         scale_eps=scale_eps)


def fake_quant_int_sym_ref(x: torch.Tensor, n_bits: int, *,
                           granularity: str = "per_token",
                           group_size: int = 128,
                           scale_eps: float = 1e-5) -> torch.Tensor:
    """Symmetric linear quantization: ``scale = max(absmax, eps) / q_max``
    (a multiply by ``f32(1 / q_max)``), ``round(x / scale)`` (half to
    even) clamped to ``[q_min, q_max]``, times the scale."""
    q_min, q_max = _int_range(n_bits)
    xg, absmax = _axis_absmax(x, granularity, group_size)
    scale = absmax.clamp_min(scale_eps) * inv(q_max)
    q = torch.round(xg / scale).clamp(q_min, q_max)
    return (q * scale).reshape(x.shape)


def fake_quant_int_asym(x: torch.Tensor, n_bits: int, *,
                        granularity: str = "per_token", group_size: int = 128,
                        scale_eps: float = 1e-5) -> torch.Tensor:
    """:func:`fake_quant_int_asym_ref`'s function: kernel Q3 on a card, the
    plain version on the CPU."""
    return _kernels().fake_quant_int_asym(x, n_bits, granularity=granularity,
                                          group_size=group_size,
                                          scale_eps=scale_eps)


def fake_quant_int_asym_ref(x: torch.Tensor, n_bits: int, *,
                            granularity: str = "per_token",
                            group_size: int = 128,
                            scale_eps: float = 1e-5) -> torch.Tensor:
    """Asymmetric linear quantization with a zero point: ``scale =
    max(max - min, eps) / (q_max - q_min)``, ``zp = round(q_min - min /
    scale)``, ``q = clamp(round(x / scale) + zp)``, ``(q - zp) * scale``."""
    q_min, q_max = _int_range(n_bits)
    xg = _group(x, granularity, group_size)
    t_min, t_max = _amin(xg, granularity), _amax(xg, granularity)
    scale = (t_max - t_min).clamp_min(scale_eps) * inv(q_max - q_min)
    zp = torch.round(q_min - t_min / scale)
    q = (torch.round(xg / scale) + zp).clamp(q_min, q_max)
    return ((q - zp) * scale).reshape(x.shape)


def fake_quant_log2(x: torch.Tensor, n_bits: int, *,
                    granularity: str = "per_token",
                    group_size: int = 128) -> torch.Tensor:
    """Asymmetric quantization of ``log2|x|`` with the sign restored (zeros
    stay zero); the scale is clamped after the division, as in the JAX
    package and its reference.  ``torch.log2`` / ``exp2`` and XLA's differ
    in the last bits, so this quantizer agrees with JAX's within a relative
    1e-5, not bit for bit."""
    q_min, q_max = _int_range(n_bits)
    xg = _group(x, granularity, group_size)
    zero_mask = xg == 0
    one = torch.ones((), dtype=x.dtype, device=x.device)
    logx = torch.log2(torch.where(zero_mask, one, xg.abs()))
    lmax = logx.amax(dim=-1, keepdim=True)
    lmin = logx.amin(dim=-1, keepdim=True)
    scale = ((lmax - lmin) * inv(q_max - q_min)).clamp_min(1e-5)
    zp = torch.round(q_min - lmin / scale)
    ldq = ((torch.round(logx / scale) + zp).clamp(q_min, q_max) - zp) * scale
    out = torch.where(zero_mask, torch.zeros((), dtype=x.dtype,
                                             device=x.device),
                      torch.exp2(ldq) * torch.sign(xg))
    return out.reshape(x.shape)


def fake_quant_kv(x: torch.Tensor, qcfg) -> torch.Tensor:
    """The KV cache's fake quantizer over ``[..., T, H, head_dim]``: by
    ``qcfg.resolved_kv_format()``, ``int_sym`` per token in float32 (cast
    back), a dual grid per token, fp6 per token, or fp4 per group of
    ``min(group_size, head_dim)``.  With ``kv_ref_grouping`` fp4 groups
    follow the reference's flat ``(-1, group_size)`` view of a head-major
    cache: ``[..., H, T, c]`` flattened, so that a group spans
    ``group_size / c`` consecutive tokens of one head (the element count
    must divide by ``group_size``)."""
    fmt = qcfg.resolved_kv_format()
    if fmt == "int_sym":
        return fake_quant_int_sym(x.to(torch.float32), qcfg.kv_bit,
                                  granularity="per_token").to(x.dtype)
    if fmt in G.DUAL_GRIDS:
        return fake_quant_dual(x, fmt, granularity="per_token")
    if fmt not in ("fp_e1", "fp_e2", "fp_e3"):
        return fake_quant_fp(x, fmt, granularity="per_token")
    if qcfg.kv_ref_grouping:
        x_hm = x.transpose(-3, -2)                  # [..., H, T, c]
        out = fake_quant_fp(x_hm.reshape(-1, qcfg.group_size), fmt,
                            granularity="per_group",
                            group_size=qcfg.group_size)
        return out.reshape(x_hm.shape).transpose(-3, -2)
    return fake_quant_fp(x, fmt, granularity="per_group",
                         group_size=min(qcfg.group_size, x.shape[-1]))


def make_act_quantizer(fmt: str, n_bits: int, *,
                       granularity: str = "per_group",
                       group_size: int = 128,
                       symmetric: bool = False) -> Callable:
    """The activation quantizer of one format, as JAX's
    ``make_act_quantizer``: a grid (the per-token fp4 formats clamp to
    [-3, 3] first, as the JAX package and its reference do), a dual grid,
    neg-reverse, log2, ``int_sym`` (or ``int`` with ``symmetric``) or
    ``int_asym`` / ``int``."""
    if fmt in G.GRIDS:
        clip = 3.0 if (granularity == "per_token"
                       and fmt.startswith("fp_e")) else None
        return partial(fake_quant_fp, fmt=fmt, granularity=granularity,
                       group_size=group_size, clip_abs=clip)
    if fmt in G.DUAL_GRIDS:
        return partial(fake_quant_dual, fmt=fmt, granularity=granularity,
                       group_size=group_size)
    if fmt == "fp_neg_reverse_quant":
        return partial(fake_quant_neg_reverse, group_size=group_size)
    if fmt == "log2":
        return partial(fake_quant_log2, n_bits=n_bits,
                       granularity=granularity, group_size=group_size)
    if fmt == "int_sym" or (fmt == "int" and symmetric):
        return partial(fake_quant_int_sym, n_bits=n_bits,
                       granularity=granularity, group_size=group_size)
    if fmt in ("int_asym", "int"):
        return partial(fake_quant_int_asym, n_bits=n_bits,
                       granularity=granularity, group_size=group_size)
    raise ValueError(f"unknown activation format {fmt!r}")


def make_weight_quantizer(fmt: str, n_bits: int, *,
                          granularity: str = "per_group",
                          group_size: int = 128) -> Callable:
    """The weight quantizer of a grid format or ``int_sym`` / ``int``:
    ``per_channel`` runs the per-token code path (with its clamp to
    [-3, 3] for the fp4 formats), as JAX's ``make_weight_quantizer``
    does."""
    if fmt in G.GRIDS:
        clip = 3.0 if (granularity == "per_channel"
                       and fmt.startswith("fp_e")) else None
        gran = "per_token" if granularity == "per_channel" else granularity
        return partial(fake_quant_fp, fmt=fmt, granularity=gran,
                       group_size=group_size, clip_abs=clip)
    if fmt in ("int_sym", "int"):
        gran = "per_token" if granularity == "per_channel" else granularity
        return partial(fake_quant_int_sym, n_bits=n_bits, granularity=gran,
                       group_size=group_size)
    raise ValueError(f"unknown weight format {fmt!r}")
