"""Fake quantization: quantize, then dequantize, in the input's own dtype.

The counterpart of the JAX package's ``ops/quantizers.py`` for the
quantizers the ``fake`` and ``packed`` recipes run: the nearest-grid snap,
the single-grid fp quantizer and the dual-grid (fc2) quantizer, per group,
per token or per channel.  The ops run in the dtypes that JAX's functions
take under ``jit``, so the results are bit-equal to them at float32 and
bfloat16: ``absmax``, the scale and ``q * scale`` are rounded to
``x.dtype``; XLA turns ``absmax / gmax`` into ``absmax * f32(1/gmax)``
(:func:`inv_max`); and it fuses the true division ``x / scale`` into the
float32 snap without rounding the quotient to ``x.dtype``
(:func:`_snap_div`).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import torch

from fpqvar_tpu_torch.ops import grids as G


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md: the rest of the fake "
        "backend)")


def inv_max(grid) -> float:
    """``1 / max|grid|`` rounded to float32.  JAX runs its quantizers under
    ``jit``, where XLA turns ``absmax / gmax`` (a division by a constant)
    into ``absmax * f32(1 / gmax)``; the two differ in the last bit of many
    scales, so the port multiplies as the jitted JAX code does."""
    return float(np.float32(1.0) / np.float32(np.max(np.abs(grid))))


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


def _axis_absmax(x: torch.Tensor, granularity: str, group_size: int):
    """(x grouped, absmax over the last axis, keepdim)."""
    if granularity in ("per_token", "per_channel"):
        xg = x
    elif granularity == "per_group":
        xg = group_reshape(x, group_size)
    elif granularity == "per_tensor":
        raise _unported("per-tensor fake quantization")
    else:
        raise ValueError(f"unknown granularity {granularity!r}")
    return xg, xg.abs().amax(dim=-1, keepdim=True)


def fake_quant_fp(x: torch.Tensor, fmt: str, *, granularity: str = "per_group",
                  group_size: int = 128,
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
                    group_size: int = 128) -> torch.Tensor:
    """Sign-split dual-grid quantization (the fc2 formats): ``x <= 0`` on
    the negative grid and ``x > 0`` on the positive one, each half with its
    own absmax scale; each half snaps the other half's zeros to 0, so
    ``q_neg * scale_neg + q_pos * scale_pos`` is exact."""
    neg_grid, pos_grid = G.DUAL_GRIDS[fmt]
    xg, _ = _axis_absmax(x, granularity, group_size)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    x_neg = torch.where(xg <= 0, xg, zero)
    x_pos = torch.where(xg > 0, xg, zero)
    scale_n = safe_scale(x_neg.abs().amax(dim=-1, keepdim=True),
                         inv_max(neg_grid))
    scale_p = safe_scale(x_pos.abs().amax(dim=-1, keepdim=True),
                         inv_max(pos_grid))
    q_neg = _snap_div(x_neg, scale_n, neg_grid)
    q_pos = _snap_div(x_pos, scale_p, pos_grid)
    return (q_neg * scale_n + q_pos * scale_p).reshape(x.shape)


def make_act_quantizer(fmt: str, n_bits: int, *,
                       granularity: str = "per_group",
                       group_size: int = 128) -> Callable:
    """The activation quantizer of one format: the grid and dual-grid
    branches of JAX's ``make_act_quantizer``.  The per-token fp4 formats
    clamp to [-3, 3] first, as the JAX package (and its reference) do."""
    if fmt in G.GRIDS:
        clip = 3.0 if (granularity == "per_token"
                       and fmt.startswith("fp_e")) else None
        return partial(fake_quant_fp, fmt=fmt, granularity=granularity,
                       group_size=group_size, clip_abs=clip)
    if fmt in G.DUAL_GRIDS:
        return partial(fake_quant_dual, fmt=fmt, granularity=granularity,
                       group_size=group_size)
    raise _unported(f"the {fmt!r} activation quantizer")


def make_weight_quantizer(fmt: str, n_bits: int, *,
                          granularity: str = "per_group",
                          group_size: int = 128) -> Callable:
    """The weight quantizer of one grid format: ``per_channel`` runs the
    per-token code path (with its clamp to [-3, 3] for the fp4 formats),
    as JAX's ``make_weight_quantizer`` does."""
    if fmt in G.GRIDS:
        clip = 3.0 if (granularity == "per_channel"
                       and fmt.startswith("fp_e")) else None
        gran = "per_token" if granularity == "per_channel" else granularity
        return partial(fake_quant_fp, fmt=fmt, granularity=gran,
                       group_size=group_size, clip_abs=clip)
    raise _unported(f"the {fmt!r} weight quantizer")
