"""Integer-value codes for the grouped int8 GEMM.

Every fp4/fp6 grid becomes a set of small exact integers after multiplying
by a fixed power of two (e2m1 x2 -> {0, ±1..±4, ±6, ±8, ±12}), so a
quantized linear runs as int8 x int8 -> int32 group products with the
per-group scales applied in float32 afterwards:

    y[m,n] = sum_g  ascale[m,g] * wscale[g,n] * (acodes[m,g] . wcodes[n,g])

with ``scale = absmax / gmax / mult`` absorbing the multiplier.  The codes
and scales here are bit-equal to the JAX package's ``ops/packing.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops.quantizers import snap_to_grid

#: format -> multiplier making every grid value an exact integer that fits
#: in int8
CODE_MULT = {
    "fp_e1": 4,        # e1m2: 0.25 steps        -> |int| <= 7
    "fp_e2": 2,        # e2m1: 0.5 granularity   -> |int| <= 12
    "fp_e3": 4,        # e3m0: 0.25 min          -> |int| <= 64
    "fp6_e2m3": 8,     # e2m3: 0.125 min         -> |int| <= 60
}

#: dual-grid format -> (neg_mult, pos_mult)
DUAL_CODE_MULT = {
    "fp_e1m2_neg_e2m1_pos": (4, 2),
    "fp4_afpq": (2, 2),
    "fp6_int_neg_e2m3_pos": (1, 8),
}


@dataclass(frozen=True)
class IntPack:
    """A weight packed as integer-value codes for the grouped int8 GEMM.

    ``codes``: int8 ``[..., N, K]``, the weight's own (out, in) layout.
    The JAX package stores them transposed, ``[..., K, N]``, so that the
    TPU's matrix unit needs no transpose; the CUDA kernel wants the B
    operand K-contiguous, which is ``[N, K]``
    (``utils/bridge.py`` transposes JAX codes once on the way in).
    ``scales``: float32 ``[..., G, N]`` with the code multiplier folded in
    (value = code * scale), as in JAX.  ``shape`` is the logical (N, K).
    """

    codes: torch.Tensor
    scales: torch.Tensor
    fmt: str
    shape: Tuple[int, ...]
    group_size: int

    def block(self, i: int) -> "IntPack":
        """Block ``i`` of a depth-stacked pack."""
        return IntPack(self.codes[i], self.scales[i], self.fmt, self.shape,
                       self.group_size)


def _grouped(x: torch.Tensor, group_size: int) -> torch.Tensor:
    shape = tuple(x.shape)
    if shape[-1] % group_size:
        raise ValueError(
            f"last dim {shape[-1]} not divisible by group_size {group_size}")
    return x.reshape(shape[:-1] + (shape[-1] // group_size, group_size))


def _inv_max(grid) -> float:
    """``1 / max|grid|`` rounded to float32.  JAX runs its quantizers under
    ``jit``, where XLA turns ``absmax / gmax`` (a division by a constant)
    into ``absmax * f32(1 / gmax)``; the two differ in the last bit of many
    scales, so the port multiplies as the jitted JAX code does."""
    return float(np.float32(1.0) / np.float32(np.max(np.abs(grid))))


def quant_int_codes(x: torch.Tensor, fmt: str, group_size: int = 128):
    """Quantize ``(..., K)`` -> (codes int8 ``(..., K)``, scales f32
    ``(..., G)``) with value = code * scale.

    The operations of the JAX package's jitted ``quant_int_codes``, in its
    order, for bit-equality: ``absmax * (1/gmax)``, then ``x / scale`` (a
    division, not a reciprocal multiply), then the compare-sum snap, then
    ``round(snapped * mult)``.  An all-zero group gets scale 1."""
    grid = G.GRIDS[fmt]
    mult = float(CODE_MULT[fmt])
    xf = _grouped(x, group_size).to(torch.float32)
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax * _inv_max(grid),
                        torch.ones_like(absmax))
    snapped = snap_to_grid(xf / scale, grid)
    codes = torch.round(snapped * mult).to(torch.int8)
    return codes.reshape(x.shape), (scale[..., 0] / mult).to(torch.float32)


def quant_int_codes_dual(x: torch.Tensor, fmt: str, group_size: int = 128):
    """Dual-grid (fc2) variant -> (codes_neg, scales_neg, codes_pos,
    scales_pos), value = cn * sn + cp * sp.  ``x <= 0`` goes on the
    negative grid and ``x > 0`` on the positive one; each half snaps the
    other half's zeros to 0."""
    neg_grid, pos_grid = G.DUAL_GRIDS[fmt]
    nmult, pmult = (float(m) for m in DUAL_CODE_MULT[fmt])
    xf = _grouped(x, group_size).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x_neg = torch.where(xf <= 0, xf, zero)
    x_pos = torch.where(xf > 0, xf, zero)
    amax_n = x_neg.abs().amax(dim=-1, keepdim=True)
    amax_p = x_pos.abs().amax(dim=-1, keepdim=True)
    sn = torch.where(amax_n > 0, amax_n * _inv_max(neg_grid),
                     torch.ones_like(amax_n))
    sp = torch.where(amax_p > 0, amax_p * _inv_max(pos_grid),
                     torch.ones_like(amax_p))
    cn = torch.round(snap_to_grid(x_neg / sn, neg_grid) * nmult)
    cp = torch.round(snap_to_grid(x_pos / sp, pos_grid) * pmult)
    return (cn.to(torch.int8).reshape(x.shape),
            (sn[..., 0] / nmult).to(torch.float32),
            cp.to(torch.int8).reshape(x.shape),
            (sp[..., 0] / pmult).to(torch.float32))


def pack_int_codes(w: torch.Tensor, fmt: str, group_size: int = 128) -> IntPack:
    """Pack an ``[N, K]`` (or depth-stacked ``[d, N, K]``) weight: codes stay
    ``[..., N, K]``, scales become ``[..., G, N]``."""
    codes, scales = quant_int_codes(w, fmt, group_size)
    return IntPack(codes.contiguous(),
                   scales.transpose(-1, -2).contiguous(), fmt,
                   tuple(w.shape[-2:]), group_size)
