"""Quantized weight representations: grid-index codes and integer codes.

Two representations, each bit-equal to the JAX package's ``ops/packing.py``:

:class:`PackedTensor` (the ``packed`` backend, kernel K2).  A code is the
index into the format's sorted value grid; the value is
``grid[code] * scale``.  The fp4 formats (grids of <= 16 values) store two
codes per byte in the row-split layout when ``rows % 128 == 0``: within
each 128-row tile, byte row r (0 <= r < 64) holds row r in its low nibble
and row 64 + r in its high nibble.  Otherwise (fp6, or rows not a multiple
of 128) there is one code per byte.  Codes keep the weight's own
``[..., rows, K]`` layout (``[..., rows / 2, K]`` nibble-packed), which is
K-contiguous, as the CUDA kernel reads its B operand.  Scales are float32
``[..., G, rows]``: JAX keeps them ``[..., rows, G]``; the port transposes
them once (in :func:`pack` and in ``utils/bridge.py``) because the kernel
reads one scale row per K group.

:class:`IntPack` (the ``int8`` backend, kernels K1 and K5).  Every fp4/fp6 grid
becomes a set of small exact integers after multiplying by a fixed power of
two (e2m1 x2 -> {0, ±1..±4, ±6, ±8, ±12}), so a quantized linear runs as
int8 x int8 -> int32 group products with the per-group scales applied in
float32 afterwards:

    y[m,n] = sum_g  ascale[m,g] * wscale[g,n] * (acodes[m,g] . wcodes[n,g])

with ``scale = absmax / gmax / mult`` absorbing the multiplier.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import quantizers as Q

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
class PackedTensor:
    """A weight as grid-index codes plus per-group scales (module
    docstring).  ``shape`` is the logical per-block (rows, K); a
    depth-stacked tensor carries a leading depth axis on codes and
    scales."""

    codes: torch.Tensor
    scales: torch.Tensor
    fmt: str
    shape: Tuple[int, ...]
    group_size: int
    nibble_packed: bool = False

    def block(self, i: int) -> "PackedTensor":
        """Block ``i`` of a depth-stacked tensor."""
        return PackedTensor(self.codes[i], self.scales[i], self.fmt,
                            self.shape, self.group_size, self.nibble_packed)


def encode_to_grid(x: torch.Tensor, grid) -> torch.Tensor:
    """Nearest-grid code indices (int32): the count of midpoints ``<= x``,
    the tie rule of :func:`quantizers.snap_to_grid`."""
    g = np.asarray(grid, dtype=np.float32)
    idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for m in ((g[1:] + g[:-1]) * np.float32(0.5)).tolist():
        idx = idx + (x >= m).to(torch.int32)
    return idx


def pack_codes_ref(x: torch.Tensor, fmt: str, group_size: int = 128):
    """``pack``'s quantize stage, in the operations of JAX's jitted
    ``pack``: ``absmax * (1/gmax)`` in x's dtype (then float32), the true
    division ``x / scale``, then the midpoint count -> (grid-index codes
    int32 ``[..., K]``, scales f32 ``[..., G, 1]``).  The plain version of
    kernel Q2's index route (``ops/quant_kernels.py`` ``pack_codes``)."""
    grid = G.GRIDS[fmt]
    xg = Q.group_reshape(x, group_size)
    scales = Q.safe_scale(xg.abs().amax(dim=-1, keepdim=True),
                          Q.inv_max(grid)).to(torch.float32)
    return encode_to_grid(xg / scales, grid).reshape(x.shape), scales


def grid_index_codes_ref(x: torch.Tensor, fmt: str):
    """The generic-grid KV codec's encode (JAX's jitted ``make_kv_codec``
    for a grid without value codes): ``x`` in float32, one scale
    ``absmax * f32(1/gmax)`` a row of the last dim, the true division,
    the nearest grid index as int8 -> (codes ``[..., c]``, scales f32
    ``[..., 1]``).  The plain version of kernel Q2's index route
    (``ops/quant_kernels.py`` ``grid_index_codes``)."""
    grid = G.GRIDS[fmt]
    xf = x.to(torch.float32)
    scales = Q.safe_scale(xf.abs().amax(dim=-1, keepdim=True),
                          Q.inv_max(grid))
    return encode_to_grid(xf / scales, grid).to(torch.int8), scales


def pack(x: torch.Tensor, fmt: str, group_size: int = 128) -> PackedTensor:
    """Quantize ``x [..., rows, K]`` to codes and per-group scales
    (:func:`pack_codes_ref`'s operations; kernel Q2 on a card), then lay
    the codes out as the kernels read them."""
    from fpqvar_tpu_torch.ops import quant_kernels

    grid = G.GRIDS[fmt]
    shape = tuple(x.shape)
    codes, scales = quant_kernels.pack_codes(x, fmt, group_size)
    nibble = len(grid) <= 16 and len(shape) >= 2 and shape[-2] % 128 == 0
    if nibble:
        rows = shape[-2]
        ct = codes.to(torch.int32).reshape(
            shape[:-2] + (rows // 128, 128, shape[-1]))
        packed = (ct[..., :64, :] | (ct[..., 64:, :] << 4)).to(torch.int8)
        packed = packed.reshape(shape[:-2] + (rows // 2, shape[-1]))
    else:
        packed = codes.to(torch.int8)
    return PackedTensor(packed.contiguous(),
                        scales[..., 0].transpose(-1, -2).contiguous(), fmt,
                        shape, group_size, nibble)


def pack_stacked(w: torch.Tensor, fmt: str,
                 group_size: int = 128) -> PackedTensor:
    """Pack a depth-stacked weight ``[d, rows, K]``; ``shape`` records the
    per-block ``(rows, K)``, so ``block(i)`` is a valid tensor."""
    p = pack(w, fmt, group_size)
    return PackedTensor(p.codes, p.scales, fmt, p.shape[1:], group_size,
                        p.nibble_packed)


def unpack_codes(p: PackedTensor) -> torch.Tensor:
    """int32 code indices ``[..., rows, K]`` (the inverse of the row-split
    nibble layout)."""
    if not p.nibble_packed:
        return p.codes.to(torch.int32)
    lead = tuple(p.codes.shape[:-2])
    rows, k = p.shape[-2], p.shape[-1]
    b = p.codes.to(torch.int32) & 0xFF
    bt = b.reshape(lead + (rows // 128, 64, k))
    return torch.cat([bt & 0xF, (bt >> 4) & 0xF], dim=-2).reshape(
        lead + (rows, k))


def grid_values(p: PackedTensor) -> torch.Tensor:
    """The exact grid values of the codes as float32 ``[..., rows, K]``:
    the kernels' select-tree decoders where the format has one
    (:data:`DECODERS`), else the grid table."""
    codes = unpack_codes(p)
    decode = DECODERS.get(p.fmt)
    if decode is not None:
        return decode(codes)
    return _grid_table(p.fmt, codes.device)[codes.long()]


@lru_cache(maxsize=None)
def _grid_table(fmt: str, device: torch.device) -> torch.Tensor:
    """The grid of ``fmt`` on ``device``, copied there once: a copy from
    pageable host memory on every call would make the host wait for the
    device, and has no place in a captured CUDA graph."""
    with torch.inference_mode(False):
        return torch.as_tensor(G.GRIDS[fmt]).to(device)


def dequantize(p: PackedTensor, dtype=torch.float32) -> torch.Tensor:
    """``grid[code] * scale`` in float32, cast to ``dtype`` (the JAX
    package's reference dequantization)."""
    vals = grid_values(p)
    g = p.group_size
    vg = vals.reshape(vals.shape[:-1] + (vals.shape[-1] // g, g))
    out = vg * p.scales.transpose(-1, -2)[..., None]
    return out.reshape(vals.shape).to(dtype)


def decode_fp4_e2m1(codes: torch.Tensor) -> torch.Tensor:
    """Code (0..14, index into the sorted e2m1 grid; 7 is 0) -> value by a
    select tree on the bits of the magnitude rank, as the kernels decode:
    ``sign(i - 7) * [0, .5, 1, 1.5, 2, 3, 4, 6][|i - 7|]``."""
    i = codes.to(torch.int32) - 7
    k = i.abs()
    b0 = (k & 1) != 0
    b1 = (k & 2) != 0
    lo = torch.where(b1, torch.where(b0, 1.5, 1.0), torch.where(b0, 0.5, 0.0))
    hi = torch.where(b1, torch.where(b0, 6.0, 4.0), torch.where(b0, 3.0, 2.0))
    return torch.sign(i).to(torch.float32) * torch.where(k >= 4, hi, lo)


def decode_fp6_e2m3(codes: torch.Tensor) -> torch.Tensor:
    """Code (0..62 into the sorted e2m3 grid; 31 is 0) -> value: magnitude
    rank k < 16 is ``0.125 k``, else ``(8 + (k & 7)) * (0.5 if k >= 24
    else 0.25)``."""
    i = codes.to(torch.int32) - 31
    k = i.abs()
    lin = 0.125 * k.to(torch.float32)
    geo = (8.0 + (k & 7).to(torch.float32)) * torch.where(k >= 24, 0.5, 0.25)
    return torch.sign(i).to(torch.float32) * torch.where(k < 16, lin, geo)


#: format -> select-tree decoder of its codes (the two that K2 decodes)
DECODERS = {"fp_e2": decode_fp4_e2m1, "fp6_e2m3": decode_fp6_e2m3}


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


def quant_int_codes(x: torch.Tensor, fmt: str, group_size: int = 128):
    """Quantize ``(..., K)`` -> (codes int8 ``(..., K)``, scales f32
    ``(..., G)``) with value = code * scale: kernel Q2 on a card
    (``ops/quant_kernels.py``), :func:`quant_int_codes_ref` on the CPU."""
    from fpqvar_tpu_torch.ops import quant_kernels

    return quant_kernels.quant_int_codes(x, fmt, group_size)


def quant_int_codes_ref(x: torch.Tensor, fmt: str, group_size: int = 128):
    """Plain version of :func:`quant_int_codes`.

    The operations of the JAX package's jitted ``quant_int_codes``, in its
    order, for bit-equality: ``absmax * (1/gmax)``, then ``x / scale`` (a
    division, not a reciprocal multiply), then the compare-sum snap, then
    ``round(snapped * mult)``.  An all-zero group gets scale 1."""
    grid = G.GRIDS[fmt]
    mult = float(CODE_MULT[fmt])
    xf = Q.group_reshape(x, group_size).to(torch.float32)
    scale = Q.safe_scale(xf.abs().amax(dim=-1, keepdim=True),
                         Q.inv_max(grid))
    snapped = Q.snap_to_grid(xf / scale, grid)
    codes = torch.round(snapped * mult).to(torch.int8)
    return codes.reshape(x.shape), (scale[..., 0] / mult).to(torch.float32)


def quant_int_codes_dual(x: torch.Tensor, fmt: str, group_size: int = 128):
    """Dual-grid (fc2) variant -> (codes_neg, scales_neg, codes_pos,
    scales_pos), value = cn * sn + cp * sp: kernel Q2 on a card,
    :func:`quant_int_codes_dual_ref` on the CPU."""
    from fpqvar_tpu_torch.ops import quant_kernels

    return quant_kernels.quant_int_codes_dual(x, fmt, group_size)


def quant_int_codes_dual_ref(x: torch.Tensor, fmt: str,
                             group_size: int = 128):
    """Plain version of :func:`quant_int_codes_dual`: ``x <= 0`` goes on
    the negative grid and ``x > 0`` on the positive one; each half snaps
    the other half's zeros to 0."""
    neg_grid, pos_grid = G.DUAL_GRIDS[fmt]
    nmult, pmult = (float(m) for m in DUAL_CODE_MULT[fmt])
    xf = Q.group_reshape(x, group_size).to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    x_neg = torch.where(xf <= 0, xf, zero)
    x_pos = torch.where(xf > 0, xf, zero)
    sn = Q.safe_scale(x_neg.abs().amax(dim=-1, keepdim=True),
                      Q.inv_max(neg_grid))
    sp = Q.safe_scale(x_pos.abs().amax(dim=-1, keepdim=True),
                      Q.inv_max(pos_grid))
    cn = torch.round(Q.snap_to_grid(x_neg / sn, neg_grid) * nmult)
    cp = torch.round(Q.snap_to_grid(x_pos / sp, pos_grid) * pmult)
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
