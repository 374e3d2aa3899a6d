"""Plain quantizers of the FPQVAR recipes: value grids, absmax scaling,
nearest-grid snap, and the 128-wide block rotation.

Written from the recipes' definitions (the paper's formats and the
configurations' stated dtypes), with no code of the program under test:
``scale = absmax / max|grid|`` taken as a multiply by the float32
reciprocal and rounded to the tensor's dtype, the quotient ``x / scale``
in float32, snapped to the nearest grid value (a tie goes up), and
``value * scale`` in the tensor's dtype.
"""
from __future__ import annotations

import numpy as np
import torch


def fp_grid(exp_bits: int, man_bits: int) -> np.ndarray:
    """The sorted values of a signed ExMy mini-float with subnormals and
    no inf / NaN codes (bias 1 for one exponent bit, else 2^(e-1) - 1)."""
    bias = (2 ** (exp_bits - 1) - 1) if exp_bits >= 2 else 1
    vals = {0.0}
    for e in range(2 ** exp_bits):
        for m in range(2 ** man_bits):
            frac = m / 2 ** man_bits
            v = frac * 2.0 ** (1 - bias) if e == 0 else (1 + frac) * 2.0 ** (
                e - bias)
            vals.update((v, -v))
    return np.array(sorted(vals), dtype=np.float32)


E2M1 = fp_grid(2, 1)
E1M2 = fp_grid(1, 2)
E2M3 = fp_grid(2, 3)

#: single-grid formats by name
GRIDS = {"fp_e2": E2M1, "fp_e1": E1M2, "fp6_e2m3": E2M3}
#: the sign-split (fc2) formats: (grid for x <= 0, grid for x > 0)
DUAL_GRIDS = {
    "fp_e1m2_neg_e2m1_pos": (
        np.append(E1M2[E1M2 < 0], np.float32(0)).astype(np.float32),
        np.insert(E2M1[E2M1 > 0], 0, np.float32(0)).astype(np.float32)),
}


def inv_max(grid) -> float:
    """``1 / max|grid|`` rounded to float32."""
    return float(np.float32(1.0) / np.float32(np.abs(grid).max()))


def snap(q: torch.Tensor, grid) -> torch.Tensor:
    """Nearest value of the sorted ``grid`` for each element of float32
    ``q``; an element on a midpoint takes the larger value."""
    g = torch.as_tensor(np.asarray(grid, np.float32), device=q.device)
    mids = (g[1:] + g[:-1]) * 0.5
    return g[torch.bucketize(q, mids, right=True)]


def _scale(absmax: torch.Tensor, grid) -> torch.Tensor:
    return torch.where(absmax > 0, absmax * inv_max(grid),
                       torch.ones_like(absmax))


def fake_quant(x: torch.Tensor, grid, group: int) -> torch.Tensor:
    """Quantize and dequantize ``x`` over groups of ``group`` elements of
    its last dim, in ``x``'s dtype."""
    shape = x.shape
    xg = x.reshape(shape[:-1] + (shape[-1] // group, group))
    s = _scale(xg.abs().amax(dim=-1, keepdim=True), grid)
    q = snap(xg.float() / s.float(), grid).to(x.dtype)
    return (q * s).reshape(shape)


def fake_quant_dual(x: torch.Tensor, fmt: str, group: int) -> torch.Tensor:
    """The sign-split format: ``x <= 0`` on one grid and ``x > 0`` on the
    other, each half with its own scale, the halves' products summed in
    ``x``'s dtype."""
    neg, pos = DUAL_GRIDS[fmt]
    shape = x.shape
    xg = x.reshape(shape[:-1] + (shape[-1] // group, group))
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    out = None
    for half, grid in ((torch.where(xg <= 0, xg, zero), neg),
                       (torch.where(xg > 0, xg, zero), pos)):
        s = _scale(half.abs().amax(dim=-1, keepdim=True), grid)
        part = snap(half.float() / s.float(), grid).to(x.dtype) * s
        out = part if out is None else out + part
    return out.reshape(shape)


def quant_f32(x: torch.Tensor, fmt: str, group: int) -> torch.Tensor:
    """The integer-code quantization of the int8 recipes as values: ``x``
    in float32, a float32 scale, the snapped value times the scale, in
    float32 (the code times its scale is the same number)."""
    xf = x.float()
    if fmt in DUAL_GRIDS:
        return fake_quant_dual(xf, fmt, group)
    return fake_quant(xf, GRIDS[fmt], group)


def value_codes(x: torch.Tensor, fmt: str, mult: int, group: int):
    """The packed KV cache's codes of ``x`` per group of its last dim:
    (the snapped values times ``mult``, exact integers as float32; the
    float32 scale over ``mult``), so that value = code * scale."""
    grid = GRIDS[fmt]
    shape = x.shape
    xf = x.float().reshape(shape[:-1] + (shape[-1] // group, group))
    s = _scale(xf.abs().amax(dim=-1, keepdim=True), grid)
    codes = torch.round(snap(xf / s, grid) * mult)
    return codes.reshape(shape), (s / mult).reshape(shape[:-1] + (-1,))


def hadamard_block(n: int, seed: int) -> torch.Tensor:
    """``diag(signs) @ H_n / sqrt(n)`` in float64 (Sylvester's H_n, the
    signs ``torch.randint(0, 2, (n,)) * 2 - 1`` from a CPU generator seeded
    with ``seed``)."""
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    gen = torch.Generator().manual_seed(seed)
    signs = (torch.randint(0, 2, (n,), generator=gen) * 2 - 1).double()
    return signs[:, None] * torch.from_numpy(h) / np.sqrt(n)


def to_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale for the whole tensor
    (its absmax onto 448), back in ``t``'s dtype: the control's
    precision."""
    amax = t.abs().amax().float().clamp_min(1e-30)
    s = amax / 448.0
    return ((t.float() / s).to(torch.float8_e4m3fn).float() * s).to(t.dtype)
