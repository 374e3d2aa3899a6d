"""The paper's comparison quantizers (the baseline zoo).

The JAX package's ``quantize/baselines.py``, after the reference's
``search/search_fp4_format.py`` and ``search/baseline/``: DuQuant-style
two-segment uniform quantization, FLINT, the clipping-strength sweep of
the dual-grid fc2 quantizer, and the rotation-aware matmul-MSE sweep.  The
AFPQ, log2 and RTN-int baselines are the port's ``ops/quantizers.py``
functions; rotations come from ``ops/hadamard.py``.  Float32 throughout,
on the inputs' device (``device`` where the inputs are numpy), with TF32
off for the products.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Sequence

import numpy as np
import torch

from fpqvar_tpu_torch.ops import hadamard as H
from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.ops.precision import ieee_f32
from fpqvar_tpu_torch.quantize.search import as_f32

#: FLINT 4-bit grid (``search/search_fp4_format.py:238-240``)
FLINT_GRID = np.array(
    [-10.0, -5.0, -3.75, -2.5, -1.875, -1.25, -0.625, 0.0,
     0.625, 1.25, 1.875, 2.5, 3.75, 5.0, 10.0], dtype=np.float32)


def du_quantizer(
    x: torch.Tensor,
    n_bits: int = 4,
    *,
    granularity: str = "per_group",
    group_size: int = 128,
    c: float = 1.61,
    m: int = 5,
    big_k: float = 3.0,
) -> torch.Tensor:
    """DuQuant-style two-segment uniform quantizer
    (``du_quantizer_per_{token,group}``, ``search_fp4_format.py:128-203``):
    per token the values are normalized by their std (c = 1.67), per group
    by absmax / K (c = 1.61, the reference's "v2"); the inner region
    ``|x| <= c`` gets step c / m, the outer region (c, K] the remaining
    levels."""
    if granularity == "per_token":
        xg = x
        denom = torch.std(x, dim=-1, keepdim=True, correction=1)
        c_eff = 1.67 if c == 1.61 else c
    else:
        xg = Q.group_reshape(x, group_size)
        amax = xg.abs().amax(dim=-1, keepdim=True)
        denom = torch.where(amax > 0, amax / big_k, torch.ones_like(amax))
        c_eff = c
    xn = torch.clamp(xg / denom, -big_k, big_k)
    s1 = c_eff / m
    n_outer = 2 ** (n_bits - 1) - 1 - m
    s2 = (big_k - c_eff) / n_outer
    inner = torch.clamp(torch.round(xn / s1), -m, m) * s1
    outer = torch.sign(xn) * (c_eff + torch.clamp(
        torch.round((xn.abs() - c_eff) / s2), 0, n_outer) * s2)
    out = torch.where(xn.abs() <= c_eff, inner, outer) * denom
    return out.reshape(x.shape)


def flint_quant(x: torch.Tensor, *, granularity: str = "per_token",
                group_size: int = 128) -> torch.Tensor:
    """FLINT 4-bit grid quantization (``search_fp4_format.py:236-250``)."""
    gmax = float(np.max(np.abs(FLINT_GRID)))
    xg = (Q.group_reshape(x, group_size) if granularity == "per_group"
          else x)
    amax = xg.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / gmax, torch.ones_like(amax))
    return (Q.snap_to_grid(xg / scale, FLINT_GRID) * scale).reshape(x.shape)


def _mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.mean((a - b) ** 2))


def clipping_strength_sweep(
    x, w, fmt: str = "fp_e1m2_neg_e2m1_pos",
    strengths: Sequence[float] = tuple(np.arange(0.5, 1.01, 0.05)),
    group_size: int = 128, device="cuda",
) -> Dict[float, float]:
    """The dual-grid fc2 quantizer's clipping-strength search
    (``search/search_fp_format_baseline_2.py:489+``): the output MSE per
    clamp strength; the caller picks the argmin."""
    xt, wt = as_f32(x, device), as_f32(w, device)
    with ieee_f32():
        ref = xt @ wt.T
        return {float(s): _mse(ref, Q.fake_quant_dual(
            xt, fmt, group_size=group_size, clipping_strength=float(s)) @ wt.T)
            for s in strengths}


#: the baselines of the MSE comparison
BASELINES = {
    "du": partial(du_quantizer, granularity="per_group"),
    "du_per_token": partial(du_quantizer, granularity="per_token"),
    "flint": flint_quant,
    "fp4_afpq": lambda x, n_bits=4, **kw: Q.fake_quant_dual(
        x, "fp4_afpq", **kw),
    "log2": lambda x, n_bits=4, **kw: Q.fake_quant_log2(x, n_bits, **kw),
    "int_rtn": lambda x, n_bits=4, **kw: Q.fake_quant_int_sym(
        x, n_bits, **kw),
}


def rotated_matmul_mse(x: torch.Tensor, w: torch.Tensor, quantize,
                       rotation: torch.Tensor = None) -> float:
    """MSE(x W^T, Q(xR) Q(WR)^T): one cell of the rotation-aware baseline
    study (``search/baseline/search_fp6_format_for_activation_rotate.py:
    587-600``: quantize the rotated pair, compare with the exact unrotated
    product); ``rotation=None`` gives the plain sweep."""
    with ieee_f32():
        ref = x @ w.T
        if rotation is not None:
            r = rotation.to(x.dtype)
            x = x @ r
            w = w @ r
        return _mse(ref, quantize(x) @ quantize(w).T)


def _sweep_methods(n_bits: int, group_size: int):
    """The rotation-aware sweep's methods: the paper's fp formats and the
    baseline zoo, as x -> quantized(x)."""
    gran = dict(granularity="per_group", group_size=group_size)
    methods = {
        "int_rtn": partial(Q.fake_quant_int_sym, n_bits=n_bits, **gran),
        "du": partial(du_quantizer, n_bits=n_bits, **gran),
        "flint": partial(flint_quant, granularity="per_group",
                         group_size=group_size),
    }
    if n_bits == 4:
        for f in ("fp_e1", "fp_e2", "fp_e3"):
            methods[f] = partial(Q.fake_quant_fp, fmt=f, **gran)
        methods["fp4_afpq"] = partial(Q.fake_quant_dual, fmt="fp4_afpq",
                                      **gran)
    else:
        for f in ("fp6_e2m3", "fp6_e3m2"):
            methods[f] = partial(Q.fake_quant_fp, fmt=f, **gran)
    return methods


def rotation_aware_sweep(
    acts,                       # [N, C] calibration activations
    weight,                     # [out, C]
    n_bits: int = 4,
    group_size: int = 128,
    block_rotate: bool = True,
    rotation_seed: int = 42,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """The ``--block_rotate`` baseline comparison: per method, the matmul
    output's MSE without and with a Hadamard rotation (block-diagonal or
    full-size, as ``rotate_utils``), the study the reference's
    ``search/baseline/*_for_activation_rotate.py`` scripts run per
    block."""
    x, w = as_f32(acts, device), as_f32(weight, device)
    c = x.shape[-1]
    if block_rotate:
        qb = torch.as_tensor(H.block_hadamard_block(128, rotation_seed),
                             dtype=torch.float32, device=x.device)
        rot = torch.kron(torch.eye(c // 128, dtype=torch.float32,
                                   device=x.device), qb)
    else:
        rot = torch.as_tensor(H.random_hadamard_matrix(c, rotation_seed),
                              dtype=torch.float32, device=x.device)
    return {name: {"plain": rotated_matmul_mse(x, w, fn),
                   "rotated": rotated_matmul_mse(x, w, fn, rot)}
            for name, fn in _sweep_methods(n_bits, group_size).items()}


def compare_baselines(x, n_bits: int = 4, group_size: int = 128,
                      device="cuda") -> Dict[str, float]:
    """Per-method reconstruction MSE on a tensor: the numerical study of
    the reference's ``search/baseline/`` scripts."""
    xt = as_f32(x, device)
    out = {}
    for name, fn in BASELINES.items():
        if name in ("du_per_token", "flint"):
            q = fn(xt)
        else:
            q = fn(xt, n_bits=n_bits, group_size=group_size)
        out[name] = _mse(xt, q)
    return out
