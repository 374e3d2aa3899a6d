"""Function-preserving activation-outlier planting.

The JAX package's ``quantize/outliers.py``.  The FPQVAR recipe exists
because VAR-d30's block inputs carry heavy-tailed per-channel outliers;
small models trained on synthetic data have none, so every quantization
mode measures lossless end to end.  ``plant_activation_outliers``
retrofits such statistics onto a trained model without changing its
function: for a scale vector ``s`` over the hidden channels it rewrites

    x1 = LN(x) * (1 + scale1) + shift1        (the mat_qkv input)
    x2 = LN(x) * (1 + scale2) + shift2        (the fc1 input)

into ``s * x1`` / ``s * x2`` (by rescaling the ada_lin rows that emit
scale1/2 and shift1/2) while dividing the input columns of ``mat_qkv_w``
and ``fc1_w`` by ``s``: SmoothQuant's equivalence run backwards.  In exact
arithmetic the block outputs are unchanged; every activation quantizer,
rotation and GALT vector now sees hot channels.

The arithmetic is JAX's numpy float32 arithmetic, op for op (separate
multiplies and adds, no fused multiply-add), on the tensors' own device,
so the planted trees are bit-equal to JAX's.  Non-shared-AdaLN models
only.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def outlier_scale_vector(width: int, num_hot: int, max_scale: float,
                         seed: int = 0) -> np.ndarray:
    """[width] float32: 1.0 everywhere except ``num_hot`` random channels
    with log-spaced scales in [max_scale**0.5, max_scale] (a heavy tail,
    like the per-channel absmax ratios of real VAR calibration data);
    drawn with numpy, as JAX draws it."""
    rng = np.random.default_rng(seed)
    s = np.ones(width, np.float32)
    hot = rng.choice(width, size=num_hot, replace=False)
    if num_hot == 1:
        # np.logspace(num=1) returns only its start: one hot channel still
        # gets the full max_scale
        s[hot] = np.float32(max_scale)
    else:
        s[hot] = np.logspace(0.5 * np.log10(max_scale), np.log10(max_scale),
                             num_hot).astype(np.float32)
    return s


def plant_activation_outliers(var_p, cfg, s) -> Tuple[dict, np.ndarray]:
    """Return (params with outliers planted, the scale vector used).

    ada_lin's scale1 / scale2 rows become ``s * (1 + scale) - 1`` (affine:
    ``w *= s``, ``b = s * b + (s - 1)``), the shift rows scale by ``s``,
    and the input columns of mat_qkv_w / fc1_w divide by ``s``; every
    touched leaf comes back float32 on its device.
    """
    if "ada_lin" not in var_p["blocks"]:
        raise ValueError("plant_activation_outliers: non-shared AdaLN "
                         "models only (no blocks['ada_lin'])")
    c = cfg.width
    s_np = np.asarray(s, np.float32)
    assert s_np.shape == (c,)
    blocks = dict(var_p["blocks"])
    ada = blocks["ada_lin"]
    dev = ada["w"].device
    st = torch.from_numpy(s_np).to(dev)
    w = ada["w"].detach().to(torch.float32).clone()       # [d, 6C, D]
    b = ada["b"].detach().to(torch.float32).clone()       # [d, 6C]
    # sections of the 6C output: gamma1, gamma2, scale1, scale2, shift1,
    # shift2 (models/var.py compute_modulations' unpack order)
    for sec in (2, 3):          # scale1 / scale2: (1+scale') = s * (1+scale)
        rows = slice(sec * c, (sec + 1) * c)
        w[:, rows, :] *= st[None, :, None]
        b[:, rows] = st[None, :] * b[:, rows] + (st[None, :] - 1.0)
    for sec in (4, 5):          # shift1 / shift2: shift' = s * shift
        rows = slice(sec * c, (sec + 1) * c)
        w[:, rows, :] *= st[None, :, None]
        b[:, rows] *= st[None, :]
    blocks["ada_lin"] = {"w": w, "b": b}
    inv = 1.0 / st
    for kind in ("mat_qkv_w", "fc1_w"):       # [d, out, C]: columns / s
        blocks[kind] = (blocks[kind].detach().to(torch.float32)
                        * inv[None, None])
    out = dict(var_p)
    out["blocks"] = blocks
    return out, s_np
