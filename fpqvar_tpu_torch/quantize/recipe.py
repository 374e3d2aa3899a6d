"""Offline checkpoint transformation: GALT fold -> rotate -> quantize.

A function over the params tree, as the JAX package's
``quantize/recipe.py``:

1. GALT fold: ``W_qkv /= s_qkv`` and ``W_fc1 /= s_fc1`` along the input
   channels, keeping the vectors for the online activation multiply;
2. rotation ``W <- W @ Q`` for mat_qkv and fc1, block-diagonal or
   full-size, in float64 on the host;
3. weight quantization: :class:`IntPack` integer codes for the ``int8``
   backend (per group of 128, or per output channel),
   :class:`PackedTensor` grid codes for the ``packed`` backend, or
   fake-quantized (dequantized) float weights for the ``fake`` backend
   (``int_sym`` under ``int_quant``); with ``quantize_ada`` also the
   AdaLN linears (``ada_lin`` or ``shared_ada_lin``), always fake.

``quantize_var_params`` is the bit-parity surface (float64 rotation on the
host).  ``transform_blocks_traced`` runs the same pipeline on the tensors'
device in float32 and ``synth_device_params`` builds a seeded, transformed
tree on the card with no host round trip, as the JAX package's benchmark
and serving bench build theirs.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fpqvar_tpu_torch.config import QuantConfig, VARConfig
from fpqvar_tpu_torch.ops import hadamard as H
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.ops.precision import ieee_f32

_WEIGHT_KEYS = ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w")
_ROTATED_KEYS = ("mat_qkv_w", "fc1_w")


def fold_galt(blocks: dict, mat_qkv_s, fc1_s) -> dict:
    """``W /= s`` along input channels; ``s`` ([depth, C]) is kept for the
    online activation multiply."""
    b = dict(blocks)
    dev = blocks["mat_qkv_w"].device
    s1 = torch.as_tensor(mat_qkv_s, dtype=torch.float32, device=dev)
    s2 = torch.as_tensor(fc1_s, dtype=torch.float32, device=dev)
    b["mat_qkv_w"] = blocks["mat_qkv_w"] / s1[:, None, :]
    b["fc1_w"] = blocks["fc1_w"] / s2[:, None, :]
    b["mat_qkv_s"] = s1.to(blocks["mat_qkv_s"].dtype)
    b["fc1_s"] = s2.to(blocks["fc1_s"].dtype)
    return b


def rotate_blocks(blocks: dict, qcfg: QuantConfig) -> dict:
    """Offline rotation ``W <- W @ Q`` in float64 on the host: ``Q`` the
    block-diagonal rotation (applied per 128-block) or the full-size one
    of the width."""
    width = blocks[_ROTATED_KEYS[0]].shape[-1]
    if qcfg.block_rotate:
        q = H.block_hadamard_block(qcfg.rotation_block, qcfg.rotation_seed)
    else:
        q = H.random_hadamard_matrix(width, qcfg.rotation_seed)
    n = q.shape[0]
    out = dict(blocks)
    for key in _ROTATED_KEYS:
        src = blocks[key]
        w = src.detach().cpu().numpy().astype(np.float64)   # [depth, out, in]
        if not qcfg.block_rotate:
            wr = w @ q
        else:
            d, o, i = w.shape
            wr = (w.reshape(d, o, i // n, n) @ q).reshape(d, o, i)
        out[key] = torch.from_numpy(wr).to(device=src.device, dtype=src.dtype)
    return out


def quantize_weights(blocks: dict, qcfg: QuantConfig) -> dict:
    """Every block linear, as the JAX package's ``quantize_weights``:
    ``packed`` -> per-group :class:`PackedTensor` (``P.pack_stacked``);
    ``int8`` -> :class:`IntPack` (``P.pack_int_codes``), per group, or with
    ``weight_quant="per_channel"`` one group of the layer's whole K (one
    scale per output channel); ``fake`` -> the weight quantizer's
    dequantized floats in the weight's dtype."""
    fmt = qcfg.weight_format
    out = dict(blocks)
    if qcfg.backend == "packed":
        if fmt not in G.GRIDS:
            raise ValueError(f"packed backend needs a grid format, got {fmt}")
        for key in _WEIGHT_KEYS:
            out[key] = P.pack_stacked(blocks[key].to(torch.float32), fmt,
                                      qcfg.group_size)
        return out
    if qcfg.backend == "int8":
        if fmt not in P.CODE_MULT:
            raise ValueError(
                f"int8 backend supports {sorted(P.CODE_MULT)}, got {fmt}")
        per_channel = qcfg.weight_quant == "per_channel"
        for key in _WEIGHT_KEYS:
            w = blocks[key].to(torch.float32)
            gs = w.shape[-1] if per_channel else qcfg.group_size
            out[key] = P.pack_int_codes(w, fmt, gs)
        return out
    if qcfg.backend != "fake":
        raise ValueError(f"unknown backend {qcfg.backend!r}")
    wq = _fake_weight_quantizer(qcfg)
    for key in _WEIGHT_KEYS:
        out[key] = wq(blocks[key])
    return out


def _fake_weight_quantizer(qcfg: QuantConfig):
    """The fake backend's weight quantizer (``int_sym`` under
    ``int_quant``): float32 in, the weight's dtype out, over the stacked
    ``[depth, out, in]`` tensor (so a per-tensor scale spans the depth, as
    in JAX)."""
    fmt = "int_sym" if qcfg.int_quant else qcfg.weight_format
    wq = Q.make_weight_quantizer(fmt, qcfg.w_bit,
                                 granularity=qcfg.weight_quant,
                                 group_size=qcfg.group_size)
    return lambda w: wq(w.to(torch.float32)).to(w.dtype)


def quantize_var_params(
    params: dict,
    cfg: VARConfig,
    qcfg: QuantConfig,
    galt: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> dict:
    """Full offline pipeline.  ``galt`` = (mat_qkv_s, fc1_s), each
    [depth, C], required when ``qcfg.transform`` is set.  Runs on the device
    the params lie on, except the float64 rotation, which runs on the
    host."""
    out = dict(params)
    blocks = dict(params["blocks"])
    if qcfg.transform:
        if galt is None:
            raise ValueError("qcfg.transform=True requires GALT vectors")
        blocks = fold_galt(blocks, *galt)
    if qcfg.rotate:
        blocks = rotate_blocks(blocks, qcfg)
    if qcfg.enabled:
        blocks = quantize_weights(blocks, qcfg)
        if qcfg.quantize_ada:
            # always fake (dequantized weights) under every backend: the
            # modulations are computed once per generation
            wq = _fake_weight_quantizer(qcfg)
            if "ada_lin" in blocks:
                blocks["ada_lin"] = {**blocks["ada_lin"],
                                     "w": wq(blocks["ada_lin"]["w"])}
            if "shared_ada_lin" in out:
                out["shared_ada_lin"] = {**out["shared_ada_lin"],
                                         "w": wq(out["shared_ada_lin"]["w"])}
    out["blocks"] = blocks
    return out


def _rotate_f32(blocks: dict, cfg: VARConfig, qcfg: QuantConfig,
                galt=None) -> dict:
    """The fold and rotation stage of :func:`transform_blocks_traced`:
    ``mat_qkv_w`` and ``fc1_w`` as float32 ``W / s`` (under GALT) times the
    rotation in float32 on their device; ``mat_qkv_s`` and ``fc1_s`` the
    GALT vectors."""
    if qcfg.transform and galt is None:
        raise ValueError("qcfg.transform=True requires GALT vectors")
    dev = blocks["mat_qkv_w"].device
    scales = (None, None)
    if qcfg.transform:
        scales = tuple(torch.as_tensor(g, dtype=torch.float32, device=dev)
                       for g in galt)
    qmat = None
    if qcfg.rotate:
        q = (H.block_hadamard_block(qcfg.rotation_block, qcfg.rotation_seed)
             if qcfg.block_rotate
             else H.random_hadamard_matrix(cfg.width, qcfg.rotation_seed))
        qmat = torch.as_tensor(q, dtype=torch.float32, device=dev)
    out = dict(blocks)
    with ieee_f32():
        for key, s in zip(_ROTATED_KEYS, scales):
            w = blocks[key].to(torch.float32)
            if s is not None:
                w = w / s[:, None, :]
            if qmat is not None and qcfg.block_rotate:
                d, o, i = w.shape
                n = qmat.shape[0]
                w = (w.reshape(d, o, i // n, n) @ qmat).reshape(d, o, i)
            elif qmat is not None:
                w = w @ qmat
            out[key] = w
    if qcfg.transform:
        out["mat_qkv_s"] = scales[0].to(blocks["mat_qkv_s"].dtype)
        out["fc1_s"] = scales[1].to(blocks["fc1_s"].dtype)
    return out


def _quantize_traced(rotated: dict, qcfg: QuantConfig, in_dtype) -> dict:
    """The quantize stage of :func:`transform_blocks_traced` over the
    output of :func:`_rotate_f32`: :func:`quantize_weights` on the float32
    rotated weights, fake-backend weights (and, with ``enabled=False``, the
    rotated ones) cast to ``in_dtype``, and the per-block ``ada_lin`` under
    ``quantize_ada``."""
    out = dict(rotated)
    if not qcfg.enabled:
        for key in _ROTATED_KEYS:
            out[key] = out[key].to(in_dtype)
        return out
    out = quantize_weights(out, qcfg)
    if qcfg.backend == "fake":
        for key in _WEIGHT_KEYS:
            out[key] = out[key].to(in_dtype)
    if qcfg.quantize_ada and "ada_lin" in out:
        out["ada_lin"] = {**out["ada_lin"],
                          "w": _fake_weight_quantizer(qcfg)(
                              out["ada_lin"]["w"])}
    return out


def transform_blocks_traced(blocks: dict, cfg: VARConfig, qcfg: QuantConfig,
                            galt: Optional[Tuple] = None) -> dict:
    """Fold -> rotate -> quantize over the stacked ``blocks`` on their own
    device, as the JAX package's ``transform_blocks_traced``.  The same
    pipeline as :func:`quantize_var_params` with JAX's two deviations:

    - the rotation runs in float32 on the device (TF32 off), not float64
      on the host, so a rotated weight may differ in its last bits where
      the float32 sums run in another order; :func:`quantize_var_params`
      stays the bit-parity surface for real checkpoints;
    - fake-backend weights come back in the input dtype (bf16 for
      :func:`synth_device_params`), not in float32.

    ``quantize_ada`` covers the per-block ``ada_lin`` only (d36-512's
    ``shared_ada_lin`` lies outside ``blocks``: the host path covers it)."""
    return _quantize_traced(_rotate_f32(blocks, cfg, qcfg, galt), qcfg,
                            blocks["mat_qkv_w"].dtype)


def synth_device_params(cfg: VARConfig, qcfg: QuantConfig, seed: int = 0,
                        galt: Optional[Tuple] = None, device="cuda") -> dict:
    """A seeded random VAR tree (``init_var_params`` in bf16) transformed
    by :func:`transform_blocks_traced`, built on ``device`` with no host
    round trip: for benchmarks and tools, not for real checkpoints.  Under
    the fake backend every float32 leaf is cast to bf16, as JAX does."""
    from fpqvar_tpu_torch.models.var import init_var_params

    p = init_var_params(cfg, seed=seed, device=device, dtype=torch.bfloat16)
    if not qcfg.enabled:
        return p
    p = dict(p)
    p["blocks"] = transform_blocks_traced(p["blocks"], cfg, qcfg, galt)
    if qcfg.backend == "fake":
        p = to_bf16(p)
    return p


def to_bf16(tree):
    """Every float32 tensor of a (dict) tree cast to bfloat16."""
    if isinstance(tree, dict):
        return {k: to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16)
    return tree
