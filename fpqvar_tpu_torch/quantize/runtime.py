"""QuantRuntime: the online half of a quantization recipe.

Resolves a :class:`QuantConfig` into what the block forward needs at run
time: per quantized layer kind the activation format (the ``int8`` backend
quantizes inside its GEMM call and needs the name) and the activation
quantizer (the ``fake`` and ``packed`` backends quantize, then dequantize,
before the matmul), the 128x128 rotation block and the GALT flag.  The port
covers the bf16 baseline, the ``int8`` backend (per-group weights and
activations, per-channel weights with per-token activations, and
weights-only ``bf16`` activations), and the ``fake`` and ``packed``
backends with grid and dual-grid activation formats; every other
combination raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch

from fpqvar_tpu_torch.config import QuantConfig
from fpqvar_tpu_torch.ops import hadamard as H
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quantizers as Q

#: the block linears the recipe quantizes
LAYER_KINDS = ("mat_qkv", "proj", "fc1", "fc2")


@dataclass(frozen=True)
class QuantRuntime:
    #: layer kind -> activation quantizer (None: not quantized)
    act_q: Dict[str, Optional[Callable]] = field(default_factory=dict)
    #: layer kind -> activation format name (None: not quantized)
    act_fmts: Dict[str, Optional[str]] = field(default_factory=dict)
    rotation_block: Optional[torch.Tensor] = None   # 128x128, float32
    transform: bool = False


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, modules still to port)")


def build_runtime(qcfg: QuantConfig, device="cuda") -> QuantRuntime:
    if qcfg.kv_bit or qcfg.attn_int8:
        raise _unported("KV-cache quantization (kv_bit, attn_int8)")
    if qcfg.fc2_log2:
        raise _unported("the log2 fc2 baseline (fc2_log2)")
    if qcfg.quantize_ada:
        raise _unported("quantize_ada")
    if qcfg.mixed_act_formats is not None:
        raise _unported("mixed_act_formats")
    if qcfg.int_quant:
        raise _unported("the pure INT recipe (int_quant)")
    rotation = None
    if qcfg.rotate:
        if not qcfg.block_rotate:
            raise _unported("full-size rotation (block_rotate=False)")
        rotation = torch.tensor(
            H.block_hadamard_block(qcfg.rotation_block, qcfg.rotation_seed),
            dtype=torch.float32, device=device)
    fmts: Dict[str, Optional[str]] = {k: None for k in LAYER_KINDS}
    act_q: Dict[str, Optional[Callable]] = {k: None for k in LAYER_KINDS}
    if qcfg.enabled:
        fmts = {k: qcfg.act_format for k in ("mat_qkv", "proj", "fc1")}
        fmts["fc2"] = qcfg.fc2_format
        if qcfg.backend == "int8":
            # the activation is quantized inside the GEMM call (codes and
            # scales, no dequantized intermediate): see ops/int8_matmul.py
            if qcfg.act_quant not in ("per_group", "per_token"):
                raise ValueError(
                    "int8 backend requires per-group or per-token fp act "
                    "quantization")
            if ((qcfg.act_quant == "per_token")
                    != (qcfg.weight_quant == "per_channel")):
                raise ValueError(
                    "int8 backend: per-token acts pair with per-channel "
                    "weights (the int8ch full-K path): set both or neither")
            for k, f in fmts.items():
                # "bf16" = weights only (w4a16): the activation is not
                # quantized (ops/int8_matmul.py wonly_dot)
                if (f != "bf16" and f not in P.CODE_MULT
                        and f not in P.DUAL_CODE_MULT):
                    raise ValueError(
                        f"int8 backend: unsupported act format {f!r} ({k})")
        elif qcfg.backend in ("fake", "packed"):
            # "bf16" act format = no activation quantizer (weights-only)
            act_q = {k: None if f == "bf16" else Q.make_act_quantizer(
                         f, qcfg.a_bit, granularity=qcfg.act_quant,
                         group_size=qcfg.group_size)
                     for k, f in fmts.items()}
        else:
            raise _unported(f"the {qcfg.backend!r} backend")
    return QuantRuntime(act_q=act_q, act_fmts=fmts, rotation_block=rotation,
                        transform=qcfg.transform)
