"""QuantRuntime: the online half of a quantization recipe.

Resolves a :class:`QuantConfig` into what the block forward needs at run
time: per quantized layer kind the activation format (the ``int8`` backend
quantizes inside its GEMM call and needs the name) and the activation
quantizer (the ``fake`` and ``packed`` backends quantize, then dequantize,
before the matmul), the packed KV cache's codec and the ``attn_int8`` flag,
the 128x128 rotation block and the GALT flag.  The port covers the bf16
baseline, the ``int8`` backend (per-group weights and activations,
per-channel weights with per-token activations, and weights-only ``bf16``
activations), the ``fake`` and ``packed`` backends with grid and dual-grid
activation formats, and the packed KV cache (``kv_backend="packed"``) of
any grid format; every other combination raises.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, Optional

import torch

from fpqvar_tpu_torch.config import QuantConfig
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import hadamard as H
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quantizers as Q

#: the block linears the recipe quantizes
LAYER_KINDS = ("mat_qkv", "proj", "fc1", "fc2")


@dataclass(frozen=True)
class KVCodec:
    """The packed KV cache's codec: per-token absmax scaling onto a value
    grid, codes stored as int8 with one float32 scale per row of the last
    dim (a (token, head) row of ``head_dim`` values).

    ``encode(x [..., c])`` -> (codes int8 ``[..., c]``, scales f32
    ``[..., 1]``); ``decode(codes, scales)`` -> values in ``scales``'
    dtype.  For the formats of ``ops/packing.py`` ``CODE_MULT``
    (``value_codes``) a code is the grid value times a power of two, the
    scale absorbs the multiplier, and value = code * scale, so attention
    can run over the codes and fold the scales into the scores and the
    softmax weights; ``max_code`` is then the largest |code|.  Other grids
    store the grid index.  Every operation is per row, so a row's codes do
    not depend on the rows it is batched with."""

    fmt: str
    encode: Callable
    decode: Callable
    value_codes: bool
    max_code: Optional[int] = None


@lru_cache(maxsize=None)
def _grid_on(fmt: str, device: torch.device) -> torch.Tensor:
    """``fmt``'s grid as float32 on ``device``, copied there once."""
    with torch.inference_mode(False):
        return torch.tensor(G.GRIDS[fmt], dtype=torch.float32, device=device)


def make_kv_codec(fmt: str) -> KVCodec:
    """The codec of the JAX package's ``make_kv_codec``, with its jitted
    arithmetic: value codes through ``quant_int_codes`` with one group
    spanning the row; other grids scale by ``absmax * f32(1/gmax)`` (XLA's
    form of ``absmax / gmax`` under ``jit``), divide, and take the nearest
    grid index.

    A grid of more than 128 values (``fp8_e4m3``: 255) has indices past
    int8's range: the code keeps the index's low byte (``.to(int8)``, as
    JAX's ``astype``) and ``decode`` reads it back as a byte, 0..255.
    JAX's decode one-hot-encodes the signed code, so there every index
    above 127 decodes to 0 (ROADMAP.md, faults)."""
    grid = G.GRIDS[fmt]
    mult = P.CODE_MULT.get(fmt)
    if mult is not None:
        def encode(x):
            return P.quant_int_codes(x, fmt, group_size=x.shape[-1])

        def decode(codes, scales):
            return codes.to(scales.dtype) * scales

        return KVCodec(fmt, encode, decode, True,
                       round(float(abs(grid).max()) * mult))

    inv = Q.inv_max(grid)

    def encode(x):
        xf = x.to(torch.float32)
        scales = Q.safe_scale(xf.abs().amax(dim=-1, keepdim=True), inv)
        return P.encode_to_grid(xf / scales, grid).to(torch.int8), scales

    def decode(codes, scales):
        g = _grid_on(fmt, codes.device).to(scales.dtype)
        return g[codes.to(torch.long) & 0xFF] * scales

    return KVCodec(fmt, encode, decode, False)


@dataclass(frozen=True)
class QuantRuntime:
    #: layer kind -> activation quantizer (None: not quantized)
    act_q: Dict[str, Optional[Callable]] = field(default_factory=dict)
    #: layer kind -> activation format name (None: not quantized)
    act_fmts: Dict[str, Optional[str]] = field(default_factory=dict)
    #: the packed KV cache's codec (None: a dense cache)
    kv_codec: Optional[KVCodec] = None
    #: both attention products as integer contractions of int8 codes
    #: (``QuantConfig.attn_int8``; needs a value-codes ``kv_codec``)
    attn_int8: bool = False
    rotation_block: Optional[torch.Tensor] = None   # 128x128, float32
    transform: bool = False


def _unported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, modules still to port)")


def _build_kv(qcfg: QuantConfig) -> Optional[KVCodec]:
    """The KV codec of ``kv_bit`` with ``kv_backend="packed"`` (None
    without ``kv_bit``)."""
    if not qcfg.kv_bit:
        return None
    if qcfg.kv_backend != "packed":
        raise _unported("the fake KV quantizer (kv_backend='fake')")
    fmt = qcfg.resolved_kv_format()
    if fmt == "int_sym":
        raise NotImplementedError(
            "packed int KV not wired; use a grid kv_format")
    return make_kv_codec(fmt)


def _check_attn_int8(qcfg: QuantConfig, kv_codec) -> bool:
    if not qcfg.attn_int8:
        return False
    if kv_codec is None or not kv_codec.value_codes:
        raise ValueError(
            "attn_int8 requires kv_backend='packed' with an integer-value "
            "kv format (fp_e2 / fp6_e2m3)")
    return True


def build_runtime(qcfg: QuantConfig, device="cuda") -> QuantRuntime:
    kv_codec = _build_kv(qcfg)
    attn_int8 = _check_attn_int8(qcfg, kv_codec)
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
    return QuantRuntime(act_q=act_q, act_fmts=fmts, kv_codec=kv_codec,
                        attn_int8=attn_int8, rotation_block=rotation,
                        transform=qcfg.transform)
