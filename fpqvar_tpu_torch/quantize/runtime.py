"""QuantRuntime: the online half of a quantization recipe.

Resolves a :class:`QuantConfig` into what the block forward needs at run
time, as the JAX package's ``quantize/runtime.py``: per quantized layer
kind the activation format (the ``int8`` backend quantizes inside its GEMM
call and needs the name) and the activation quantizer (the ``fake`` and
``packed`` backends quantize, then dequantize, before the matmul; the pure
INT recipe, log2 at fc2, and ``"ada"``, SiLU(cond) under
``quantize_ada``), one quantizer dict per distinct block format under
mixed formats, the KV cache's fake quantizer (``kv_backend="fake"``) or
packed codec (``"packed"``) and the ``attn_int8`` flag, the 128x128
rotation block or the full-size rotation, and the GALT flag.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from functools import lru_cache, partial
from typing import Callable, Dict, Optional, Tuple

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
    #: layer kind -> activation quantizer (None: not quantized); "ada" is
    #: SiLU(cond)'s under ``quantize_ada``
    act_q: Dict[str, Optional[Callable]] = field(default_factory=dict)
    #: layer kind -> activation format name (None: not quantized)
    act_fmts: Dict[str, Optional[str]] = field(default_factory=dict)
    #: mixed formats: one ``act_q`` per distinct block format, and each
    #: block's index into them
    mixed_act_q: Optional[Tuple[Dict[str, Optional[Callable]], ...]] = None
    mixed_idx: Optional[Tuple[int, ...]] = None
    #: the dense KV cache's fake quantizer (None: not quantized)
    kv_q: Optional[Callable] = None
    #: "store": quantize once on append; "reference": re-quantize the whole
    #: cached prefix every scale step before appending raw rows
    kv_mode: str = "store"
    #: the packed KV cache's codec (None: a dense cache)
    kv_codec: Optional[KVCodec] = None
    #: both attention products as integer contractions of int8 codes
    #: (``QuantConfig.attn_int8``; needs a value-codes ``kv_codec``)
    attn_int8: bool = False
    rotation_block: Optional[torch.Tensor] = None   # 128x128, float32
    rotation_full: Optional[torch.Tensor] = None    # C x C, float32
    transform: bool = False
    #: the ``parallel.Mesh`` of a distributed run: the block linears, the
    #: head and attention run tensor-parallel on this rank's shards
    mesh: Optional[object] = None

    def for_block(self, i: int) -> "QuantRuntime":
        """The runtime of block ``i`` under mixed formats."""
        return self.for_variant(self.mixed_idx[i])

    def for_variant(self, v: int) -> "QuantRuntime":
        """The runtime with variant ``v``'s activation quantizers."""
        if self.mixed_act_q is None:
            raise ValueError("not a mixed-format runtime")
        return dataclasses.replace(self, act_q=self.mixed_act_q[v],
                                   mixed_act_q=None, mixed_idx=None)


def _act_quantizer_for(qcfg: QuantConfig, fmt_name: str, kind: str):
    """One activation quantizer, as JAX's ``_act_quantizer_for``: under
    ``int_quant`` (or an INT / log2 format name) log2 where asked
    (``fc2_log2`` at fc2), else ``int_sym`` with ``act_sym`` and
    ``int_asym`` without it; fc2 is always asymmetric."""
    gran = qcfg.act_quant
    if qcfg.int_quant or fmt_name in ("int_sym", "int_asym", "log2"):
        if fmt_name == "log2" or (kind == "fc2" and qcfg.fc2_log2):
            fmt = "log2"
        else:
            sym = qcfg.act_sym and kind != "fc2"
            fmt = "int_sym" if sym else "int_asym"
        return Q.make_act_quantizer(fmt, qcfg.a_bit, granularity=gran,
                                    group_size=qcfg.group_size)
    return Q.make_act_quantizer(fmt_name, qcfg.a_bit, granularity=gran,
                                group_size=qcfg.group_size)


def _ada_act_quantizer(qcfg: QuantConfig):
    """The per-token quantizer of SiLU(cond) before ``ada_lin`` /
    ``shared_ada_lin`` (``quantize_ada``), in ``resolved_ada_format()``
    (INT under ``int_quant``)."""
    fmt = qcfg.resolved_ada_format()
    if qcfg.int_quant or fmt in ("int_sym", "int_asym", "log2"):
        fmt = "int_sym" if qcfg.act_sym else "int_asym"
    return Q.make_act_quantizer(fmt, qcfg.a_bit, granularity="per_token",
                                group_size=qcfg.group_size)


def _build_kv(qcfg: QuantConfig):
    """(kv_q, kv_codec): the fake quantizer of a dense cache
    (``kv_backend="fake"``) or the packed cache's codec, for any backend;
    both None without ``kv_bit``."""
    if not qcfg.kv_bit:
        return None, None
    if qcfg.kv_backend == "packed":
        fmt = qcfg.resolved_kv_format()
        if fmt == "int_sym":
            raise NotImplementedError(
                "packed int KV not wired; use a grid kv_format")
        return None, make_kv_codec(fmt)
    return partial(Q.fake_quant_kv, qcfg=qcfg), None


def _check_attn_int8(qcfg: QuantConfig, kv_codec) -> bool:
    if not qcfg.attn_int8:
        return False
    if kv_codec is None or not kv_codec.value_codes:
        raise ValueError(
            "attn_int8 requires kv_backend='packed' with an integer-value "
            "kv format (fp_e2 / fp6_e2m3)")
    return True


def _check_int8(qcfg: QuantConfig, fmts: Dict[str, Optional[str]]) -> None:
    """The ``int8`` backend's limits, as JAX's: per-group or per-token fp
    activations, per-token paired with per-channel weights, no mixed
    formats, integer-value (or weights-only ``bf16``) activation formats."""
    if qcfg.int_quant or qcfg.act_quant not in ("per_group", "per_token"):
        raise ValueError(
            "int8 backend requires per-group or per-token fp act "
            "quantization")
    if ((qcfg.act_quant == "per_token")
            != (qcfg.weight_quant == "per_channel")):
        raise ValueError(
            "int8 backend: per-token acts pair with per-channel "
            "weights (the int8ch full-K path): set both or neither")
    if qcfg.mixed_act_formats is not None:
        raise ValueError("int8 backend does not support mixed_act_formats")
    for k, f in fmts.items():
        # "bf16" = weights only (w4a16): the activation is not quantized
        # (ops/int8_matmul.py wonly_dot)
        if (f != "bf16" and f not in P.CODE_MULT
                and f not in P.DUAL_CODE_MULT):
            raise ValueError(
                f"int8 backend: unsupported act format {f!r} ({k})")


def _rotations(qcfg: QuantConfig, width: Optional[int], device):
    """(128x128 block, full C x C) rotation as float32 on ``device``; at
    most one is set."""
    if not qcfg.rotate:
        return None, None
    if qcfg.block_rotate:
        h = H.block_hadamard_block(qcfg.rotation_block, qcfg.rotation_seed)
        return torch.tensor(h, dtype=torch.float32, device=device), None
    if width is None:
        raise ValueError("width required for full-size rotation")
    h = H.random_hadamard_matrix(width, qcfg.rotation_seed)
    return None, torch.tensor(h, dtype=torch.float32, device=device)


def build_runtime(qcfg: QuantConfig, depth: Optional[int] = None,
                  width: Optional[int] = None, device="cuda") -> QuantRuntime:
    """Resolve ``qcfg`` into run-time callables and tensors (on
    ``device``).  ``width`` is required for a full-size rotation and
    ``depth`` for mixed formats."""
    rotation, rotation_full = _rotations(qcfg, width, device)
    kv_q, kv_codec = _build_kv(qcfg)
    fmts: Dict[str, Optional[str]] = {k: None for k in LAYER_KINDS}
    act_q: Dict[str, Optional[Callable]] = {k: None for k in LAYER_KINDS}
    mixed = mixed_idx = None
    if qcfg.enabled:
        if qcfg.int_quant:
            fmts = {k: "int" for k in LAYER_KINDS}
        else:
            fmts = {k: qcfg.act_format for k in ("mat_qkv", "proj", "fc1")}
            fmts["fc2"] = qcfg.fc2_format
        if qcfg.backend == "int8":
            # the activation is quantized inside the GEMM call (codes and
            # scales, no dequantized intermediate): see ops/int8_matmul.py
            _check_int8(qcfg, fmts)
        elif qcfg.backend in ("fake", "packed"):
            # "bf16" act format = no activation quantizer (weights-only)
            act_q = {k: None if f == "bf16" else _act_quantizer_for(
                         qcfg, f, k) for k, f in fmts.items()}
        else:
            raise ValueError(f"unknown backend {qcfg.backend!r}")
        if qcfg.quantize_ada:
            # SiLU(cond) is quantized on the fake path under every backend:
            # the modulations are computed once per generation
            act_q["ada"] = _ada_act_quantizer(qcfg)
        if qcfg.mixed_act_formats is not None:     # int8 refused it above
            mixed, mixed_idx = _mixed(qcfg, act_q, depth)
    return QuantRuntime(act_q=act_q, act_fmts=fmts, mixed_act_q=mixed,
                        mixed_idx=mixed_idx, kv_q=kv_q, kv_mode=qcfg.kv_mode,
                        kv_codec=kv_codec,
                        attn_int8=_check_attn_int8(qcfg, kv_codec),
                        rotation_block=rotation, rotation_full=rotation_full,
                        transform=qcfg.transform)


def _mixed(qcfg: QuantConfig, act_q: dict, depth: Optional[int]):
    """Mixed formats: one ``act_q`` per distinct block format (its format
    at mat_qkv, proj and fc1; the rest shared) and each block's index."""
    if depth is None:
        raise ValueError("depth required for mixed-format configs")
    if len(qcfg.mixed_act_formats) != depth:
        raise ValueError("mixed_act_formats must have one entry per block")
    distinct = list(dict.fromkeys(qcfg.mixed_act_formats))
    variants = []
    for bfmt in distinct:
        d = dict(act_q)
        for k in ("mat_qkv", "proj", "fc1"):
            d[k] = _act_quantizer_for(qcfg, bfmt, k)
        variants.append(d)
    return (tuple(variants),
            tuple(distinct.index(f) for f in qcfg.mixed_act_formats))
