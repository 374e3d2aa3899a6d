"""Typed configuration of the PyTorch port.

A copy of the model, recipe and sampling dataclasses of the JAX package's
``fpqvar_tpu/config.py`` (the port imports nothing of that package), cut to
what the port runs: the VAR/VQVAE shapes, the quantization recipes, and the
execution modes of :func:`bench_recipes`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

PATCH_NUMS_256 = (1, 2, 3, 4, 5, 6, 8, 10, 13, 16)


@dataclass(frozen=True)
class VQVAEConfig:
    """Multi-scale VQVAE tokenizer."""

    vocab_size: int = 4096
    z_channels: int = 32
    ch: int = 160
    ch_mult: Tuple[int, ...] = (1, 1, 2, 2, 4)
    num_res_blocks: int = 2
    quant_resi: float = 0.5
    share_quant_resi: int = 4
    patch_nums: Tuple[int, ...] = PATCH_NUMS_256
    using_znorm: bool = False

    @property
    def downsample(self) -> int:
        return 2 ** (len(self.ch_mult) - 1)


@dataclass(frozen=True)
class VARConfig:
    """VAR transformer (width = depth*64, heads = depth unless overridden)."""

    depth: int = 16
    num_classes: int = 1000
    shared_aln: bool = False
    attn_l2_norm: bool = True
    norm_eps: float = 1e-6
    mlp_ratio: float = 4.0
    cond_drop_rate: float = 0.1
    patch_nums: Tuple[int, ...] = PATCH_NUMS_256
    vae: VQVAEConfig = VQVAEConfig()
    embed_dim: Optional[int] = None
    num_heads: Optional[int] = None

    @property
    def width(self) -> int:
        return self.embed_dim if self.embed_dim is not None else self.depth * 64

    @property
    def heads(self) -> int:
        return self.num_heads if self.num_heads is not None else self.depth

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def L(self) -> int:
        return sum(pn * pn for pn in self.patch_nums)

    @property
    def first_l(self) -> int:
        return self.patch_nums[0] ** 2

    @property
    def num_scales(self) -> int:
        return len(self.patch_nums)


def var_d16() -> VARConfig:
    return VARConfig(depth=16)


def var_tiny() -> VARConfig:
    """Test shape: depth 2, width 128, 3 scales, 6x6 images."""
    return VARConfig(
        depth=2, embed_dim=128, num_heads=2, patch_nums=(1, 2, 3),
        vae=VQVAEConfig(vocab_size=64, z_channels=8, ch=16,
                        ch_mult=(1, 2), num_res_blocks=1,
                        patch_nums=(1, 2, 3)),
    )


@dataclass(frozen=True)
class QuantConfig:
    """One quantization recipe.  ``enabled=False`` is the bf16 baseline."""

    enabled: bool = False
    w_bit: int = 4
    a_bit: int = 4
    kv_bit: int = 0
    group_size: int = 128

    weight_quant: str = "per_group"
    act_quant: str = "per_group"
    act_sym: bool = False
    weight_format: str = "fp_e2"
    act_format: str = "fp_e2"
    fc2_format: str = "fp_e1m2_neg_e2m1_pos"
    fc2_log2: bool = False
    int_quant: bool = False

    kv_format: str = "auto"
    kv_mode: str = "store"
    kv_backend: str = "fake"
    kv_ref_grouping: bool = False
    attn_int8: bool = False

    rotate: bool = False
    block_rotate: bool = True
    rotation_block: int = 128
    rotation_seed: int = 42
    transform: bool = False

    backend: str = "fake"
    mixed_act_formats: Optional[Tuple[str, ...]] = None
    quantize_ada: bool = False
    ada_format: str = "auto"

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


def fpqvar_w4a4() -> QuantConfig:
    """The paper's full FP4 recipe."""
    return QuantConfig(
        enabled=True, w_bit=4, a_bit=4, kv_bit=0,
        weight_quant="per_group", act_quant="per_group",
        weight_format="fp_e2", act_format="fp_e2",
        fc2_format="fp_e1m2_neg_e2m1_pos",
        rotate=True, block_rotate=True, transform=True,
    )


def fpqvar_w4a16() -> QuantConfig:
    """Weights-only FP4: per-channel fp_e2 int8 weight codes, activations
    unquantized (``bf16`` act format), no rotation or GALT.  Every block
    linear is one product of the bf16-rounded activation and the codes,
    rescaled per output channel (``ops/int8_matmul.py`` ``wonly_dot``);
    ``w4a16p`` is the same recipe with packed per-group codes."""
    return QuantConfig(
        enabled=True, w_bit=4, a_bit=16, kv_bit=0,
        weight_quant="per_channel", act_quant="per_token",
        weight_format="fp_e2", act_format="bf16", fc2_format="bf16",
        backend="int8",
    )


def fpqvar_w6a6() -> QuantConfig:
    """FP6 e2m3 weights and activations, integer-negative / e2m3-positive
    dual grid at fc2, with rotation and GALT."""
    return QuantConfig(
        enabled=True, w_bit=6, a_bit=6, kv_bit=0,
        weight_quant="per_group", act_quant="per_group",
        weight_format="fp6_e2m3", act_format="fp6_e2m3",
        fc2_format="fp6_int_neg_e2m3_pos",
        rotate=True, block_rotate=True, transform=True,
    )


def bench_recipes() -> dict:
    """The execution modes the port runs so far (the JAX package's
    ``bench_recipes`` also has ``int8kv`` and ``int8att``; they come with a
    later slice):

      bf16      unquantized baseline
      fake      the paper's W4A4 recipe as exact fp4 values: activations
                fake-quantized, weights dequantized, dense matmuls
      int8      the W4A4 recipe with grouped-128 int8 codes on both sides:
                qkv, proj and fc1 through the grouped int8 GEMM over
                [B, T, K] that writes the activation's dtype (K5), the
                dual-grid fc2 as two f32 grouped GEMMs (K1)
      int8ch    the W4A4 recipe with per-channel weight and per-token
                activation scales: qkv, proj and fc1 through the
                quantize-in-kernel full-K GEMM (K4), the dual-grid fc2 as
                two full-K GEMMs on its codes (K3)
      int8chs   int8ch with a single-grid fp_e2 fc2: every block linear
                through K4
      int8chsnr int8chs without rotation and GALT (a diagnostic)
      packed    the W4A4 recipe with nibble-packed fp4 weight codes: fake-
                quantized activations through the dequantize-in-register
                GEMM (K2)
      w4a16     weights-only per-channel int8 codes, activations
                unquantized (``wonly_dot``, no kernel)
      w4a16p    weights-only nibble-packed fp4 codes through K2, activations
                unquantized
    """
    base = fpqvar_w4a4()
    return {
        "bf16": QuantConfig(),
        "fake": base,
        "int8": base.replace(backend="int8"),
        "int8ch": base.replace(backend="int8", weight_quant="per_channel",
                               act_quant="per_token"),
        "int8chs": base.replace(backend="int8", weight_quant="per_channel",
                                act_quant="per_token", fc2_format="fp_e2"),
        "int8chsnr": base.replace(backend="int8",
                                  weight_quant="per_channel",
                                  act_quant="per_token", fc2_format="fp_e2",
                                  rotate=False, transform=False),
        "packed": base.replace(backend="packed"),
        "w4a16": fpqvar_w4a16(),
        "w4a16p": fpqvar_w4a16().replace(backend="packed",
                                         weight_quant="per_group"),
    }


@dataclass(frozen=True)
class GenerateConfig:
    """Sampling parameters."""

    cfg: float = 1.5
    top_k: int = 900
    top_p: float = 0.96
    more_smooth: bool = False
    seed: int = 0
