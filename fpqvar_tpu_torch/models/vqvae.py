"""Multi-scale VQVAE tokenizer, decode side.

Plain functions over a params tree in torch layout (convs OIHW, data NCHW),
the same tree as the JAX package's ``models/vqvae.py``: the decoder, the
residual-pyramid step of generation and ``decode``.  The encoder and the
tokenization paths come with a later slice.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fpqvar_tpu_torch.config import VQVAEConfig
from fpqvar_tpu_torch.ops.resize import resize2d


def conv2d(x: torch.Tensor, p, stride: int = 1, padding: int = 1):
    b = p["b"].to(x.dtype) if "b" in p else None
    return F.conv2d(x, p["w"].to(x.dtype), b, stride=stride, padding=padding)


def group_norm(x: torch.Tensor, p, num_groups: int = 32, eps: float = 1e-6):
    num_groups = min(num_groups, x.shape[1])
    y = F.group_norm(x.to(torch.float32), num_groups, p["w"].to(torch.float32),
                     p["b"].to(torch.float32), eps=eps)
    return y.to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def resnet_block(x: torch.Tensor, p) -> torch.Tensor:
    h = conv2d(swish(group_norm(x, p["norm1"])), p["conv1"])
    h = conv2d(swish(group_norm(h, p["norm2"])), p["conv2"])
    if "nin_shortcut" in p:
        x = conv2d(x, p["nin_shortcut"], padding=0)
    return x + h


def attn_block(x: torch.Tensor, p) -> torch.Tensor:
    """Single-head attention over the H*W positions."""
    b, c, h, w = x.shape
    qkv = conv2d(group_norm(x, p["norm"]), p["qkv"], padding=0)
    q, k, v = torch.split(qkv.reshape(b, 3 * c, h * w), c, dim=1)
    att = torch.einsum("bci,bcj->bij", q, k) * (c ** -0.5)
    att = torch.softmax(att.to(torch.float32), dim=2).to(x.dtype)
    out = torch.einsum("bci,bij->bcj", v, att).reshape(b, c, h, w)
    return x + conv2d(out, p["proj_out"], padding=0)


def upsample2x(x: torch.Tensor, p) -> torch.Tensor:
    x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return conv2d(x, p)


def decoder_forward(params, cfg: VQVAEConfig, z: torch.Tensor) -> torch.Tensor:
    nres = len(cfg.ch_mult)
    h = conv2d(z, params["conv_in"])
    h = resnet_block(h, params["mid"]["block_1"])
    h = attn_block(h, params["mid"]["attn_1"])
    h = resnet_block(h, params["mid"]["block_2"])
    for i in reversed(range(nres)):
        level = params["up"][i]
        for j, blk in enumerate(level["block"]):
            h = resnet_block(h, blk)
            if level["attn"]:
                h = attn_block(h, level["attn"][j])
        if i != 0:
            h = upsample2x(h, level["upsample"])
    return conv2d(swish(group_norm(h, params["norm_out"])), params["conv_out"])


def phi_index(si: int, num_scales: int, share: int) -> int:
    """Which of the ``share`` partially shared phi convs scale ``si`` uses."""
    at = si / (num_scales - 1)
    k = share
    ticks = (np.linspace(1 / 3 / k, 1 - 1 / 3 / k, k) if k == 4
             else np.linspace(1 / 2 / k, 1 - 1 / 2 / k, k))
    return int(np.argmin(np.abs(ticks - at)))


def phi_conv(x: torch.Tensor, p, quant_resi: float = 0.5) -> torch.Tensor:
    """phi(x) = (1-r) x + r conv3x3(x)."""
    r = abs(quant_resi)
    return x * (1.0 - r) + conv2d(x, p) * r


def embed_idx(qparams, idx: torch.Tensor) -> torch.Tensor:
    """Codebook lookup: idx [...] -> [..., Cvae]."""
    return qparams["embedding"][idx]


def get_next_autoregressive_input(
    qparams, cfg: VQVAEConfig, si: int, f_hat: torch.Tensor,
    h_BChw: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One residual-pyramid step: below the last scale, upsample ``h``
    bicubic to full resolution, phi-conv it, add it into ``f_hat`` and
    return (f_hat, f_hat area-downsampled to the next scale); at the last
    scale phi-conv at full resolution and return (f_hat, f_hat)."""
    pns = cfg.patch_nums
    sn = len(pns)
    hw = pns[-1]
    phi_p = qparams["phi"][phi_index(si, sn, cfg.share_quant_resi)]
    if si != sn - 1:
        h = phi_conv(resize2d(h_BChw, (hw, hw), "bicubic"), phi_p,
                     cfg.quant_resi)
        f_hat = f_hat + h
        return f_hat, resize2d(f_hat, (pns[si + 1], pns[si + 1]), "area")
    f_hat = f_hat + phi_conv(h_BChw, phi_p, cfg.quant_resi)
    return f_hat, f_hat


def decode(params, cfg: VQVAEConfig, f_hat: torch.Tensor) -> torch.Tensor:
    """f_hat -> images in [-1, 1]."""
    z = conv2d(f_hat, params["post_quant_conv"])
    return torch.clamp(decoder_forward(params["decoder"], cfg, z), -1.0, 1.0)


# ---------------------------------------------------------------------------
# Initialization (random weights from a torch.Generator)
# ---------------------------------------------------------------------------

def _conv_init(gen, device, o, i, k):
    std = 1.0 / math.sqrt(i * k * k)

    def u(shape):
        r = torch.rand(shape, generator=gen, device=device)
        return (r * 2.0 - 1.0) * std

    return {"w": u((o, i, k, k)), "b": u((o,))}


def _gn_init(device, c):
    return {"w": torch.ones(c, device=device),
            "b": torch.zeros(c, device=device)}


def _resnet_init(gen, device, cin, cout):
    p = {
        "norm1": _gn_init(device, cin),
        "conv1": _conv_init(gen, device, cout, cin, 3),
        "norm2": _gn_init(device, cout),
        "conv2": _conv_init(gen, device, cout, cout, 3),
    }
    if cin != cout:
        p["nin_shortcut"] = _conv_init(gen, device, cout, cin, 1)
    return p


def _attn_init(gen, device, c):
    return {
        "norm": _gn_init(device, c),
        "qkv": _conv_init(gen, device, 3 * c, c, 1),
        "proj_out": _conv_init(gen, device, c, c, 1),
    }


def init_vqvae_params(cfg: VQVAEConfig, seed: int = 0, device="cuda"):
    """Random decoder, quantizer and post-quant conv, in the JAX package's
    tree layout (uniform +-1/sqrt(fan_in) convs, N(0, 0.02) codebook)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    nres = len(cfg.ch_mult)
    ch = cfg.ch
    cmid = ch * cfg.ch_mult[-1]
    dec = {"conv_in": _conv_init(gen, device, cmid, cfg.z_channels, 3)}
    dec["mid"] = {
        "block_1": _resnet_init(gen, device, cmid, cmid),
        "attn_1": _attn_init(gen, device, cmid),
        "block_2": _resnet_init(gen, device, cmid, cmid),
    }
    up = [None] * nres
    block_in = cmid
    for i in reversed(range(nres)):
        cout = ch * cfg.ch_mult[i]
        level = {"block": [], "attn": []}
        for _ in range(cfg.num_res_blocks + 1):
            level["block"].append(_resnet_init(gen, device, block_in, cout))
            block_in = cout
            if i == nres - 1:
                level["attn"].append(_attn_init(gen, device, cout))
        if i != 0:
            level["upsample"] = _conv_init(gen, device, cout, cout, 3)
        up[i] = level
    dec["up"] = up
    dec["norm_out"] = _gn_init(device, block_in)
    dec["conv_out"] = _conv_init(gen, device, 3, block_in, 3)
    quant = {
        "embedding": torch.randn((cfg.vocab_size, cfg.z_channels),
                                 generator=gen, device=device) * 0.02,
        "phi": [_conv_init(gen, device, cfg.z_channels, cfg.z_channels, 3)
                for _ in range(cfg.share_quant_resi)],
    }
    return {
        "decoder": dec,
        "post_quant_conv": _conv_init(gen, device, cfg.z_channels,
                                      cfg.z_channels, 3),
        "quantize": quant,
    }
