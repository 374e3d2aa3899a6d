"""Checkpoint conversion and persistence.

Converts upstream FoundationVision-VAR torch checkpoints into the port's
stacked tree of tensors, and persists (possibly quantized) param trees as
npz archives, as the JAX package's ``utils/checkpoint.py`` does.  Tensors
keep torch layout (conv OIHW, linear (out, in)), so conversion is
transpose-free.

The npz layout is the JAX package's, so each package reads the other's
files: ``/``-joined keys, ``__empty_list`` / ``__empty_dict`` markers,
bfloat16 leaves as ``<key>/__bf16`` uint16 views, and quantized leaves as
``__intpack_*`` / ``__packed_*`` (codes, scales, meta) triplets in JAX's
layouts: ``IntPack`` codes ``[..., K, N]`` (the port keeps ``[..., N,
K]``) and ``PackedTensor`` scales ``[..., N, G]`` (the port keeps ``[...,
G, N]``); ``utils/bridge.py`` turns them back on load.
"""
from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from fpqvar_tpu_torch.config import VARConfig, VQVAEConfig
from fpqvar_tpu_torch.ops.packing import IntPack, PackedTensor
from fpqvar_tpu_torch.utils.bridge import to_torch, unflatten


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` -> {key: float32 CPU tensor}; a ``{"state_dict":
    ...}`` wrapper is unwrapped and entries that are not tensors are
    skipped.  Reads tensors only (``weights_only=True``)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.to(torch.float32) for k, v in sd.items()
            if isinstance(v, torch.Tensor)}


def _on(device):
    def put(v) -> torch.Tensor:
        return torch.as_tensor(v).to(device)
    return put


# ---------------------------------------------------------------------------
# VAR conversion
# ---------------------------------------------------------------------------

def convert_var_state_dict(sd: Dict[str, torch.Tensor], cfg: VARConfig,
                           device="cuda") -> dict:
    """Upstream VAR state dict (tensors or numpy arrays) -> the port's
    stacked params tree on ``device``."""
    d = cfg.depth
    put = _on(device)

    def stack(fmt: str) -> torch.Tensor:
        return torch.stack([put(sd[fmt.format(i=i)]) for i in range(d)])

    ones = torch.ones((d, cfg.width), dtype=torch.float32, device=device)
    blocks = {
        "mat_qkv_w": stack("blocks.{i}.attn.mat_qkv.weight"),
        "q_bias": stack("blocks.{i}.attn.q_bias"),
        "v_bias": stack("blocks.{i}.attn.v_bias"),
        "scale_mul": stack("blocks.{i}.attn.scale_mul_1H11"),
        "proj_w": stack("blocks.{i}.attn.proj.weight"),
        "proj_b": stack("blocks.{i}.attn.proj.bias"),
        "fc1_w": stack("blocks.{i}.ffn.fc1.weight"),
        "fc1_b": stack("blocks.{i}.ffn.fc1.bias"),
        "fc2_w": stack("blocks.{i}.ffn.fc2.weight"),
        "fc2_b": stack("blocks.{i}.ffn.fc2.bias"),
        "mat_qkv_s": ones,
        "fc1_s": ones.clone(),
    }
    if cfg.shared_aln:
        blocks["ada_gss"] = stack("blocks.{i}.ada_gss").reshape(
            d, 6, cfg.width)
    else:
        blocks["ada_lin"] = {"w": stack("blocks.{i}.ada_lin.1.weight"),
                             "b": stack("blocks.{i}.ada_lin.1.bias")}

    params = {
        "word_embed": {"w": put(sd["word_embed.weight"]),
                       "b": put(sd["word_embed.bias"])},
        "class_emb": put(sd["class_emb.weight"]),
        "pos_start": put(sd["pos_start"]),
        "pos_1LC": put(sd["pos_1LC"]),
        "lvl_embed": put(sd["lvl_embed.weight"]),
        "blocks": blocks,
        "head_nm": {"w": put(sd["head_nm.ada_lin.1.weight"]),
                    "b": put(sd["head_nm.ada_lin.1.bias"])},
        "head": {"w": put(sd["head.weight"]), "b": put(sd["head.bias"])},
    }
    if cfg.shared_aln:
        params["shared_ada_lin"] = {"w": put(sd["shared_ada_lin.1.weight"]),
                                    "b": put(sd["shared_ada_lin.1.bias"])}
    return params


def expected_var_keys(cfg: VARConfig) -> Tuple[str, ...]:
    """The torch keys the converter consumes (for validation and tests)."""
    keys = ["word_embed.weight", "word_embed.bias", "class_emb.weight",
            "pos_start", "pos_1LC", "lvl_embed.weight",
            "head_nm.ada_lin.1.weight", "head_nm.ada_lin.1.bias",
            "head.weight", "head.bias"]
    if cfg.shared_aln:
        keys += ["shared_ada_lin.1.weight", "shared_ada_lin.1.bias"]
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        keys += [p + "attn.mat_qkv.weight", p + "attn.q_bias",
                 p + "attn.v_bias", p + "attn.scale_mul_1H11",
                 p + "attn.proj.weight", p + "attn.proj.bias",
                 p + "ffn.fc1.weight", p + "ffn.fc1.bias",
                 p + "ffn.fc2.weight", p + "ffn.fc2.bias"]
        keys += [p + "ada_gss"] if cfg.shared_aln else [
            p + "ada_lin.1.weight", p + "ada_lin.1.bias"]
    return tuple(keys)


# ---------------------------------------------------------------------------
# VQVAE conversion
# ---------------------------------------------------------------------------

def convert_vqvae_state_dict(sd: Dict[str, torch.Tensor], cfg: VQVAEConfig,
                             device="cuda") -> dict:
    """Upstream VQVAE state dict -> the port's VQVAE tree on ``device``."""
    put = _on(device)
    nres = len(cfg.ch_mult)

    def conv(prefix):
        return {"w": put(sd[prefix + ".weight"]),
                "b": put(sd[prefix + ".bias"])}

    def resnet(p):
        out = {"norm1": conv(p + ".norm1"), "conv1": conv(p + ".conv1"),
               "norm2": conv(p + ".norm2"), "conv2": conv(p + ".conv2")}
        if p + ".nin_shortcut.weight" in sd:
            out["nin_shortcut"] = conv(p + ".nin_shortcut")
        return out

    def attn(p):
        return {"norm": conv(p + ".norm"), "qkv": conv(p + ".qkv"),
                "proj_out": conv(p + ".proj_out")}

    def mid(p):
        return {"block_1": resnet(p + ".block_1"),
                "attn_1": attn(p + ".attn_1"),
                "block_2": resnet(p + ".block_2")}

    def levels(side, n_blocks, resample):
        out = []
        for i in range(nres):
            pre = f"{side}.{i}"
            level = {"block": [], "attn": []}
            for j in range(n_blocks):
                level["block"].append(resnet(f"{pre}.block.{j}"))
                if f"{pre}.attn.{j}.norm.weight" in sd:
                    level["attn"].append(attn(f"{pre}.attn.{j}"))
            if f"{pre}.{resample}.conv.weight" in sd:
                level[resample] = conv(f"{pre}.{resample}.conv")
            out.append(level)
        return out

    enc = {"conv_in": conv("encoder.conv_in"),
           "down": levels("encoder.down", cfg.num_res_blocks, "downsample"),
           "mid": mid("encoder.mid"),
           "norm_out": conv("encoder.norm_out"),
           "conv_out": conv("encoder.conv_out")}
    dec = {"conv_in": conv("decoder.conv_in"),
           "mid": mid("decoder.mid"),
           "up": levels("decoder.up", cfg.num_res_blocks + 1, "upsample"),
           "norm_out": conv("decoder.norm_out"),
           "conv_out": conv("decoder.conv_out")}

    # PhiPartiallyShared (share_quant_resi=4) -> quant_resi.qresi_ls.{k};
    # PhiShared -> quant_resi.qresi; PhiNonShared -> quant_resi.{k}
    phi = []
    for k in range(64):
        for pat in (f"quantize.quant_resi.qresi_ls.{k}",
                    f"quantize.quant_resi.{k}",
                    "quantize.quant_resi.qresi" if k == 0 else None):
            if pat and pat + ".weight" in sd:
                phi.append(conv(pat))
                break
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": conv("quant_conv"),
        "post_quant_conv": conv("post_quant_conv"),
        "quantize": {"embedding": put(sd["quantize.embedding.weight"]),
                     "phi": phi},
    }


# ---------------------------------------------------------------------------
# Persistence (npz, the JAX package's layout)
# ---------------------------------------------------------------------------

def _host(t) -> np.ndarray:
    """A tensor (or array) as numpy; bfloat16 as its uint16 bits."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(t)


def _meta(**fields) -> np.ndarray:
    return np.frombuffer(json.dumps(fields).encode(), np.uint8)


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        if not tree:
            # empty containers must survive the round trip: VQVAE levels
            # carry empty 'attn' lists and the forwards index them
            out[prefix + "__empty_dict"] = np.zeros((0,), np.uint8)
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[prefix + "__empty_list"] = np.zeros((0,), np.uint8)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, PackedTensor):
        sc_bf16 = tree.scales.dtype == torch.bfloat16
        out[prefix + "__packed_codes"] = _host(tree.codes)
        out[prefix + "__packed_scales"] = _host(tree.scales.transpose(-1, -2))
        out[prefix + "__packed_meta"] = _meta(
            fmt=tree.fmt, shape=list(tree.shape), group_size=tree.group_size,
            nibble_packed=tree.nibble_packed, scales_bf16=sc_bf16)
    elif isinstance(tree, IntPack):
        sc_bf16 = tree.scales.dtype == torch.bfloat16
        out[prefix + "__intpack_codes"] = _host(tree.codes.transpose(-1, -2))
        out[prefix + "__intpack_scales"] = _host(tree.scales)
        out[prefix + "__intpack_meta"] = _meta(
            fmt=tree.fmt, shape=list(tree.shape), group_size=tree.group_size,
            scales_bf16=sc_bf16)
    elif isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        # npz cannot name bfloat16: a tagged uint16 view, as JAX writes it
        out[prefix.rstrip("/") + "/__bf16"] = _host(tree)
    else:
        out[prefix.rstrip("/")] = _host(tree)
    return out


def save_params(path: str, tree, compress: bool = False) -> None:
    """The tree as an npz archive in the JAX package's layout.
    Uncompressed by default: bf16/f32 weights and int8 codes are
    near-incompressible and zlib runs ~10 MB/s on one core;
    ``compress=True`` writes ``np.savez_compressed`` for archives where
    disk size wins."""
    (np.savez_compressed if compress else np.savez)(path, **_flatten(tree))


def load_params(path: str, device="cuda") -> dict:
    """An npz archive of :func:`save_params` (this package's or the JAX
    package's) as the port's tree on ``device``.  bfloat16 leaves (and
    bfloat16 scales) come back as ``torch.bfloat16`` with their bits."""
    with np.load(path, allow_pickle=False) as f:
        flat = dict(f)
    return to_torch(unflatten(flat, keep_bf16=True), device)
