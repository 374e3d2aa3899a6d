"""Multi-scale VQVAE tokenizer.

Plain functions over a params tree in torch layout (convs OIHW, data NCHW),
the same tree as the JAX package's ``models/vqvae.py``: the encoder and
the multi-scale tokenization (``img_to_idxBl``, ``f_to_idxBl``), the
teacher-forcing input of training (``idxBl_to_var_input``), the decoder,
the residual-pyramid step of generation and ``decode``.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fpqvar_tpu_torch.config import VQVAEConfig
from fpqvar_tpu_torch.ops.precision import conv2d_plain
from fpqvar_tpu_torch.ops.resize import resize2d, upsample2x_nearest


def conv2d(x: torch.Tensor, p, stride: int = 1, padding: int = 1):
    """A convolution in ``x``'s dtype; float32 stays float32 (no TF32) on a
    card whatever the process's flags say, through PyTorch's own
    convolution rather than cuDNN (``ops/precision.py``
    ``conv2d_plain``)."""
    b = p["b"].to(x.dtype) if "b" in p else None
    return conv2d_plain(x, p["w"].to(x.dtype), b, stride=stride,
                        padding=padding)


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


def downsample2x(x: torch.Tensor, p) -> torch.Tensor:
    """Pad the right and bottom by one, then a stride-2 3x3 conv."""
    return conv2d(F.pad(x, (0, 1, 0, 1)), p, stride=2, padding=0)


def upsample2x(x: torch.Tensor, p) -> torch.Tensor:
    return conv2d(upsample2x_nearest(x), p)


def encoder_forward(params, cfg: VQVAEConfig, x: torch.Tensor) -> torch.Tensor:
    nres = len(cfg.ch_mult)
    h = conv2d(x, params["conv_in"])
    for i, level in enumerate(params["down"]):
        for j, blk in enumerate(level["block"]):
            h = resnet_block(h, blk)
            if level["attn"]:
                h = attn_block(h, level["attn"][j])
        if i != nres - 1:
            h = downsample2x(h, level["downsample"])
    h = resnet_block(h, params["mid"]["block_1"])
    h = attn_block(h, params["mid"]["attn_1"])
    h = resnet_block(h, params["mid"]["block_2"])
    return conv2d(swish(group_norm(h, params["norm_out"])), params["conv_out"])


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


def code_scores(qparams, z_NC: torch.Tensor, using_znorm: bool) -> torch.Tensor:
    """``[N, V]``: the squared distance ``|z|^2 + |e|^2 - 2 z.e`` of each
    row of ``z_NC`` to each code (the nearest code has the least), or with
    ``using_znorm`` the cosine of the normalized row and code (the nearest
    has the greatest), in the dtype of ``z_NC``."""
    emb = qparams["embedding"].to(z_NC.dtype)
    if using_znorm:
        z = z_NC / torch.linalg.vector_norm(z_NC, dim=-1, keepdim=True)
        e = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return z @ e.T
    return (z_NC.square().sum(dim=1, keepdim=True)
            + emb.square().sum(dim=1)[None, :] - 2.0 * (z_NC @ emb.T))


def _nearest_code(qparams, z_NC: torch.Tensor, using_znorm: bool):
    scores = code_scores(qparams, z_NC, using_znorm)
    return scores.argmax(dim=1) if using_znorm else scores.argmin(dim=1)


def _scale_input(cfg: VQVAEConfig, si: int, f_rest: torch.Tensor):
    """The rows that scale ``si`` matches to codes, ``[B*pn*pn, C]``: the
    residual area-downsampled to ``pn`` (below the last scale)."""
    pn = cfg.patch_nums[si]
    z = f_rest if si == len(cfg.patch_nums) - 1 else resize2d(
        f_rest, (pn, pn), "area")
    return z.permute(0, 2, 3, 1).reshape(-1, f_rest.shape[1])


def _remove_scale(qparams, cfg: VQVAEConfig, si: int, f_rest: torch.Tensor,
                  idx_Bl: torch.Tensor) -> torch.Tensor:
    """The residual after scale ``si``'s tokens ``[B, pn*pn]``: minus
    their embedding, bicubic-upsampled (below the last scale) and
    phi-convolved."""
    pns = cfg.patch_nums
    sn, pn = len(pns), pns[si]
    b, _, hh, ww = f_rest.shape
    h = embed_idx(qparams, idx_Bl.reshape(b, pn, pn)).permute(0, 3, 1, 2)
    h = h.to(f_rest.dtype)
    if si != sn - 1:
        h = resize2d(h, (hh, ww), "bicubic")
    return f_rest - phi_conv(
        h, qparams["phi"][phi_index(si, sn, cfg.share_quant_resi)],
        cfg.quant_resi)


def f_to_idxBl(qparams, cfg: VQVAEConfig,
               f_BChw: torch.Tensor) -> List[torch.Tensor]:
    """Multi-scale tokenization of an encoder feature map: at each scale
    the nearest codes of the residual, whose embedding then leaves the
    residual; tokens ``[B, pn*pn]`` per scale."""
    b = f_BChw.shape[0]
    f_rest = f_BChw
    idx_list = []
    for si, pn in enumerate(cfg.patch_nums):
        idx = _nearest_code(qparams, _scale_input(cfg, si, f_rest),
                            cfg.using_znorm).reshape(b, pn * pn)
        f_rest = _remove_scale(qparams, cfg, si, f_rest, idx)
        idx_list.append(idx)
    return idx_list


def scale_inputs_along(qparams, cfg: VQVAEConfig, f_BChw: torch.Tensor,
                       idx_list: List[torch.Tensor]) -> List[torch.Tensor]:
    """The rows ``[B*pn*pn, C]`` that :func:`f_to_idxBl` matches to codes
    at each scale when the earlier scales' tokens are ``idx_list``'s, in
    the dtype of ``f_BChw``: to hold tokens of another implementation
    against these codes' scores (float64 for a reference)."""
    f_rest = f_BChw
    out = []
    for si in range(len(cfg.patch_nums)):
        out.append(_scale_input(cfg, si, f_rest))
        f_rest = _remove_scale(qparams, cfg, si, f_rest, idx_list[si])
    return out


#: float32's unit roundoff
U32 = 2.0 ** -24


def near_tie_bound(z: torch.Tensor, e_a: torch.Tensor, e_b: torch.Tensor,
                   dz: torch.Tensor, using_znorm: bool) -> torch.Tensor:
    """``[N]``: the score gap between codes ``e_a`` and ``e_b`` ``[N, C]``
    below which two float32 tokenizers may order them differently for the
    residual row ``z`` ``[N, C]`` (float64), when their two float32 rows
    differ by at most ``dz`` ``[N]`` (L2).

    Each side's score of each code has two errors: float32 rounding, at
    most ``gamma = (C + 2) u`` times the sum of the magnitudes of its terms
    (a C-term dot product and two C-term sums of squares, then two adds:
    ``(|z| + |e|)^2`` for the squared distance; for the cosine of unit
    rows, 2 for the dot product and the two norms), and the row's own
    difference, at most ``2 |z - e| dz + dz^2`` for the squared distance
    and ``2 dz / |z|`` for the cosine.  The two codes can swap places
    where their gap is below both codes' errors on both sides."""
    c = z.shape[1]
    gamma = (c + 2) * U32 / (1 - (c + 2) * U32)
    nz = torch.linalg.vector_norm(z, dim=1)
    total = torch.zeros_like(nz)
    for e in (e_a, e_b):
        if using_znorm:
            err = 4.0 * gamma + 2.0 * dz / nz
        else:
            ne = torch.linalg.vector_norm(e, dim=1)
            dist = torch.linalg.vector_norm(z - e, dim=1)
            err = gamma * (nz + ne) ** 2 + 2.0 * dist * dz + dz ** 2
        total = total + 2.0 * err
    return total


def token_agreement(qparams, cfg: VQVAEConfig, f_ours: torch.Tensor,
                    ours: List[torch.Tensor], f_theirs: torch.Tensor,
                    theirs: List[torch.Tensor]) -> dict:
    """Hold tokens ``ours`` (this module's, from the feature map
    ``f_ours``) against another float32 tokenizer's ``theirs`` (from
    ``f_theirs``), which may differ only at near-ties.

    Scale by scale along ``ours``' tokens, in float64 on the CPU: the rows
    each scale matches (:func:`scale_inputs_along`) from ``f_ours``, and
    the two sides' row difference ``dz``: that of ``f_theirs``'s rows
    along the same tokens, plus twice the float32 rounding of this
    module's rows (measured, standing for both sides').  A token that
    differs must score within :func:`near_tie_bound` of ours; ours must
    score within it of the float64 best.  After an image's first
    differing token its later scales (whose residuals then differ) are
    left out.  Returns the counts ``compared``, ``differ``, ``left_out``
    and ``beyond`` (tokens, differing or ours, outside the bound)."""
    cpu = torch.device("cpu")
    q64 = {"embedding": qparams["embedding"].to(cpu, torch.float64),
           "phi": [{k: v.to(cpu, torch.float64) for k, v in p.items()}
                   for p in qparams["phi"]]}
    q32 = {"embedding": q64["embedding"].float(),
           "phi": [{k: v.float() for k, v in p.items()} for p in q64["phi"]]}
    hist = [t.to(cpu).long() for t in ours]
    z64 = scale_inputs_along(q64, cfg, f_ours.to(cpu, torch.float64), hist)
    z_theirs = scale_inputs_along(q64, cfg, f_theirs.to(cpu, torch.float64),
                                  hist)
    z32 = scale_inputs_along(q32, cfg, f_ours.to(cpu, torch.float32), hist)
    emb = q64["embedding"]
    b = hist[0].shape[0]
    live = torch.ones(b, dtype=torch.bool)
    out = {"compared": 0, "differ": 0, "left_out": 0, "beyond": 0}
    for si, pn in enumerate(cfg.patch_nums):
        a = hist[si].reshape(-1)
        t = theirs[si].to(cpu).long().reshape(-1)
        rows = live.repeat_interleave(pn * pn)
        z = z64[si]
        dz = (torch.linalg.vector_norm(z_theirs[si] - z, dim=1)
              + 2.0 * torch.linalg.vector_norm(z32[si].double() - z, dim=1))
        scores = code_scores(q64, z, cfg.using_znorm)
        best = (scores.argmax(1) if cfg.using_znorm else scores.argmin(1))
        s_a = scores.gather(1, a[:, None])[:, 0]
        s_t = scores.gather(1, t[:, None])[:, 0]
        s_b = scores.gather(1, best[:, None])[:, 0]
        diff = rows & (a != t)
        bad = diff & ((s_a - s_t).abs() > near_tie_bound(
            z, emb[a], emb[t], dz, cfg.using_znorm))
        bad |= rows & ((s_a - s_b).abs() > near_tie_bound(
            z, emb[a], emb[best], dz, cfg.using_znorm))
        out["compared"] += int(rows.sum())
        out["left_out"] += int((~rows).sum())
        out["differ"] += int(diff.sum())
        out["beyond"] += int(bad.sum())
        live &= ~diff.reshape(b, -1).any(dim=1)
    return out


def idxBl_to_var_input(qparams, cfg: VQVAEConfig,
                       idx_list: List[torch.Tensor]) -> torch.Tensor:
    """Teacher-forcing input of VAR training, ``[B, L - first_l, Cvae]``
    float32: after each scale but the last, the running ``f_hat``
    area-downsampled to the next scale."""
    pns = cfg.patch_nums
    sn = len(pns)
    b = idx_list[0].shape[0]
    c = cfg.z_channels
    hw = pns[-1]
    f_hat = torch.zeros((b, c, hw, hw), dtype=torch.float32,
                        device=idx_list[0].device)
    outs = []
    for si in range(sn - 1):
        pn = pns[si]
        h = embed_idx(qparams, idx_list[si]).transpose(1, 2).reshape(
            b, c, pn, pn)
        h = resize2d(h, (hw, hw), "bicubic")
        f_hat = f_hat + phi_conv(
            h, qparams["phi"][phi_index(si, sn, cfg.share_quant_resi)],
            cfg.quant_resi)
        pn_next = pns[si + 1]
        outs.append(resize2d(f_hat, (pn_next, pn_next), "area")
                    .reshape(b, c, -1).transpose(1, 2))
    return torch.cat(outs, dim=1)


def encode(params, cfg: VQVAEConfig, img: torch.Tensor) -> torch.Tensor:
    """Images ``[B, 3, H, W]`` in [-1, 1] -> the feature map ``f``
    ``[B, Cvae, H/16, W/16]`` (``downsample`` = 16 for the published
    VQVAE)."""
    f = encoder_forward(params["encoder"], cfg, img)
    return conv2d(f, params["quant_conv"])


def img_to_idxBl(params, cfg: VQVAEConfig,
                 img: torch.Tensor) -> List[torch.Tensor]:
    return f_to_idxBl(params["quantize"], cfg, encode(params, cfg, img))


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
    """Random VQVAE in the JAX package's tree layout (uniform
    +-1/sqrt(fan_in) convs, N(0, 0.02) codebook).  The encoder and the
    quant conv are drawn after the decoder, the quantizer and the
    post-quant conv, so those keep the values that a seed gave them before
    the encoder was ported."""
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
    post_quant_conv = _conv_init(gen, device, cfg.z_channels,
                                 cfg.z_channels, 3)

    enc = {"conv_in": _conv_init(gen, device, ch, 3, 3), "down": []}
    in_mult = (1,) + tuple(cfg.ch_mult)
    for i in range(nres):
        cin, cout = ch * in_mult[i], ch * cfg.ch_mult[i]
        level = {"block": [], "attn": []}
        for _ in range(cfg.num_res_blocks):
            level["block"].append(_resnet_init(gen, device, cin, cout))
            cin = cout
            if i == nres - 1:
                level["attn"].append(_attn_init(gen, device, cout))
        if i != nres - 1:
            level["downsample"] = _conv_init(gen, device, cout, cout, 3)
        enc["down"].append(level)
    enc["mid"] = {
        "block_1": _resnet_init(gen, device, cmid, cmid),
        "attn_1": _attn_init(gen, device, cmid),
        "block_2": _resnet_init(gen, device, cmid, cmid),
    }
    enc["norm_out"] = _gn_init(device, cmid)
    enc["conv_out"] = _conv_init(gen, device, cfg.z_channels, cmid, 3)
    return {
        "encoder": enc,
        "decoder": dec,
        "quant_conv": _conv_init(gen, device, cfg.z_channels,
                                 cfg.z_channels, 3),
        "post_quant_conv": post_quant_conv,
        "quantize": quant,
    }
