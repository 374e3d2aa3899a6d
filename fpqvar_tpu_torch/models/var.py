"""VAR next-scale-prediction transformer, the generation path.

Plain functions over the JAX package's params tree (block parameters
stacked along a leading depth axis, weights (out, in)); the layer loop is a
Python loop over depth, and the preallocated KV cache is written in place,
one block's new rows at a time: dense ``[depth, 2B, L, H*c]``, or packed
(int8 codes and float32 scales per (token, head), head-major) when the
recipe has a KV codec.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fpqvar_tpu_torch.config import GenerateConfig, VARConfig
from fpqvar_tpu_torch.models import vqvae as vq
from fpqvar_tpu_torch.models.sampling import (Generators, gumbel_softmax,
                                              sample_with_top_k_top_p)
from fpqvar_tpu_torch.ops.hadamard import apply_block_hadamard
from fpqvar_tpu_torch.ops.int8_matmul import int8_linear, int8_linear_dual
from fpqvar_tpu_torch.ops.packing import DUAL_CODE_MULT, IntPack, PackedTensor
from fpqvar_tpu_torch.ops.quant_matmul import packed_linear
from fpqvar_tpu_torch.ops.quantizers import safe_scale

MAX_SCALE_MUL = math.log(100.0)
#: 1/127 rounded to float32: under ``jit`` XLA turns ``a / 127.0`` into
#: ``a * f32(1/127)``, and JAX's engine runs jitted
INV_127 = float(np.float32(1.0) / np.float32(127.0))
#: a float32 sum of integers is exact while every partial sum stays within
#: 2^24
EXACT_F32_INT = 2 ** 24


def linear(x: torch.Tensor, w, b=None) -> torch.Tensor:
    """torch-layout linear: w is (out, in), a float tensor or a
    :class:`PackedTensor` (through the packed GEMM, K2)."""
    if isinstance(w, PackedTensor):
        y = packed_linear(x, w)
    else:
        y = x @ w.to(x.dtype).T
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def layernorm_no_affine(x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    # F.normalize(dim=-1) semantics: x / max(||x||, eps)
    xf = x.to(torch.float32)
    n = torch.linalg.vector_norm(xf, dim=-1, keepdim=True)
    return (xf / n.clamp_min(1e-12)).to(x.dtype)


def _attention(q, k, v, attn_bias: Optional[torch.Tensor]):
    """q [B,l,H,c], k/v [B,M,H,c] -> [B,l,H*c]; f32 scores and softmax,
    scale 1 (the queries and keys are l2-normalized)."""
    b, l, h, c = q.shape
    scores = torch.einsum("blhc,bmhc->bhlm", q.to(torch.float32),
                          k.to(torch.float32))
    if attn_bias is not None:
        scores = scores + attn_bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhlm,bmhc->blhc", probs, v).reshape(b, l, h * c)


def int8_row_codes(t: torch.Tensor):
    """``attn_int8``'s quantizer, per row of the last dim: (codes int8,
    scales f32 ``[..., 1]``) with scale ``absmax * f32(1/127)`` (1 for an
    all-zero row) and code ``round(t / scale)``, a true division rounded
    half to even, as JAX's jitted ``jnp.round(t / s)``."""
    tf = t.to(torch.float32)
    s = safe_scale(tf.abs().amax(dim=-1, keepdim=True), INV_127)
    return torch.round(tf / s).to(torch.int8), s


def check_int8_attention_exact(head_dim: int, m: int, max_code: int):
    """``attn_int8`` runs its two integer contractions as float32 matmuls
    of the codes, which is exact while every partial sum stays within
    2^24: q . k over ``head_dim`` terms and p . v over ``m`` cached tokens,
    each term at most 127 * ``max_code``.  Raises past that bound."""
    worst = 127 * max_code * max(head_dim, m)
    if worst > EXACT_F32_INT:
        raise ValueError(
            f"attn_int8: sums up to 127*{max_code}*{max(head_dim, m)} = "
            f"{worst} exceed 2^24, where float32 matmuls of the codes stop "
            "being exact")


def _int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact ``a @ b`` of int8 codes as a float32 matmul (the caller checks
    the 2^24 bound; TF32 would round the codes' products)."""
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "attn_int8's integer contractions run as float32 matmuls and "
            "need TF32 off (torch.backends.cuda.matmul.allow_tf32 = False)")
    return a.to(torch.float32) @ b.to(torch.float32)


def _int8_attention(q, kc, ks, vc, vs, max_code: int, attn_bias):
    """Attention with both products over int8 codes (JAX's ``attn_int8``):
    q [B,l,H,c] quantized per (token, head), scores ``(qc . kc) * qs *
    ks``, softmax, the weights with v's scales folded in quantized per row,
    output ``(pc . vc) * ps`` [B,l,H*c] float32.  kc/vc [B,H,M,c] int8,
    ks/vs [B,H,M] f32."""
    b, l, h, c = q.shape
    check_int8_attention_exact(c, kc.shape[2], max_code)
    qc, qs = int8_row_codes(q)                      # [B,l,H,c], [B,l,H,1]
    scores = _int_matmul(qc.transpose(1, 2), kc.transpose(-1, -2))
    scores = scores * qs.transpose(1, 2) * ks[:, :, None, :]
    if attn_bias is not None:
        scores = scores + attn_bias
    pv = torch.softmax(scores, dim=-1) * vs[:, :, None, :]
    pc, ps = int8_row_codes(pv)                     # [B,H,l,M], [B,H,l,1]
    oup = _int_matmul(pc, vc) * ps                  # [B,H,l,c]
    return oup.transpose(1, 2).reshape(b, l, h * c)


def _packed_attention(q, k, v, qrt, cache, cur: int, attn_bias):
    """Attention over the packed cache (JAX's packed-KV branch).  This
    step's keys and values are encoded once, per (token, head), into rows
    ``[cur, cur + l)`` of the codes and scales in place; attention reads
    rows ``[0, cur + l)``.  With value codes the scales fold into the score
    columns (k) and the softmax weights (v), float32 scores and the second
    product in ``q``'s dtype, or, under ``attn_int8``, both products run
    over int8 codes; other grids decode to values for ``_attention``.
    Returns ``[B, l, H*c]`` in ``q``'s dtype (the block's, to which JAX
    casts ``attn_int8``'s float32 output)."""
    codec = qrt.kv_codec
    b, l, h, c = q.shape
    end = cur + l
    for t, codes, scales in ((k, "kc", "ks"), (v, "vc", "vs")):
        tc, ts = codec.encode(t)                    # [B,l,H,c], [B,l,H,1]
        cache[codes][:, :, cur:end] = tc.transpose(1, 2)
        cache[scales][:, :, cur:end] = ts[..., 0].transpose(1, 2)
    kc, vc = cache["kc"][:, :, :end], cache["vc"][:, :, :end]
    ks, vs = cache["ks"][:, :, :end], cache["vs"][:, :, :end]
    if not codec.value_codes:
        def dec(codes, scales):
            return codec.decode(codes, scales[..., None]).transpose(
                1, 2).to(q.dtype)

        return _attention(q, dec(kc, ks), dec(vc, vs), attn_bias)
    if qrt.attn_int8:
        return _int8_attention(q, kc, ks, vc, vs, codec.max_code,
                               attn_bias).to(q.dtype)
    scores = q.transpose(1, 2).to(torch.float32) @ kc.to(
        torch.float32).transpose(-1, -2)
    scores = scores * ks[:, :, None, :]
    if attn_bias is not None:
        scores = scores + attn_bias
    pv = (torch.softmax(scores, dim=-1) * vs[:, :, None, :]).to(q.dtype)
    return (pv @ vc.to(q.dtype)).transpose(1, 2).reshape(b, l, h * c)


def _q_then_lin(qrt, kind: str, xv, w, b=None):
    """Linear of one layer kind.  An :class:`IntPack` weight takes the int8
    linears of ``ops/int8_matmul.py``, which quantize the activation to int
    codes inside the GEMM call: the grouped GEMM over ``[B, T, K]`` with
    its output in the activation's dtype (K5) per group, the
    quantize-in-kernel full-K GEMM (K4) per channel, two f32 GEMMs for
    fc2's dual-grid format (K1 per group, K3 per channel), and the
    weights-only product for the ``bf16`` activation format.  Otherwise the
    kind's activation quantizer (if any) runs first, then the linear on the
    float or packed weight."""
    if isinstance(w, IntPack):
        fmt_a = qrt.act_fmts.get(kind) or w.fmt
        if fmt_a in DUAL_CODE_MULT:
            y = int8_linear_dual(xv, w, fmt_a)
        else:
            y = int8_linear(xv, w, fmt_a)
        return y if b is None else y + b.to(y.dtype)
    aq = qrt.act_q.get(kind) if qrt is not None else None
    if aq is not None:
        xv = aq(xv)
    return linear(xv, w, b)


def block_forward(
    x: torch.Tensor,
    bp: Dict,
    mod: torch.Tensor,                  # [6, B, 1, C]
    qrt,                                # QuantRuntime or None
    cfg: VARConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,   # one block's leaves
    cur: int = 0,
    attn_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One AdaLN self-attention block.  With a cache (dense {"k","v"} [B,
    L, C], or packed {"kc","vc"} [B, H, L, c] int8 and {"ks","vs"} [B, H,
    L] f32 under the runtime's KV codec), this step's keys and values are
    written into rows ``[cur, cur + l)`` of ``cache`` in place and
    attention runs over rows ``[0, cur + l)``."""
    heads, hd = cfg.heads, cfg.head_dim
    b, l, c = x.shape
    gamma1, gamma2, scale1, scale2, shift1, shift2 = mod
    smooth = qrt is not None and qrt.transform
    rot = qrt.rotation_block if qrt is not None else None

    # ---- attention branch
    x1 = layernorm_no_affine(x, cfg.norm_eps) * (1.0 + scale1) + shift1
    if smooth:
        x1 = x1 * bp["mat_qkv_s"].to(x1.dtype)
    if rot is not None:
        x1 = apply_block_hadamard(x1, rot)
    qkv = _q_then_lin(qrt, "mat_qkv", x1, bp["mat_qkv_w"])
    bias = torch.cat([bp["q_bias"], torch.zeros_like(bp["q_bias"]),
                      bp["v_bias"]])
    qkv = (qkv + bias.to(qkv.dtype)).reshape(b, l, 3, heads, hd)
    q, k, v = qkv.unbind(2)
    if cfg.attn_l2_norm:
        scale_mul = torch.exp(
            bp["scale_mul"].to(torch.float32).clamp_max(MAX_SCALE_MUL)
        ).reshape(1, 1, heads, 1)
        q = _l2norm(q) * scale_mul.to(q.dtype)
        k = _l2norm(k)

    if cache is not None and qrt is not None and qrt.kv_codec is not None:
        oup = _packed_attention(q, k, v, qrt, cache, cur, attn_bias)
    else:
        if cache is not None:
            end = cur + l
            cache["k"][:, cur:end] = k.reshape(b, l, c).to(cache["k"].dtype)
            cache["v"][:, cur:end] = v.reshape(b, l, c).to(cache["v"].dtype)
            k = cache["k"][:, :end].reshape(b, end, heads, hd).to(q.dtype)
            v = cache["v"][:, :end].reshape(b, end, heads, hd).to(q.dtype)
        oup = _attention(q, k, v, attn_bias)
    proj_out = _q_then_lin(qrt, "proj", oup, bp["proj_w"], bp["proj_b"])
    x = x + (proj_out * gamma1).to(x.dtype)

    # ---- FFN branch
    x2 = layernorm_no_affine(x, cfg.norm_eps) * (1.0 + scale2) + shift2
    if smooth:
        x2 = x2 * bp["fc1_s"].to(x2.dtype)
    if rot is not None:
        x2 = apply_block_hadamard(x2, rot)
    h = gelu_tanh(_q_then_lin(qrt, "fc1", x2, bp["fc1_w"], bp["fc1_b"]))
    out = _q_then_lin(qrt, "fc2", h, bp["fc2_w"], bp["fc2_b"])
    return x + (out * gamma2).to(x.dtype)


def block_params(blocks: Dict, i: int) -> Dict:
    """Block ``i`` of the depth-stacked block parameters (views)."""
    out = {}
    for key, val in blocks.items():
        if isinstance(val, (IntPack, PackedTensor)):
            out[key] = val.block(i)
        elif isinstance(val, torch.Tensor):
            out[key] = val[i]
    return out


def compute_modulations(params, cfg: VARConfig, cond_BD: torch.Tensor):
    """Per-block AdaLN modulation [depth, 6, B, 1, C] (non-shared
    SiLU -> Linear(D, 6C) per block)."""
    if cfg.shared_aln:
        raise NotImplementedError(
            "shared_aln is not ported yet (ROADMAP: shared_aln / d36-512)")
    d, b, c = cfg.depth, cond_BD.shape[0], cfg.width
    act = F.silu(cond_BD)
    w = params["blocks"]["ada_lin"]["w"]           # [depth, 6C, D]
    bb = params["blocks"]["ada_lin"]["b"]          # [depth, 6C]
    mod = torch.einsum("bd,kod->kbo", act, w.to(act.dtype)) + bb[:, None, :]
    return mod.reshape(d, b, 6, c).permute(0, 2, 1, 3)[:, :, :, None, :]


def head_logits(params, cfg: VARConfig, x: torch.Tensor, cond_BD):
    """AdaLN before the head, then the head linear."""
    hn = params["head_nm"]
    ss = linear(F.silu(cond_BD), hn["w"], hn["b"])
    scale, shift = ss.reshape(ss.shape[0], 1, 2, cfg.width).unbind(2)
    h = layernorm_no_affine(x.to(torch.float32), cfg.norm_eps)
    h = h * (1.0 + scale) + shift
    return linear(h, params["head"]["w"], params["head"]["b"])


def run_blocks(params, cfg: VARConfig, qrt, x, mod, cache=None, cur: int = 0,
               attn_bias=None):
    """All blocks in order; block i reads and writes ``cache[...][i]``."""
    blocks = params["blocks"]
    for i in range(cfg.depth):
        ci = None
        if cache is not None:
            ci = {kn: leaf[i] for kn, leaf in cache.items()}
        x = block_forward(x, block_params(blocks, i), mod[i], qrt, cfg, ci,
                          cur, attn_bias)
    return x


# ---------------------------------------------------------------------------
# Autoregressive generation
# ---------------------------------------------------------------------------

def lvl_1L(cfg: VARConfig) -> np.ndarray:
    return np.concatenate(
        [np.full(pn * pn, i, np.int64) for i, pn in enumerate(cfg.patch_nums)])


@dataclass(frozen=True)
class GenStatics:
    """Per-scale geometry."""
    si: int
    pn: int
    cur: int          # tokens cached before this step
    l: int            # pn*pn new tokens

    @staticmethod
    def all_steps(cfg: VARConfig):
        out, cur = [], 0
        for si, pn in enumerate(cfg.patch_nums):
            out.append(GenStatics(si, pn, cur, pn * pn))
            cur += pn * pn
        return out


def init_kv_cache(cfg: VARConfig, batch: int, dtype=torch.bfloat16,
                  device="cuda", kv_codec=None):
    """Preallocated KV cache, written in place one scale step at a time.

    Dense: {"k","v"} in ``dtype`` at [depth, B, L, H*c].  Packed (a
    ``kv_codec``): {"kc","vc"} int8 codes at [depth, B, H, L, c] and
    {"ks","vs"} float32 per-(token, head) scales at [depth, B, H, L],
    head-major as JAX's, so that attention reads ``[B, H, M, c]`` views.
    JAX splits the packed cache into one segment per scale because XLA
    would not update a large buffer in place; PyTorch does, so the port
    keeps one buffer per leaf, as for the dense cache."""
    if kv_codec is None:
        shape = (cfg.depth, batch, cfg.L, cfg.heads * cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    lead = (cfg.depth, batch, cfg.heads, cfg.L)
    codes = lead + (cfg.head_dim,)
    return {"kc": torch.zeros(codes, dtype=torch.int8, device=device),
            "vc": torch.zeros(codes, dtype=torch.int8, device=device),
            "ks": torch.zeros(lead, dtype=torch.float32, device=device),
            "vs": torch.zeros(lead, dtype=torch.float32, device=device)}


def scale_step(params, vae_qparams, cfg: VARConfig, qrt, gen: GenerateConfig,
               st: GenStatics, x, cond_BD, mod, lvl_pos, cache, f_hat,
               generator: Optional[Generators]):
    """One scale: transformer -> logits -> CFG -> sample -> residual
    pyramid -> the next scale's token map.  Returns (next x or None at the
    last scale, f_hat).

    ``generator`` is one ``torch.Generator`` for the whole batch or one per
    row (JAX's single key or ``[B, 2]`` per-row keys); each draws the
    sample's noise first, then, under ``more_smooth``, the soft blend's, in
    the order JAX splits its keys."""
    b = x.shape[0] // 2
    x = run_blocks(params, cfg, qrt, x, mod, cache, st.cur)
    logits = head_logits(params, cfg, x.to(torch.float32), cond_BD)
    t = gen.cfg * (st.si / (cfg.num_scales - 1))
    logits = (1.0 + t) * logits[:b] - t * logits[b:]
    idx_Bl = sample_with_top_k_top_p(logits, gen.top_k, gen.top_p, generator)
    if gen.more_smooth:
        # the Gumbel-softmax blend of the codebook; the index above is still
        # drawn (and dropped) so that the noise stream matches the default
        # mode's
        ratio = st.si / (cfg.num_scales - 1)
        gum_t = max(0.27 * (1.0 - ratio * 0.95), 0.005)
        soft = gumbel_softmax(logits * (1.0 + ratio), gum_t, generator)
        h_BChw = soft @ vae_qparams["embedding"].to(soft.dtype)
    else:
        h_BChw = vq.embed_idx(vae_qparams, idx_Bl)       # [B, l, Cvae]
    h_BChw = h_BChw.transpose(1, 2).reshape(
        b, cfg.vae.z_channels, st.pn, st.pn).to(torch.float32)
    f_hat, next_raw = vq.get_next_autoregressive_input(
        vae_qparams, cfg.vae, st.si, f_hat, h_BChw)
    if st.si == cfg.num_scales - 1:
        return None, f_hat
    pn_next = cfg.patch_nums[st.si + 1]
    nxt = next_raw.reshape(b, cfg.vae.z_channels, -1).transpose(1, 2)
    we = params["word_embed"]
    nxt = linear(nxt, we["w"], we["b"]).to(x.dtype)
    cur_end = st.cur + st.l
    nxt = nxt + lvl_pos[:, cur_end: cur_end + pn_next * pn_next]
    return torch.cat([nxt, nxt], dim=0), f_hat      # CFG batch doubling


@lru_cache(maxsize=None)
def _lvl_index(cfg: VARConfig, device: torch.device) -> torch.Tensor:
    """``lvl_1L`` on ``device``, copied there once (a copy from the host on
    every generation would make the host wait for the device)."""
    with torch.inference_mode(False):
        return torch.from_numpy(lvl_1L(cfg)).to(device)


def prepare_generation(params, cfg: VARConfig, label_B: torch.Tensor):
    """Condition embeddings, modulations and the first token map."""
    uncond = torch.full_like(label_B, cfg.num_classes)
    cond_BD = params["class_emb"][torch.cat([label_B, uncond])]
    lvl = _lvl_index(cfg, label_B.device)
    lvl_pos = params["lvl_embed"][lvl][None] + params["pos_1LC"]
    first = (cond_BD[:, None, :] + params["pos_start"]
             + lvl_pos[:, : cfg.first_l])
    mod = compute_modulations(params, cfg, cond_BD)
    return cond_BD, mod, lvl_pos, first


# ---------------------------------------------------------------------------
# Initialization (random weights from a torch.Generator)
# ---------------------------------------------------------------------------

def init_var_params(cfg: VARConfig, seed: int = 0, device="cuda",
                    dtype=torch.float32,
                    adaln_gamma_std: float = 0.02 * 1e-2):
    """Random init in the JAX package's tree layout: truncated-normal
    (+-2 std) weights, zero biases, ``scale_mul = log 4``.  The reference
    AdaLN gamma std makes fresh blocks near-identity; pass 0.02 to make
    outputs depend on the block internals."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    c, d, heads = cfg.width, cfg.depth, cfg.heads
    cvae, v = cfg.vae.z_channels, cfg.vae.vocab_size
    init_std = math.sqrt(1.0 / c / 3.0)
    lim = math.erf(2.0 / math.sqrt(2.0))

    def tn(shape, std=init_std):
        u = torch.rand(shape, generator=gen, device=device) * (2 * lim) - lim
        z = torch.erfinv(u) * math.sqrt(2.0)
        return (z.clamp(-2.0, 2.0) * std).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def lin_init(o, i, std=0.02):
        return {"w": tn((o, i), std), "b": zeros(o)}

    blocks = {
        "mat_qkv_w": tn((d, 3 * c, c), 0.02),
        "q_bias": zeros(d, c),
        "v_bias": zeros(d, c),
        "scale_mul": torch.full((d, 1, heads, 1, 1), math.log(4.0),
                                dtype=dtype, device=device),
        "proj_w": tn((d, c, c), 0.02 / math.sqrt(2 * d)),
        "proj_b": zeros(d, c),
        "fc1_w": tn((d, 4 * c, c), 0.02),
        "fc1_b": zeros(d, 4 * c),
        "fc2_w": tn((d, c, 4 * c), 0.02 / math.sqrt(2 * d)),
        "fc2_b": zeros(d, c),
        "mat_qkv_s": torch.ones((d, c), dtype=dtype, device=device),
        "fc1_s": torch.ones((d, c), dtype=dtype, device=device),
        "ada_lin": {"w": tn((d, 6 * c, c), adaln_gamma_std),
                    "b": zeros(d, 6 * c)},
    }
    if cfg.shared_aln:
        raise NotImplementedError("shared_aln is not ported yet")
    return {
        "word_embed": lin_init(c, cvae),
        "class_emb": tn((cfg.num_classes + 1, c)),
        "pos_start": tn((1, cfg.first_l, c)),
        "pos_1LC": tn((1, cfg.L, c)),
        "lvl_embed": tn((cfg.num_scales, c)),
        "blocks": blocks,
        "head_nm": lin_init(2 * c, c),
        "head": lin_init(v, c),
    }
