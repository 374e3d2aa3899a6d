"""VAR next-scale-prediction transformer: generation and the teacher-forcing
forward.

Plain functions over the JAX package's params tree (block parameters
stacked along a leading depth axis, weights (out, in)); the layer loop is a
Python loop over depth, and the preallocated KV cache is written in place,
one block's new rows at a time: dense ``[depth, 2B, L, H*c]`` (fake-
quantized on append, or its whole prefix re-quantized every scale step,
under a fake KV quantizer), or packed (int8 codes and float32 scales per
(token, head), head-major) when the recipe has a KV codec.  The AdaLN
modulations come from a per-block ``ada_lin`` or, for the 512 px models,
one ``shared_ada_lin`` plus a per-block ``ada_gss``.  The teacher-forcing
forward (:func:`var_forward`) runs all L tokens at once under the
block-triangular mask of :func:`attn_bias_for_masking`; ``run_blocks`` can
also return the inputs of each block's four linears (``capture``) and
recompute each block on the backward pass (``remat``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from fpqvar_tpu_torch.config import GenerateConfig, VARConfig
from fpqvar_tpu_torch.models import vqvae as vq
from fpqvar_tpu_torch.models.sampling import (Generators, gumbel_softmax,
                                              sample_with_top_k_top_p)
from fpqvar_tpu_torch.ops.hadamard import apply_block_hadamard
from fpqvar_tpu_torch.ops.int8_matmul import int8_linear, int8_linear_dual
from fpqvar_tpu_torch.ops.packing import DUAL_CODE_MULT, IntPack, PackedTensor
from fpqvar_tpu_torch.ops.quant_matmul import packed_linear
from fpqvar_tpu_torch.ops.quantizers import safe_scale
from fpqvar_tpu_torch.parallel import collectives as C

MAX_SCALE_MUL = math.log(100.0)
#: 1/127 rounded to float32: under ``jit`` XLA turns ``a / 127.0`` into
#: ``a * f32(1/127)``, and JAX's engine runs jitted
INV_127 = float(np.float32(1.0) / np.float32(127.0))
#: a float32 sum of integers is exact while every partial sum stays within
#: 2^24
EXACT_F32_INT = 2 ** 24


def linear(x: torch.Tensor, w, b=None, mesh=None,
           parallel: Optional[str] = None) -> torch.Tensor:
    """torch-layout linear: w is (out, in), a float tensor or a
    :class:`PackedTensor` (through the packed GEMM, K2).

    With a ``mesh`` and ``parallel`` ("col" or "row"), ``w`` and ``b`` are
    this rank's shards and the linear runs tensor-parallel on the whole,
    replicated ``x``, returning the whole output: a float column split
    takes the rank's output columns and all-gathers them over tp; a row
    split takes the rank's K-slice of ``x`` and sums the float32 partial
    products over tp (in float32 whatever ``x.dtype``, as one GEMM
    accumulates); the bias is added as ``collectives.linear_out`` adds
    it, before a column split's gather."""
    if isinstance(w, PackedTensor):
        return packed_linear(x, w, mesh=mesh, parallel=parallel, b=b)
    if mesh is None or parallel is None or mesh.tp <= 1:
        y = x @ w.to(x.dtype).T
        return y if b is None else y + b.to(y.dtype)
    if parallel == "col":
        y = C.copy_to_tp(x, mesh) @ w.to(x.dtype).T
    else:
        xl = C.take_slice(x, mesh).to(torch.float32)
        y = C.sum_partials(xl @ w.to(torch.float32).T, mesh).to(x.dtype)
    return C.linear_out(y, b, mesh, parallel, True)


def _mesh_of(qrt):
    return qrt.mesh if qrt is not None else None


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


def _rotate(qrt, x: torch.Tensor) -> torch.Tensor:
    """The online rotation of a linear's input: the block-diagonal one as
    one ``[..., C/128, 128]`` matmul, or the full-size ``x @ Q``."""
    if qrt is None:
        return x
    if qrt.rotation_block is not None:
        return apply_block_hadamard(x, qrt.rotation_block)
    if qrt.rotation_full is not None:
        return x @ qrt.rotation_full.to(x.dtype)
    return x


def _dense_cache_update(k, v, qrt, cache, cur: int):
    """Write this step's keys and values ``[B, l, H, c]`` into rows ``[cur,
    cur + l)`` of the dense cache ``{"k","v"}`` ``[B, L, H*c]`` in place and
    return rows ``[0, cur + l)`` as ``[B, M, H, c]`` in ``k``'s dtype.

    Under a fake KV quantizer, ``kv_mode="store"`` quantizes the new rows
    before they are written; ``"reference"`` re-quantizes the cached rows
    ``[0, cur)`` in place first and appends the new rows raw, so the prefix
    is quantized again at every later scale step (JAX writes the quantized
    prefix back the same way)."""
    b, l, heads, hd = k.shape
    end = cur + l
    kv_q = qrt.kv_q if qrt is not None else None
    if kv_q is not None and qrt.kv_mode == "store":
        k, v = kv_q(k), kv_q(v)
    out = []
    for t, buf in ((k, cache["k"]), (v, cache["v"])):
        if kv_q is not None and qrt.kv_mode == "reference" and cur > 0:
            pre = buf[:, :cur].reshape(b, cur, heads, hd)
            buf[:, :cur] = kv_q(pre).reshape(b, cur, heads * hd).to(buf.dtype)
        buf[:, cur:end] = t.reshape(b, l, heads * hd).to(buf.dtype)
        out.append(buf[:, :end].reshape(b, end, heads, hd).to(t.dtype))
    return out


def _q_then_lin(qrt, kind: str, xv, w, b=None, taps=None):
    """Linear of one layer kind.  An :class:`IntPack` weight takes the int8
    linears of ``ops/int8_matmul.py``, which quantize the activation to int
    codes inside the GEMM call: the grouped GEMM over ``[B, T, K]`` with
    its output in the activation's dtype (K5) per group, the
    quantize-in-kernel full-K GEMM (K4) per channel, two f32 GEMMs for
    fc2's dual-grid format (K1 per group, K3 per channel), and the
    weights-only product for the ``bf16`` activation format.  Otherwise the
    kind's activation quantizer (if any) runs first, then the linear on the
    float or packed weight.  ``taps`` (a dict) receives the linear's
    input under ``kind``: after the activation quantizer, or as it enters
    an int8 linear (which quantizes inside the GEMM call).

    Under the runtime's ``mesh`` the linear runs tensor-parallel, as JAX's
    ``_q_then_lin`` passes ``parallel``: a column split for ``mat_qkv``
    and ``fc1``, a row split for ``proj`` and ``fc2``; the output comes
    back whole on every rank of the tp row."""
    mesh = _mesh_of(qrt)
    par = "col" if kind in ("mat_qkv", "fc1") else "row"
    if isinstance(w, IntPack):
        if taps is not None:
            taps[kind] = xv
        fmt_a = qrt.act_fmts.get(kind) or w.fmt
        if fmt_a in DUAL_CODE_MULT:
            return int8_linear_dual(xv, w, fmt_a, mesh=mesh, parallel=par,
                                    b=b)
        return int8_linear(xv, w, fmt_a, mesh=mesh, parallel=par, b=b)
    aq = qrt.act_q.get(kind) if qrt is not None else None
    if aq is not None:
        xv = aq(xv)
    if taps is not None:
        taps[kind] = xv
    return linear(xv, w, b, mesh, par)


def block_forward(
    x: torch.Tensor,
    bp: Dict,
    mod: torch.Tensor,                  # [6, B, 1, C]
    qrt,                                # QuantRuntime or None
    cfg: VARConfig,
    cache: Optional[Dict[str, torch.Tensor]] = None,   # one block's leaves
    cur: int = 0,
    attn_bias: Optional[torch.Tensor] = None,
    taps: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """One AdaLN self-attention block.  With a cache (dense {"k","v"} [B,
    L, C], or packed {"kc","vc"} [B, H, L, c] int8 and {"ks","vs"} [B, H,
    L] f32 under the runtime's KV codec), this step's keys and values are
    written into rows ``[cur, cur + l)`` of ``cache`` in place and
    attention runs over rows ``[0, cur + l)``.  ``taps`` (a dict)
    receives the inputs of ``mat_qkv``, ``proj``, ``fc1`` and ``fc2`` (see
    ``_q_then_lin``).

    Under the runtime's ``mesh`` the four linears run tensor-parallel
    (``_q_then_lin``) on the replicated ``x``, and attention runs on this
    rank's ``heads / tp`` heads only (the cache holds only those), its
    output heads all-gathered over tp before ``proj``."""
    heads, hd = cfg.heads, cfg.head_dim
    b, l, c = x.shape
    mesh = _mesh_of(qrt)
    tp = mesh.tp if mesh is not None else 1
    gamma1, gamma2, scale1, scale2, shift1, shift2 = mod
    smooth = qrt is not None and qrt.transform

    # ---- attention branch
    x1 = layernorm_no_affine(x, cfg.norm_eps) * (1.0 + scale1) + shift1
    if smooth:
        x1 = x1 * bp["mat_qkv_s"].to(x1.dtype)
    x1 = _rotate(qrt, x1)
    qkv = _q_then_lin(qrt, "mat_qkv", x1, bp["mat_qkv_w"], taps=taps)
    bias = torch.cat([bp["q_bias"], torch.zeros_like(bp["q_bias"]),
                      bp["v_bias"]])
    qkv = (qkv + bias.to(qkv.dtype)).reshape(b, l, 3, heads, hd)
    if tp > 1:
        qkv = C.take_slice(qkv, mesh, dim=3)        # this rank's heads
    q, k, v = qkv.unbind(2)
    if cfg.attn_l2_norm:
        scale_mul = bp["scale_mul"].reshape(1, 1, heads, 1)
        if tp > 1:
            scale_mul = C.take_slice(scale_mul, mesh, dim=2)
        scale_mul = torch.exp(
            scale_mul.to(torch.float32).clamp_max(MAX_SCALE_MUL))
        q = _l2norm(q) * scale_mul.to(q.dtype)
        k = _l2norm(k)

    if cache is not None and qrt is not None and qrt.kv_codec is not None:
        oup = _packed_attention(q, k, v, qrt, cache, cur, attn_bias)
    else:
        if cache is not None:
            k, v = _dense_cache_update(k, v, qrt, cache, cur)
        oup = _attention(q, k, v, attn_bias)
    if tp > 1:
        oup = C.gather_cols(oup, mesh)
    proj_out = _q_then_lin(qrt, "proj", oup, bp["proj_w"], bp["proj_b"],
                           taps)
    x = x + (proj_out * gamma1).to(x.dtype)

    # ---- FFN branch
    x2 = layernorm_no_affine(x, cfg.norm_eps) * (1.0 + scale2) + shift2
    if smooth:
        x2 = x2 * bp["fc1_s"].to(x2.dtype)
    x2 = _rotate(qrt, x2)
    h = gelu_tanh(_q_then_lin(qrt, "fc1", x2, bp["fc1_w"], bp["fc1_b"],
                              taps))
    out = _q_then_lin(qrt, "fc2", h, bp["fc2_w"], bp["fc2_b"], taps)
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


def compute_modulations(params, cfg: VARConfig, cond_BD: torch.Tensor,
                        qrt=None):
    """Per-block AdaLN modulation [depth, 6, B, 1, C]: SiLU(cond) (fake-
    quantized per token under ``quantize_ada``), then per block
    ``ada_lin`` (Linear(D, 6C)), or with ``shared_aln`` one
    ``shared_ada_lin`` plus each block's ``ada_gss`` [6, C]."""
    d, b, c = cfg.depth, cond_BD.shape[0], cfg.width
    act = F.silu(cond_BD)
    aq = qrt.act_q.get("ada") if qrt is not None else None
    if aq is not None:
        act = aq(act)
    if cfg.shared_aln:
        sal = params["shared_ada_lin"]
        gss = linear(act, sal["w"], sal["b"]).reshape(b, 6, c)
        mod = params["blocks"]["ada_gss"][:, None] + gss[None]  # [d,B,6,C]
        return mod.permute(0, 2, 1, 3)[:, :, :, None, :]
    w = params["blocks"]["ada_lin"]["w"]           # [depth, 6C, D]
    bb = params["blocks"]["ada_lin"]["b"]          # [depth, 6C]
    mod = torch.einsum("bd,kod->kbo", act, w.to(act.dtype)) + bb[:, None, :]
    return mod.reshape(d, b, 6, c).permute(0, 2, 1, 3)[:, :, :, None, :]


def head_logits(params, cfg: VARConfig, x: torch.Tensor, cond_BD,
                mesh=None):
    """AdaLN before the head, then the head linear (under a ``mesh``, the
    vocabulary split over tp and the logits all-gathered)."""
    hn = params["head_nm"]
    ss = linear(F.silu(cond_BD), hn["w"], hn["b"])
    scale, shift = ss.reshape(ss.shape[0], 1, 2, cfg.width).unbind(2)
    h = layernorm_no_affine(x.to(torch.float32), cfg.norm_eps)
    h = h * (1.0 + scale) + shift
    return linear(h, params["head"]["w"], params["head"]["b"], mesh, "col")


def run_blocks(params, cfg: VARConfig, qrt, x, mod, cache=None, cur: int = 0,
               attn_bias=None, capture: bool = False, remat: bool = False):
    """All blocks in order; block i reads and writes ``cache[...][i]``
    and, under mixed formats, runs with ``qrt.for_block(i)``.

    Returns ``x``, or with ``capture`` ``(x, taps)``: the inputs of each
    block's ``mat_qkv``, ``proj``, ``fc1`` and ``fc2`` stacked over depth
    (``[depth, B, l, C]``, fc2's ``4C`` wide), as the JAX package's block
    scan stacks them.  ``remat`` runs each block under
    ``torch.utils.checkpoint``: the backward pass recomputes the block
    from its input instead of keeping its activations."""
    blocks = params["blocks"]
    mixed = qrt is not None and qrt.mixed_act_q is not None
    per_block = []
    for i in range(cfg.depth):
        ci = None
        if cache is not None:
            ci = {kn: leaf[i] for kn, leaf in cache.items()}
        args = (x, block_params(blocks, i), mod[i],
                qrt.for_block(i) if mixed else qrt, cfg, ci, cur, attn_bias)
        if not (capture or remat):
            x = block_forward(*args)
            continue
        if remat:
            # a block draws no random numbers: no RNG state to keep
            x, taps = checkpoint(_block_with_taps, capture, *args,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            x, taps = _block_with_taps(capture, *args)
        per_block.append(taps)
    if not capture:
        return x
    return x, {kind: torch.stack([t[kind] for t in per_block])
               for kind in per_block[0]}


def _block_with_taps(capture: bool, *args):
    """``block_forward(*args)`` and its taps (None without ``capture``)."""
    taps = {} if capture else None
    return block_forward(*args, taps=taps), taps


# ---------------------------------------------------------------------------
# Teacher-forcing forward
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def attn_bias_for_masking(cfg: VARConfig, device) -> torch.Tensor:
    """The block-triangular mask by scale, ``[1, 1, L, L]`` float32: 0
    where the key's scale is not after the query's, ``-inf`` elsewhere.
    Built once per (cfg, device)."""
    d = lvl_1L(cfg)
    bias = np.where(d[:, None] >= d[None, :], 0.0, -np.inf)
    with torch.inference_mode(False):
        return torch.from_numpy(bias[None, None].astype(np.float32)).to(
            device)


def var_forward(params, cfg: VARConfig, qrt, label_B: torch.Tensor,
                x_BLCv_wo_first_l: torch.Tensor,
                remat: bool = False) -> torch.Tensor:
    """Teacher-forcing forward, logits ``[B, L, V]`` float32: the class
    embedding plus ``pos_start`` for the first scale, ``word_embed`` of the
    teacher-forcing input ``[B, L - first_l, Cvae]`` for the rest, level
    and position embeddings, every block under the mask, the head.  No
    label dropout (the trainer applies it).  The blocks run in the dtype
    of the embeddings (bf16 params give a bf16 forward); ``remat`` as in
    :func:`run_blocks`."""
    b = x_BLCv_wo_first_l.shape[0]
    device = x_BLCv_wo_first_l.device
    cond_BD = params["class_emb"][label_B]
    sos = (cond_BD[:, None, :] + params["pos_start"]).expand(
        b, cfg.first_l, cfg.width)
    we = params["word_embed"]
    tok = linear(x_BLCv_wo_first_l.to(torch.float32), we["w"], we["b"])
    x = torch.cat([sos, tok.to(sos.dtype)], dim=1)
    x = (x + params["lvl_embed"][_lvl_index(cfg, device)][None]
         + params["pos_1LC"])
    mod = compute_modulations(params, cfg, cond_BD, qrt)
    x = run_blocks(params, cfg, qrt, x, mod,
                   attn_bias=attn_bias_for_masking(cfg, device), remat=remat)
    return head_logits(params, cfg, x.to(torch.float32), cond_BD,
                       _mesh_of(qrt))


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
                  device="cuda", kv_codec=None, heads: Optional[int] = None):
    """Preallocated KV cache, written in place one scale step at a time.

    Dense: {"k","v"} in ``dtype`` at [depth, B, L, H*c].  Packed (a
    ``kv_codec``): {"kc","vc"} int8 codes at [depth, B, H, L, c] and
    {"ks","vs"} float32 per-(token, head) scales at [depth, B, H, L],
    head-major as JAX's, so that attention reads ``[B, H, M, c]`` views.
    JAX splits the packed cache into one segment per scale because XLA
    would not update a large buffer in place; PyTorch does, so the port
    keeps one buffer per leaf, as for the dense cache.  ``heads``: the
    heads the cache holds (a tensor-parallel rank's ``cfg.heads / tp``;
    default all)."""
    heads = cfg.heads if heads is None else heads
    if kv_codec is None:
        shape = (cfg.depth, batch, cfg.L, heads * cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    lead = (cfg.depth, batch, heads, cfg.L)
    codes = lead + (cfg.head_dim,)
    return {"kc": torch.zeros(codes, dtype=torch.int8, device=device),
            "vc": torch.zeros(codes, dtype=torch.int8, device=device),
            "ks": torch.zeros(lead, dtype=torch.float32, device=device),
            "vs": torch.zeros(lead, dtype=torch.float32, device=device)}


def scale_step(params, vae_qparams, cfg: VARConfig, qrt, gen: GenerateConfig,
               st: GenStatics, x, cond_BD, mod, lvl_pos, cache, f_hat,
               generator: Optional[Generators], noise=None):
    """One scale: transformer -> logits -> CFG -> sample -> residual
    pyramid -> the next scale's token map.  Returns (next x or None at the
    last scale, f_hat).

    ``generator`` is one ``torch.Generator`` for the whole batch or one per
    row (JAX's single key or ``[B, 2]`` per-row keys); each draws the
    sample's noise first, then, under ``more_smooth``, the soft blend's, in
    the order JAX splits its keys.  ``noise``, this scale's ``(sample,
    blend)`` pair of a ``sampling.noise_plan``, takes the generator's
    place."""
    b = x.shape[0] // 2
    x = run_blocks(params, cfg, qrt, x, mod, cache, st.cur)
    logits = head_logits(params, cfg, x.to(torch.float32), cond_BD,
                         _mesh_of(qrt))
    t = gen.cfg * (st.si / (cfg.num_scales - 1))
    logits = (1.0 + t) * logits[:b] - t * logits[b:]
    sample_noise, blend_noise = noise if noise is not None else (None, None)
    idx_Bl = sample_with_top_k_top_p(logits, gen.top_k, gen.top_p, generator,
                                     gumbel=sample_noise)
    if gen.more_smooth:
        # the Gumbel-softmax blend of the codebook; the index above is still
        # drawn (and dropped) so that the noise stream matches the default
        # mode's
        ratio = st.si / (cfg.num_scales - 1)
        gum_t = max(0.27 * (1.0 - ratio * 0.95), 0.005)
        soft = gumbel_softmax(logits * (1.0 + ratio), gum_t, generator,
                              gumbel=blend_noise)
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


def prepare_generation(params, cfg: VARConfig, label_B: torch.Tensor,
                       qrt=None):
    """Condition embeddings, modulations and the first token map."""
    uncond = torch.full_like(label_B, cfg.num_classes)
    cond_BD = params["class_emb"][torch.cat([label_B, uncond])]
    lvl = _lvl_index(cfg, label_B.device)
    lvl_pos = params["lvl_embed"][lvl][None] + params["pos_1LC"]
    first = (cond_BD[:, None, :] + params["pos_start"]
             + lvl_pos[:, : cfg.first_l])
    mod = compute_modulations(params, cfg, cond_BD, qrt)
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
    outputs depend on the block internals.  With ``shared_aln`` the blocks
    hold ``ada_gss`` (standard normal / sqrt(C)) in place of ``ada_lin``,
    and the tree a ``shared_ada_lin``."""
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
    }
    if cfg.shared_aln:
        z = torch.randn((d, 6, c), generator=gen, device=device)
        blocks["ada_gss"] = (z / math.sqrt(c)).to(dtype)
    else:
        blocks["ada_lin"] = {"w": tn((d, 6 * c, c), adaln_gamma_std),
                             "b": zeros(d, 6 * c)}
    params = {
        "word_embed": lin_init(c, cvae),
        "class_emb": tn((cfg.num_classes + 1, c)),
        "pos_start": tn((1, cfg.first_l, c)),
        "pos_1LC": tn((1, cfg.L, c)),
        "lvl_embed": tn((cfg.num_scales, c)),
        "blocks": blocks,
        "head_nm": lin_init(2 * c, c),
        "head": lin_init(v, c),
    }
    if cfg.shared_aln:
        params["shared_ada_lin"] = lin_init(6 * c, c)
    return params
