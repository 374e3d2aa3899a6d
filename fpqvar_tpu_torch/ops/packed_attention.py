"""Attention over the packed KV cache's value codes on the hand-written
Hopper kernel A1 (``csrc/packed_attention.cu``).

The value-code branch of ``models/var.py`` ``_packed_attention`` (the
``int8kv`` recipe, and calibration capture under such a codec): for this
step's queries ``q [B, l, H, 64]`` over the cached codes ``kc, vc [B, H,
M, 64]`` int8 and their scales ``ks, vs [B, H, M]`` float32, the scores
``(q . kc) * ks`` in float32, their softmax over the ``M`` cached tokens,
and the weights times ``vs``, rounded to q's dtype, times ``vc``; out
``[B, l, H * 64]`` in q's dtype.  :func:`packed_attention_ref` is that
chain in plain PyTorch (the JAX package's einsums, softmax and cast) and
the route of a CPU tensor.  On a CUDA tensor :func:`packed_attention`
launches A1 or raises: for an ``attn_bias``, a head_dim other than 64, a
dtype or a layout the kernel does not take, or a tensor that autograd
would record (the kernel has no backward).  Nothing falls back.

A1 keeps the scores in registers (tiles of 64 cached tokens, ``mma.sync``
on bf16 operands, the codes converted to bf16 in shared memory, exact) in
two passes: each row's max and sum of ``exp(s - max)``, then the weights
``exp(s - max) / sum * vs`` rounded to q's dtype where the chain rounds
them, and their product with the codes.  A float32 ``q`` (and its
float32 weights) runs as three exact bf16 parts a value, each part's MMA
started from zero and added in IEEE float32.  :func:`tolerance` is the
bound the card's check holds A1 to, derived there.

``attn_launches`` counts A1's launches.
"""
from __future__ import annotations

import ctypes

import torch

from fpqvar_tpu_torch.ops import _build

#: number of A1 (packed_attention) kernel launches in this process
attn_launches = 0
#: the head_dim A1 takes (every VAR configuration's)
HEAD_DIM = 64
#: query rows a warp; a block takes up to MAX_WARPS warps
WARP_ROWS, MAX_WARPS = 16, 8
_GRID_MAX = 65535


def packed_attention_ref(q, kc, ks, vc, vs, attn_bias=None):
    """The plain chain: float32 scores ``(q . kc) * ks`` (plus
    ``attn_bias``), their softmax, the weights times ``vs`` cast to q's
    dtype and multiplied by ``vc`` in q's dtype.  ``[B, l, H*c]``."""
    b, l, h, c = q.shape
    scores = q.transpose(1, 2).to(torch.float32) @ kc.to(
        torch.float32).transpose(-1, -2)
    scores = scores * ks[:, :, None, :]
    if attn_bias is not None:
        scores = scores + attn_bias
    pv = (torch.softmax(scores, dim=-1) * vs[:, :, None, :]).to(q.dtype)
    return (pv @ vc.to(q.dtype)).transpose(1, 2).reshape(b, l, h * c)


def warps_for(l: int) -> int:
    """A1's warps a block for ``l`` queries: one 16-row warp a 16 queries,
    at most :data:`MAX_WARPS`, so that the first scales fill no 64-row
    tile a query and the last share each code tile among 128 queries."""
    return max(1, min(MAX_WARPS, -(-l // WARP_ROWS)))


def check_operands(q, kc, ks, vc, vs, attn_bias=None) -> None:
    """Raise unless A1 takes these operands as they are: no
    ``attn_bias``; q bfloat16 or float32 ``[B, l, H, 64]`` with head_dim
    contiguous, even strides and an aligned start; kc and vc int8 ``[B, H,
    M, 64]`` with the same strides, rows of 64 contiguous, 16-byte aligned;
    ks and vs float32 ``[B, H, M]`` with the same strides, tokens
    contiguous; one device; nothing that autograd would record."""
    if attn_bias is not None:
        raise ValueError("A1 takes no attn_bias (generation passes none; "
                         "the masked teacher-forcing forward keeps no cache)")
    if q.dim() != 4 or kc.dim() != 4 or ks.dim() != 3:
        raise ValueError(f"A1: q [B, l, H, c], codes [B, H, M, c], scales "
                         f"[B, H, M]; got {tuple(q.shape)}, "
                         f"{tuple(kc.shape)}, {tuple(ks.shape)}")
    b, l, h, c = q.shape
    if c != HEAD_DIM:
        raise ValueError(f"A1 takes head_dim {HEAD_DIM}, got {c}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"A1 takes bfloat16 or float32 q, got {q.dtype}")
    if kc.dtype != torch.int8 or vc.dtype != torch.int8:
        raise TypeError(f"A1 takes int8 codes, got {kc.dtype}, {vc.dtype}")
    if ks.dtype != torch.float32 or vs.dtype != torch.float32:
        raise TypeError(f"A1 takes float32 scales, got {ks.dtype}, "
                        f"{vs.dtype}")
    m = kc.shape[2]
    if (tuple(kc.shape) != (b, h, m, c) or vc.shape != kc.shape
            or tuple(ks.shape) != (b, h, m) or vs.shape != ks.shape):
        raise ValueError(f"A1: q {tuple(q.shape)}, codes {tuple(kc.shape)} "
                         f"/ {tuple(vc.shape)}, scales {tuple(ks.shape)} / "
                         f"{tuple(vs.shape)} do not agree")
    if l < 1 or m < 1 or b > _GRID_MAX or h > _GRID_MAX:
        raise ValueError(f"A1: {l} queries over {m} tokens, {b} rows, {h} "
                         "heads")
    devices = {t.device for t in (q, kc, ks, vc, vs)}
    if len(devices) != 1:
        raise ValueError(f"A1: operands on {sorted(map(str, devices))}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, kc, ks, vc, vs)):
        raise RuntimeError("A1 has no backward; generate under "
                           "torch.no_grad() or inference mode")
    if (q.stride(3) != 1 or any(s % 2 for s in q.stride()[:3])
            or q.data_ptr() % (2 * q.element_size())):
        raise ValueError(f"A1: q needs head_dim contiguous, even strides and "
                         f"an aligned start; strides {q.stride()}")
    if (kc.stride() != vc.stride() or kc.stride()[2:] != (c, 1)
            or any(s % 16 for s in kc.stride()[:2])
            or kc.data_ptr() % 16 or vc.data_ptr() % 16):
        raise ValueError(f"A1: codes need rows of {c} contiguous, 16-byte "
                         f"aligned, one layout for k and v; strides "
                         f"{kc.stride()} / {vc.stride()}")
    if (ks.stride() != vs.stride() or ks.stride(2) != 1
            or ks.data_ptr() % 4 or vs.data_ptr() % 4):
        raise ValueError(f"A1: scales need tokens contiguous, one layout for "
                         f"k and v; strides {ks.stride()} / {vs.stride()}")


def _lib():
    """``csrc/packed_attention.cu``: q, its strides (b, l, h), q_f32, kc,
    vc, their strides (b, h), ks, vs, their strides (b, h), out, batch,
    heads, l, end, warps."""
    ll, vp, i = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    return _build.load("packed_attention",
                       [vp, ll, ll, ll, i, vp, vp, ll, ll, vp, vp, ll, ll,
                        vp, i, i, i, i, i])


def run_kernel(q, kc, ks, vc, vs) -> torch.Tensor:
    """Launch A1 on checked CUDA operands (:func:`warps_for` warps a
    block) -> ``[B, l, H * 64]`` in q's dtype."""
    global attn_launches
    b, l, h, c = q.shape
    out = torch.empty((b, l, h * c), dtype=q.dtype, device=q.device)
    _build.launch(_lib(), "packed_attention", q.device, q.data_ptr(),
                  *q.stride()[:3], int(q.dtype == torch.float32),
                  kc.data_ptr(), vc.data_ptr(), *kc.stride()[:2],
                  ks.data_ptr(), vs.data_ptr(), *ks.stride()[:2],
                  out.data_ptr(), b, h, l, kc.shape[2], warps_for(l))
    attn_launches += 1
    return out


def packed_attention(q, kc, ks, vc, vs, attn_bias=None) -> torch.Tensor:
    """The value-code attention: :func:`packed_attention_ref` on the CPU,
    A1 on a card (or a raise, :func:`check_operands`)."""
    if q.device.type == "cpu":
        return packed_attention_ref(q, kc, ks, vc, vs, attn_bias)
    check_operands(q, kc, ks, vc, vs, attn_bias)
    return run_kernel(q, kc, ks, vc, vs)


def tolerance(q, kc, ks, vc, vs) -> torch.Tensor:
    """The bound A1's output is held to against the plain chain, per
    output value: ``(r + 2^-16 S + 2^-22 M) * sum_m |p_m vs_m vc_m| +
    2^-117 M``, with ``p`` the chain's float32 softmax, ``S`` the row's
    largest score magnitude sum ``sum_k |q_k kc_k| ks`` over its ``M``
    cached tokens, and ``r`` 2^-6 at bf16, 2^-19 at float32.  With u =
    2^-24:

    - An MMA on the H100's tensor cores (bf16 in, float32 sums) keeps its
      products exact, aligns its 17 terms (the accumulator's included) to
      the largest with two bits below its ulp, dropping the rest toward
      zero, and truncates the sum to float32: it loses under a quarter of
      the largest term's ulp a term and an ulp of the sum, at most
      10.5 u of its terms' magnitude sum (single MMAs on the card: at most
      8 ulps of the largest term, with or without an accumulator).
    - Scores.  The chain's float32 SGEMM over head_dim 64 loses at most
      64 u S in any order of its FFMAs, each side's product with ``ks``
      u S.  A1's bf16 route chains 4 MMAs a score (the accumulator a part
      of the same sum): 42 u S; its float32 route starts each of its 12
      MMAs (three exact bf16 parts of q) from zero, their terms summing to
      at most 1.01 S, and adds them in float32: 11 u S + 11 u S.  Scores
      differ by at most 108 u S, which the softmax carries into each
      weight twice, and the exponent's argument ``s - max`` rounds by at
      most 2 u S on each side: 2^-16 S.
    - Sums over the cached tokens.  The softmax's sum loses M u on each
      side (A1's rescaling of its running sum 6 u a tile of 64); the
      products with v at bf16 M / 16 chained MMAs on each side (10.5 u of
      the output's mass each); at float32 3 M / 16 MMAs from zero added in
      float32 (0.19 M u + 11 u) against the chain's SGEMM (M u): within
      2^-22 M, and with the exponentials (2 ulps), the division and the
      product with ``vs`` on each side, 2^-19 at float32.
    - Rounding to bf16: a weight or an output whose float32 value lands
      on the other side of a rounding point moves by one bf16 step, at
      most 2^-7 of it: 2^-6 at bf16.
    - Underflow: the tensor cores flush a bf16 operand or an MMA's sum
      below 2^-126 to zero where the chain's FFMAs keep it, so a weight
      loses under 3 x 2^-126 (its parts) times a code of at most 127, and
      an MMA 2^-126: 2^-117 M, absolute.  A peaked softmax leaves some
      outputs nothing but such weights (values near 1e-40, where a
      relative bound alone fails)."""
    b, l, h, c = q.shape
    qf, kf = q.transpose(1, 2).to(torch.float32), kc.to(torch.float32)
    p = torch.softmax((qf @ kf.transpose(-1, -2)) * ks[:, :, None, :],
                      dim=-1)
    mass = (p * vs[:, :, None, :]).abs() @ vc.to(torch.float32).abs()
    big = ((qf.abs() @ kf.abs().transpose(-1, -2)) * ks[:, :, None, :]
           ).amax(-1, keepdim=True)
    r = 2.0 ** -6 if q.dtype == torch.bfloat16 else 2.0 ** -19
    m = kc.shape[2]
    tol = (r + 2.0 ** -16 * big + 2.0 ** -22 * m) * mass + 2.0 ** -117 * m
    return tol.transpose(1, 2).reshape(b, l, h * c)
