"""Quantized linears on the int8 GEMM kernels K1, K5, K3 and K4.

``int8_group_gemm`` (K1) computes the grouped-scale product

    y[m,n] = sum_g  sa[m,g] * sw[g,n] * sum_{k in g} ac[m,k] * wc[n,k]

with f32 output; ``int8_group_gemm_nd`` (K5) computes the same sum over
``[B, T, K]`` activation codes and writes it once in the caller's dtype
(bfloat16 or float32).  The ``int8`` recipe runs K5 on its single-grid
linears (qkv, proj, fc1) and K1 on fc2's two dual-grid halves, whose f32
sums are added before the cast.  The per-channel recipes
(``int8ch``, ``int8chs``, ``int8chsnr``) keep one scale per activation row
and one per weight column, so the whole K depth is one exact int32 dot:

    y[m,n] = (float(sum_k ac[m,k] * wc[n,k]) * sa[m]) * sw[n]

``int8ch_gemm`` (K3) takes activation codes that are already quantized
(fc2's dual grid); ``fused_ch_gemm`` (K4) quantizes each activation row
once in its first kernel (phase (a), whose plain version is
``fused_ch_quantize_ref``) into scratch codes that its second kernel, the
s8 GEMM (phase (b)), reads.  On a CUDA
tensor each wrapper launches its hand-written Hopper kernel
(``csrc/int8_group_gemm.cu``, ``csrc/int8_nd_gemm.cu``,
``csrc/int8ch_gemm.cu``, ``csrc/fused_ch_gemm.cu``: the ports of the TPU
kernels of ``fpqvar_tpu/ops/pallas/int8_matmul.py`` ``_int8_matmul_2d``,
``_int8_matmul_3d``, ``_int8ch_matmul_2d`` and ``_fused_ch_matmul_2d``) or
raises; on a CPU tensor it runs its plain version.  ``launches``,
``nd_launches``, ``ch_launches`` and ``fused_launches`` count the launches
of K1, K5, K3 and K4.

``wonly_dot`` is the weights-only (``w4a16``) product, plain PyTorch as
JAX's ``_wonly_dot`` is plain XLA.

Under a ``{dp, tp}`` mesh (``int8_linear(mesh=, parallel=)``) the linears
take JAX's ``shard_map`` routes on this rank's shard of the weight: the
whole activation quantized first, then K1 (per group) or K3 (per channel)
on the rank's columns or K-slice, never K5 or K4.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from fpqvar_tpu_torch.ops import _build
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quantizers as Q
from fpqvar_tpu_torch.ops._checks import (bf16_gap, check_cuda_layout,
                                          check_device)

#: K chunk of the kernels: K and every group are multiples of it
KERNEL_K = 128

#: number of K1 kernel launches in this process
launches = 0
#: number of K5 kernel launches in this process
nd_launches = 0
#: number of K3 kernel launches in this process
ch_launches = 0
#: number of K4 kernel launches in this process
fused_launches = 0

#: K up to which every partial sum of a code dot is an integer below 2^24
#: (|code| <= 64 on both sides: 64 * 64 * 4096 = 2^24), so a float32 dot
#: is exact in any summation order
EXACT_F32_K = 4096

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def int8_group_gemm_ref(acodes, ascales, wcodes, wscales, group_size: int):
    """Plain PyTorch version of K1, mirroring the JAX ``_jnp_reference``.

    acodes [M, K] int8, ascales [M, G] f32, wcodes [N, K] int8,
    wscales [G, N] f32 -> [M, N] f32.  The group dots run as one f32
    ``bmm`` over ``[G, M, gs] x [G, gs, N]``: the products are integers of
    magnitude <= 64*64 and every partial sum stays below 2^24, so the f32
    (and even TF32) dot is exact for K <= 4096."""
    part = _group_parts(acodes, wcodes, group_size)
    return (part * ascales.t()[:, :, None] * wscales[:, None, :]).sum(0)


def _group_parts(acodes, wcodes, group_size: int):
    """The exact group dots as f32 ``[G, M, N]``."""
    m, k = acodes.shape
    n = wcodes.shape[0]
    g = k // group_size
    a = acodes.reshape(m, g, group_size).transpose(0, 1).to(torch.float32)
    w = wcodes.reshape(n, g, group_size).permute(1, 2, 0).to(torch.float32)
    return torch.bmm(a, w)


#: The int32 group parts are exact on both sides, so the kernel and the
#: plain version differ only in the order (and fusing) of the f32 sum over
#: G <= 32 groups: at most about (G + 2) * 2^-24 of the sum of the terms'
#: magnitudes, which this covers with a margin of five.
K1_REL_TOL = 1e-5


def int8_group_gemm_tolerance(acodes, ascales, wcodes, wscales,
                              group_size: int):
    """Per-element bound on |kernel - plain|:
    ``K1_REL_TOL * sum_g |sa*sw*part|``."""
    part = _group_parts(acodes, wcodes, group_size).abs()
    return K1_REL_TOL * (part * ascales.abs().t()[:, :, None]
                         * wscales.abs()[:, None, :]).sum(0)


def _check(acodes, ascales, wcodes, wscales, group_size: int):
    if acodes.dim() != 2 or wcodes.dim() != 2:
        raise ValueError("acodes [M, K] and wcodes [N, K] must be 2-D")
    m, k = acodes.shape
    n = wcodes.shape[0]
    if wcodes.shape[1] != k:
        raise ValueError(f"K mismatch: acodes {tuple(acodes.shape)}, "
                         f"wcodes {tuple(wcodes.shape)}")
    if k % KERNEL_K or group_size % KERNEL_K or k % group_size:
        raise ValueError(f"K={k} and group_size={group_size} must be "
                         f"multiples of {KERNEL_K}, with K % group_size == 0")
    g = k // group_size
    if tuple(ascales.shape) != (m, g) or tuple(wscales.shape) != (g, n):
        raise ValueError(
            f"scales must be ascales [{m}, {g}] and wscales [{g}, {n}], got "
            f"{tuple(ascales.shape)} and {tuple(wscales.shape)}")
    if acodes.dtype != torch.int8 or wcodes.dtype != torch.int8:
        raise TypeError("codes must be int8")
    if ascales.dtype != torch.float32 or wscales.dtype != torch.float32:
        raise TypeError("scales must be float32")
    check_device(acodes, ascales, wcodes, wscales)


def _lib():
    """``csrc/int8_group_gemm.cu``: codes, scales, out, M, N, K, group."""
    return _build.load("int8_group_gemm",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4)


def int8_group_gemm(acodes, ascales, wcodes, wscales, group_size: int = 128):
    """K1: grouped-scale int8 GEMM -> [M, N] f32 (shapes as in
    ``int8_group_gemm_ref``)."""
    global launches
    _check(acodes, ascales, wcodes, wscales, group_size)
    dev = acodes.device
    if dev.type == "cpu":
        return int8_group_gemm_ref(acodes, ascales, wcodes, wscales,
                                   group_size)
    check_cuda_layout("int8_group_gemm", acodes, ascales, wcodes, wscales,
                      aligned=(acodes, wcodes))
    m, k = acodes.shape
    n = wcodes.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    _build.launch(_lib(), "int8_group_gemm", dev, acodes.data_ptr(),
                  ascales.data_ptr(), wcodes.data_ptr(), wscales.data_ptr(),
                  out.data_ptr(), m, n, k, group_size)
    launches += 1
    return out


# ---------------------------------------------------------------------------
# K5: the grouped GEMM over [B, T, K], written once in the output dtype
# ---------------------------------------------------------------------------

def int8_group_gemm_nd_ref(ac, asc, wc, ws, group_size: int,
                           out_dtype=torch.bfloat16):
    """Plain PyTorch version of K5: ``int8_group_gemm_ref`` on the
    flattened ``[B*T, K]`` rows, cast to ``out_dtype``.

    ac [B, T, K] int8, asc [B, T, G] f32, wc [N, K] int8, ws [G, N] f32 ->
    [B, T, N] ``out_dtype`` (bfloat16 or float32)."""
    b, t, k = ac.shape
    out = int8_group_gemm_ref(ac.reshape(b * t, k),
                              asc.reshape(b * t, asc.shape[-1]), wc, ws,
                              group_size)
    return out.to(out_dtype).reshape(b, t, wc.shape[0])


def int8_group_gemm_nd_tolerance(ac, asc, wc, ws, group_size: int,
                                 out_dtype=torch.bfloat16):
    """Per-element bound on |kernel - plain| for K5: K1's ``K1_REL_TOL *
    sum_g |sa*sw*part|`` (the f32 sums differ only in their order), plus,
    for a bfloat16 output, one bfloat16 gap (:func:`bf16_gap`)."""
    b, t, k = ac.shape
    tol = int8_group_gemm_tolerance(ac.reshape(b * t, k),
                                    asc.reshape(b * t, asc.shape[-1]), wc,
                                    ws, group_size).reshape(b, t, -1)
    if out_dtype == torch.bfloat16:
        plain = int8_group_gemm_nd_ref(ac, asc, wc, ws, group_size, out_dtype)
        tol = tol + bf16_gap(plain, tol)
    return tol


def _check_nd(ac, asc, wc, ws, group_size: int):
    if ac.dim() != 3 or asc.dim() != 3:
        raise ValueError("ac [B, T, K] and asc [B, T, G] must be 3-D")
    b, t, k = ac.shape
    if tuple(asc.shape[:2]) != (b, t):
        raise ValueError(f"asc must be [{b}, {t}, G], got "
                         f"{tuple(asc.shape)}")
    _check(ac.reshape(b * t, k), asc.reshape(b * t, asc.shape[-1]), wc, ws,
           group_size)


def _nd_lib():
    """``csrc/int8_nd_gemm.cu``: codes, scales, out, B, T, N, K, group,
    out_bf16."""
    return _build.load("int8_nd_gemm",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6)


def int8_group_gemm_nd(ac, asc, wc, ws, group_size: int = 128,
                       out_dtype=torch.bfloat16):
    """K5: grouped-scale int8 GEMM over ``[B, T, K]`` codes, the f32 sum
    written once as ``out_dtype`` -> [B, T, N] (shapes as in
    ``int8_group_gemm_nd_ref``).  The kernel walks the ``B*T`` rows as one
    matrix; B and T only shape the output."""
    global nd_launches
    _check_nd(ac, asc, wc, ws, group_size)
    _check_out_dtype(out_dtype)
    dev = ac.device
    if dev.type == "cpu":
        return int8_group_gemm_nd_ref(ac, asc, wc, ws, group_size, out_dtype)
    check_cuda_layout("int8_group_gemm_nd", ac, asc, wc, ws,
                      aligned=(ac, wc))
    b, t, k = ac.shape
    n = wc.shape[0]
    out = torch.empty((b, t, n), dtype=out_dtype, device=dev)
    if b * t == 0:
        return out
    _build.launch(_nd_lib(), "int8_nd_gemm", dev, ac.data_ptr(),
                  asc.data_ptr(), wc.data_ptr(), ws.data_ptr(),
                  out.data_ptr(), b, t, n, k, group_size,
                  int(out_dtype == torch.bfloat16))
    nd_launches += 1
    return out


# ---------------------------------------------------------------------------
# Per-channel int8 GEMMs: K3 and K4
# ---------------------------------------------------------------------------

def channel_dot_ref(ac, asc, wc, ws):
    """Plain version of JAX's ``_channel_dot``: ``(float(ac . wc) * asc) *
    ws`` in float32, the two multiplies in that order.

    ac [M, K] int8, asc [M, 1] f32, wc [N, K] int8, ws [1, N] f32 -> [M, N]
    f32.  The integer dot runs as a float32 matmul up to ``EXACT_F32_K``
    (every partial sum is an integer below 2^24, exact in any order) and as
    a float64 one beyond; either way it is the exact int32 dot, converted
    to float32 as JAX converts its int32 result."""
    dt = torch.float32 if ac.shape[-1] <= EXACT_F32_K else torch.float64
    p = (ac.to(dt) @ wc.to(dt).T).to(torch.float32)
    return (p * asc) * ws


def _check_ch(ac, asc, wc, ws):
    if ac.dim() != 2 or wc.dim() != 2:
        raise ValueError("ac [M, K] and wc [N, K] must be 2-D")
    m, k = ac.shape
    n = wc.shape[0]
    if wc.shape[1] != k:
        raise ValueError(f"K mismatch: ac {tuple(ac.shape)}, "
                         f"wc {tuple(wc.shape)}")
    if k % KERNEL_K:
        raise ValueError(f"K={k} must be a multiple of {KERNEL_K}")
    if tuple(asc.shape) != (m, 1) or tuple(ws.shape) != (1, n):
        raise ValueError(f"scales must be asc [{m}, 1] and ws [1, {n}], got "
                         f"{tuple(asc.shape)} and {tuple(ws.shape)}")
    if ac.dtype != torch.int8 or wc.dtype != torch.int8:
        raise TypeError("codes must be int8")
    if asc.dtype != torch.float32 or ws.dtype != torch.float32:
        raise TypeError("scales must be float32")
    check_device(ac, asc, wc, ws)


def _check_out_dtype(out_dtype):
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")


def int8ch_gemm_ref(ac, asc, wc, ws, out_dtype=torch.float32):
    """Plain version of K3: ``channel_dot_ref`` cast to ``out_dtype``."""
    return channel_dot_ref(ac, asc, wc, ws).to(out_dtype)


def _ch_lib():
    """``csrc/int8ch_gemm.cu``: codes, scales, out, M, N, K, out_bf16."""
    return _build.load("int8ch_gemm",
                       [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4)


def int8ch_gemm(ac, asc, wc, ws, out_dtype=torch.float32):
    """K3: full-K int8 GEMM with the per-row and per-column rescale fused
    into its epilogue -> [M, N] ``out_dtype`` (float32 or bfloat16;
    operands as in ``channel_dot_ref``)."""
    global ch_launches
    _check_ch(ac, asc, wc, ws)
    _check_out_dtype(out_dtype)
    dev = ac.device
    if dev.type == "cpu":
        return int8ch_gemm_ref(ac, asc, wc, ws, out_dtype)
    check_cuda_layout("int8ch_gemm", ac, asc, wc, ws, aligned=(ac, wc))
    m, k = ac.shape
    n = wc.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    _build.launch(_ch_lib(), "int8ch_gemm", dev, ac.data_ptr(),
                  asc.data_ptr(), wc.data_ptr(), ws.data_ptr(),
                  out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16))
    ch_launches += 1
    return out


def fused_ch_quantize_ref(x, fmt: str):
    """Plain version of K4's phase (a): each row of ``x [M, K]`` quantized
    once over its whole K, ``quant_int_codes(x, fmt, K)`` -> (codes int8
    ``[M, K]``, output scales ``scale / mult`` f32 ``[M, 1]``)."""
    return P.quant_int_codes(x, fmt, x.shape[-1])


def fused_ch_gemm_ref(x, wc, ws, fmt: str, out_dtype=torch.float32):
    """Plain version of K4: phase (a) (``fused_ch_quantize_ref``), then
    phase (b), K3's function (``int8ch_gemm_ref``) on those codes."""
    ac, asc = fused_ch_quantize_ref(x, fmt)
    return int8ch_gemm_ref(ac, asc, wc, ws, out_dtype)


@functools.lru_cache(maxsize=None)
def _grid_table(fmt: str):
    """What K4 needs of a format: (midpoints in grid units as float32 --
    the values ``quant_int_codes`` compares ``x / scale`` against --, the
    integer code of every grid value, ``f32(1 / max|grid|)``, the code
    multiplier)."""
    grid = np.asarray(G.GRIDS[fmt], np.float32)
    mult = P.CODE_MULT[fmt]
    mids = ((grid[1:] + grid[:-1]) * np.float32(0.5)).astype(np.float32)
    codes = np.round(grid * np.float32(mult)).astype(np.int32)
    return mids, codes, Q.inv_max(grid), float(mult)


def _check_fused(x, wc, ws, fmt: str):
    if fmt not in P.CODE_MULT:
        raise ValueError(f"K4 quantizes {sorted(P.CODE_MULT)}, got {fmt!r}")
    if x.dim() != 2 or wc.dim() != 2:
        raise ValueError("x [M, K] and wc [N, K] must be 2-D")
    m, k = x.shape
    n = wc.shape[0]
    if wc.shape[1] != k:
        raise ValueError(f"K mismatch: x {tuple(x.shape)}, "
                         f"wc {tuple(wc.shape)}")
    if k % KERNEL_K:
        raise ValueError(f"K={k} must be a multiple of {KERNEL_K}")
    if tuple(ws.shape) != (1, n):
        raise ValueError(f"ws must be [1, {n}], got {tuple(ws.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if wc.dtype != torch.int8:
        raise TypeError("codes must be int8")
    if ws.dtype != torch.float32:
        raise TypeError("scales must be float32")
    check_device(x, wc, ws)


def _fused_lib():
    """``csrc/fused_ch_gemm.cu``: x, weight codes, weight scales, scratch
    codes, scratch row scales, out, M, N, K, x_bf16, out_bf16, then the
    grid tables (host pointers, copied into the kernel's arguments), their
    length, 1/gmax and the multiplier."""
    return _build.load("fused_ch_gemm",
                       [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_float, ctypes.c_float])


def fused_ch_gemm(x, wc, ws, fmt: str, out_dtype=torch.float32):
    """K4: per-row quantize ``x [M, K]`` (bfloat16 or float32) to ``fmt``
    codes, each row once (phase (a)), then the full-K int8 GEMM against
    ``wc [N, K]`` with the rescale fused (phase (b)) -> [M, N]
    ``out_dtype``.  The codes and row scales go through scratch that this
    wrapper allocates; one call is one launch of the pair."""
    global fused_launches
    _check_fused(x, wc, ws, fmt)
    _check_out_dtype(out_dtype)
    dev = x.device
    if dev.type == "cpu":
        return fused_ch_gemm_ref(x, wc, ws, fmt, out_dtype)
    check_cuda_layout("fused_ch_gemm", x, wc, ws, aligned=(x, wc))
    m, k = x.shape
    n = wc.shape[0]
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if m == 0:
        return out
    codes_scratch = torch.empty((m, k), dtype=torch.int8, device=dev)
    rs_scratch = torch.empty((m,), dtype=torch.float32, device=dev)
    mids, codes, inv, mult = _grid_table(fmt)
    _build.launch(_fused_lib(), "fused_ch_gemm", dev, x.data_ptr(),
                  wc.data_ptr(), ws.data_ptr(), codes_scratch.data_ptr(),
                  rs_scratch.data_ptr(), out.data_ptr(), m, n, k,
                  int(x.dtype == torch.bfloat16),
                  int(out_dtype == torch.bfloat16), mids.ctypes.data,
                  codes.ctypes.data, len(mids), inv, mult)
    fused_launches += 1
    return out


# ---------------------------------------------------------------------------
# Weights-only product (w4a16)
# ---------------------------------------------------------------------------

def wonly_dot(x, wc, ws, group_size: int):
    """JAX's ``_wonly_dot``: ``x [..., K]`` (rounded to bfloat16, as JAX
    rounds it whatever the compute dtype) times int weight codes ``wc
    [N, K]`` with scales ``ws [G, N]`` -> float32 ``[..., N]``.

    Per channel (``group_size == K``): ``(x_bf16 @ codes) * ws``.  Per
    group: ``codes * ws[g]`` rounded to bfloat16, then one product.  JAX
    takes the product in float32 (``preferred_element_type``); here it is a
    float32 matmul over the bfloat16 values, whose products are exact, so
    the two differ only in the order of the float32 sums."""
    n, k = wc.shape
    xb = x.to(torch.bfloat16).to(torch.float32)
    if group_size == k:
        return (xb @ wc.to(torch.float32).T) * ws
    g = k // group_size
    wdq = (wc.reshape(n, g, group_size).to(torch.float32)
           * ws.T[:, :, None]).to(torch.bfloat16).reshape(n, k)
    return xb @ wdq.to(torch.float32).T


# ---------------------------------------------------------------------------
# Linears, routed as JAX's int8_linear / int8_linear_dual
# ---------------------------------------------------------------------------

def _call(ac, asc, wc, ws, group_size: int):
    """JAX's ``_call`` on codes quantized outside the GEMM -> f32: K3 per
    channel (one scale group, JAX's ``_channel_dot``), K1 per group."""
    if group_size == ac.shape[-1]:
        return int8ch_gemm(ac, asc, wc, ws)
    return int8_group_gemm(ac, asc, wc, ws, group_size)


def _int_dot(ac, wc):
    """The exact int32 product ``ac [M, K] . wc [N, K]^T`` of codes, as a
    float matmul (``channel_dot_ref``'s rule for its exactness)."""
    dt = torch.float32 if ac.shape[-1] <= EXACT_F32_K else torch.float64
    return (ac.to(dt) @ wc.to(dt).T).to(torch.int32)


def _mesh_codes_gemm(ac, asc, pw: P.IntPack, mesh, parallel: str):
    """JAX's ``_shard_mapped``, then ``_call`` where it returns None, on
    codes ``ac [M, K]`` of the whole activation and this rank's shard of
    ``pw`` -> f32, the whole ``[M, N]`` output on every rank of the tp row
    but for a column split:

    - column split: the rank's columns ``[M, N / tp]`` (K1 per group, K3
      per channel), which ``collectives.linear_out`` gathers;
    - row split, per channel: the int32 product of the K-slices, summed
      exactly over tp, then ``* asc * ws`` once (plain, as JAX's
      ``dot_general``);
    - row split, per group: K1 on the rank's K-slice and scale groups,
      the f32 partials summed over tp;
    - a replicated pack: the whole GEMM."""
    from fpqvar_tpu_torch.parallel import collectives as C
    from fpqvar_tpu_torch.parallel.mesh import linear_split

    gs = pw.group_size
    if parallel == "col" or not linear_split(pw, parallel, mesh.tp):
        return _call(ac, asc, pw.codes, pw.scales, gs)
    acl = C.take_slice(ac, mesh)
    if gs == pw.shape[-1]:
        p = C.int_sum(_int_dot(acl, pw.codes), mesh)
        return (p.to(torch.float32) * asc) * pw.scales
    return C.sum_partials(int8_group_gemm(acl, C.take_slice(asc, mesh),
                                          pw.codes, pw.scales, gs), mesh)


def _mesh_wonly(x2, pw: P.IntPack, mesh, parallel: str):
    """JAX's ``_wonly_shard_mapped`` (then the whole product where it
    returns None) -> f32: the rank's columns (gathered by
    ``collectives.linear_out``), or the whole ``[M, N]`` output, the
    K-slices' f32 partials summed over tp (per channel, scaled once after
    the sum)."""
    from fpqvar_tpu_torch.parallel import collectives as C
    from fpqvar_tpu_torch.parallel.mesh import linear_split

    gs, k = pw.group_size, pw.shape[-1]
    if not linear_split(pw, parallel, mesh.tp):
        return wonly_dot(x2, pw.codes, pw.scales, gs)
    if parallel == "col":
        return wonly_dot(C.copy_to_tp(x2, mesh), pw.codes, pw.scales, gs)
    xl = C.take_slice(x2, mesh)
    if gs == k:
        xb = xl.to(torch.bfloat16).to(torch.float32)
        p = C.sum_partials(xb @ pw.codes.to(torch.float32).T, mesh)
        return p * pw.scales
    return C.sum_partials(wonly_dot(xl, pw.codes, pw.scales, gs), mesh)


def _mesh_out(out, x, pw: P.IntPack, b, mesh, parallel: str):
    """A mesh route's f32 ``out`` in ``x.dtype``, with the bias and the
    column gather of ``collectives.linear_out``, as ``[..., N]``."""
    from fpqvar_tpu_torch.parallel import collectives as C
    from fpqvar_tpu_torch.parallel.mesh import linear_split

    y = C.linear_out(out.to(x.dtype), b, mesh, parallel,
                     linear_split(pw, parallel, mesh.tp))
    return y.reshape(x.shape[:-1] + (pw.shape[0],))


def _with_bias(y, b):
    return y if b is None else y + b.to(y.dtype)


def int8_linear(x, pw: P.IntPack, act_fmt: str = None, *, mesh=None,
                parallel: str = None, b=None):
    """The linear of an int8 weight pack on ``x [..., K]`` -> ``[..., N]``
    in ``x.dtype``, routed as JAX's ``int8_linear``:

    - ``act_fmt == "bf16"`` (weights only): ``wonly_dot``;
    - one scale per weight column (``group_size == K``): K4 quantizes each
      row of ``x`` per token and runs the full-K GEMM;
    - per group: ``quant_int_codes`` per group of ``x [..., K]``, then K5,
      which writes its f32 sum once in ``x.dtype`` (JAX runs K1 into f32
      and casts: the same numbers).

    ``act_fmt`` defaults to the weight format.  The kernels walk the rows
    of ``[..., K]`` as one ``[M, K]`` matrix; the integer dots are exact,
    so this gives JAX's N-D results bit for bit on the per-channel route
    and within the order of the f32 group sum on the grouped one.

    With a ``mesh`` (``parallel.Mesh``) and ``parallel`` ("col" or "row")
    the linear runs tensor-parallel on this rank's shard of ``pw`` and
    returns the whole output, as JAX's ``shard_map`` route: the whole
    activation is quantized first (``quant_int_codes``), then the GEMM
    runs on codes (:func:`_mesh_codes_gemm`: K1 per group, K3 per
    channel, under any mesh), or the weights-only product
    (:func:`_mesh_wonly`).

    ``b``: the output's bias (under a column split, this rank's shard of
    it), added in ``x.dtype``; under a mesh before the columns are
    gathered (``collectives.linear_out``)."""
    n, k = pw.shape
    lead = x.shape[:-1]
    if mesh is not None and parallel is not None:
        x2 = x.reshape(-1, k)
        if act_fmt == "bf16":
            out = _mesh_wonly(x2, pw, mesh, parallel)
        else:
            ac, asc = P.quant_int_codes(x2, act_fmt or pw.fmt,
                                        pw.group_size)
            out = _mesh_codes_gemm(ac, asc, pw, mesh, parallel)
        return _mesh_out(out, x, pw, b, mesh, parallel)
    if act_fmt == "bf16":
        out = wonly_dot(x, pw.codes, pw.scales, pw.group_size)
        return _with_bias(out.to(x.dtype), b)
    fmt = act_fmt or pw.fmt
    if pw.group_size == k:
        out = fused_ch_gemm(x.reshape(-1, k).contiguous(), pw.codes,
                            pw.scales, fmt, x.dtype)
        return _with_bias(out.reshape(lead + (n,)), b)
    x3 = x.reshape((-1,) + x.shape[-2:]) if x.dim() > 2 else x.reshape(
        1, -1, k)
    ac, asc = P.quant_int_codes(x3, fmt, pw.group_size)
    out = int8_group_gemm_nd(ac, asc, pw.codes, pw.scales, pw.group_size,
                             x.dtype)
    return _with_bias(out.reshape(lead + (n,)), b)


def int8_linear_dual(x, pw: P.IntPack, act_fmt: str, *, mesh=None,
                     parallel: str = None, b=None):
    """fc2: dual-grid activation (separate negative/positive codes and
    scales) against single-grid weight codes.  Two GEMMs whose float32
    halves are summed before the cast to ``x.dtype``, as JAX sums them: K3
    per channel (``group_size == K``), K1 per group; with a ``mesh``, each
    half through :func:`_mesh_codes_gemm`, and ``b`` as in
    :func:`int8_linear`."""
    n, k = pw.shape
    x2 = x.reshape(-1, k)
    cn, sn, cp, sp = P.quant_int_codes_dual(x2, act_fmt, pw.group_size)
    if mesh is not None and parallel is not None:
        out = (_mesh_codes_gemm(cn, sn, pw, mesh, parallel)
               + _mesh_codes_gemm(cp, sp, pw, mesh, parallel))
        return _mesh_out(out, x, pw, b, mesh, parallel)
    if pw.group_size == k:
        out = (int8ch_gemm(cn, sn, pw.codes, pw.scales)
               + int8ch_gemm(cp, sp, pw.codes, pw.scales))
    else:
        out = (int8_group_gemm(cn, sn, pw.codes, pw.scales, pw.group_size)
               + int8_group_gemm(cp, sp, pw.codes, pw.scales, pw.group_size))
    return _with_bias(out.reshape(x.shape[:-1] + (n,)).to(x.dtype), b)
