"""Quantized linears on the grouped int8 GEMM (kernel K1).

``int8_group_gemm`` computes

    y[m,n] = sum_g  sa[m,g] * sw[g,n] * sum_{k in g} ac[m,k] * wc[n,k]

with f32 output.  On a CUDA tensor it launches the hand-written Hopper
kernel ``csrc/int8_group_gemm.cu`` (the port of the TPU kernel
``fpqvar_tpu/ops/pallas/int8_matmul.py`` ``_kernel`` / ``_int8_matmul_2d``)
or raises; on a CPU tensor it runs the plain version
``int8_group_gemm_ref``.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from fpqvar_tpu_torch.ops import _build
from fpqvar_tpu_torch.ops import packing as P

#: K chunk of the kernel: every group is a multiple of it
KERNEL_K = 128

#: number of K1 kernel launches in this process
launches = 0


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
    devs = {t.device for t in (acodes, ascales, wcodes, wscales)}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")


@functools.lru_cache(maxsize=None)
def _lib():
    """``csrc/int8_group_gemm.cu``, built on first use, with its C
    signatures."""
    lib = _build.load("int8_group_gemm")
    lib.int8_group_gemm.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                                    + [ctypes.c_void_p])
    lib.int8_group_gemm.restype = ctypes.c_int
    lib.int8_group_gemm_error_string.argtypes = [ctypes.c_int]
    lib.int8_group_gemm_error_string.restype = ctypes.c_char_p
    return lib


def int8_group_gemm(acodes, ascales, wcodes, wscales, group_size: int = 128):
    """K1: grouped-scale int8 GEMM -> [M, N] f32 (shapes as in
    ``int8_group_gemm_ref``)."""
    global launches
    _check(acodes, ascales, wcodes, wscales, group_size)
    dev = acodes.device
    if dev.type == "cpu":
        return int8_group_gemm_ref(acodes, ascales, wcodes, wscales,
                                   group_size)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ops = (acodes, ascales, wcodes, wscales)
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("int8_group_gemm operands must be contiguous")
    if acodes.data_ptr() % 16 or wcodes.data_ptr() % 16:
        raise ValueError("int8_group_gemm codes must be 16-byte aligned "
                         "(the kernel copies them in 16-byte chunks)")
    m, k = acodes.shape
    n = wcodes.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.int8_group_gemm(
            acodes.data_ptr(), ascales.data_ptr(), wcodes.data_ptr(),
            wscales.data_ptr(), out.data_ptr(), m, n, k, group_size, stream)
    if rc != 0:
        msg = lib.int8_group_gemm_error_string(rc).decode()
        raise RuntimeError(f"int8_group_gemm launch failed: {msg} ({rc})")
    launches += 1
    return out


def int8_linear(x, pw: P.IntPack, act_fmt: str = None):
    """Quantize the activation ``x [..., K]`` to int codes and run K1
    against the weight codes; returns ``[..., N]`` in ``x.dtype``.

    ``act_fmt`` defaults to the weight format.  With ``group_size == K``
    (one scale per row and one per column, which JAX sends to its
    ``_channel_dot``) K1 runs with G = 1: ``part * asc * ws`` is the same
    arithmetic in the same order."""
    if act_fmt == "bf16":
        raise NotImplementedError(
            "weights-only int8 linears (w4a16) are not ported yet "
            "(ROADMAP: per-channel int8ch* recipes and w4a16)")
    n, k = pw.shape
    x2 = x.reshape(-1, k)
    ac, asc = P.quant_int_codes(x2, act_fmt or pw.fmt, pw.group_size)
    out = int8_group_gemm(ac, asc, pw.codes, pw.scales, pw.group_size)
    return out.reshape(x.shape[:-1] + (n,)).to(x.dtype)


def int8_linear_dual(x, pw: P.IntPack, act_fmt: str):
    """fc2: dual-grid activation (separate negative/positive codes and
    scales) against single-grid weight codes, two K1 calls whose f32
    halves are summed before the cast to ``x.dtype``."""
    n, k = pw.shape
    x2 = x.reshape(-1, k)
    cn, sn, cp, sp = P.quant_int_codes_dual(x2, act_fmt, pw.group_size)
    out = (int8_group_gemm(cn, sn, pw.codes, pw.scales, pw.group_size)
           + int8_group_gemm(cp, sp, pw.codes, pw.scales, pw.group_size))
    return out.reshape(x.shape[:-1] + (n,)).to(x.dtype)
