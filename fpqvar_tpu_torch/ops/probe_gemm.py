"""The int8 rate probe's GEMM kernels, K6 and K7.

``int8_probe_gemm`` (K6) is a full-K s8 x s8 GEMM with an int32
accumulator, written as bfloat16 with no scales:

    y[m,n] = bf16(sum_k a[m,k] * b[n,k])

``bf16_probe_gemm`` (K7) is a bf16 x bf16 GEMM with float32 accumulators
and a bfloat16 output.  They are the ports of the Pallas kernels
``pallas_int8`` and ``pallas_bf16`` of ``scripts/int8_rate_probe.py``
(``csrc/int8_probe_gemm.cu``, ``csrc/bf16_probe_gemm.cu``), and
``tools/int8_rate_probe.py`` times them beside the library GEMMs.  Both
take ``b`` as ``[N, K]`` (K-contiguous, the B operand of their tile
loops; K7 runs the TMA + wgmma pipeline of ``csrc/wgmma_gemm.cuh``); the
TPU kernels took ``[K, N]``.  On a CUDA tensor each wrapper launches its
kernel or raises; on a CPU tensor it runs its plain version.
``int8_launches`` and ``bf16_launches`` count the launches.
"""
from __future__ import annotations

import ctypes

import torch

from fpqvar_tpu_torch.ops import _build
from fpqvar_tpu_torch.ops._checks import (bf16_gap, check_cuda_layout,
                                          check_device)

#: K chunk of K6 (128 codes) and of K7 (64 bf16 values): K is a multiple
INT8_K = 128
BF16_K = 64

#: number of K6 kernel launches in this process
int8_launches = 0
#: number of K7 kernel launches in this process
bf16_launches = 0

#: K up to which any s8 x s8 dot is exact in float32 in any summation
#: order: every partial sum is an integer of magnitude <= 128 * 128 * K,
#: at most 2^24 for K <= 1024
EXACT_F32_K_S8 = 1024


def _check(a, b, dtype, k_mult: int):
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError("a [M, K] and b [N, K] must be 2-D")
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"K mismatch: a {tuple(a.shape)}, b {tuple(b.shape)}")
    if a.shape[1] % k_mult:
        raise ValueError(f"K={a.shape[1]} must be a multiple of {k_mult}")
    if a.dtype != dtype or b.dtype != dtype:
        raise TypeError(f"a and b must be {dtype}, got {a.dtype} and "
                        f"{b.dtype}")
    check_device(a, b)


def int8_probe_gemm_ref(a, b):
    """Plain version of K6: the exact integer dot ``a @ b.T`` (float32 up
    to ``EXACT_F32_K_S8``, float64 beyond, exact either way), then
    ``.to(torch.bfloat16)``.  PyTorch converts an exact integer above 2^24
    to float32 first and then to bfloat16, as JAX's int32 -> bfloat16
    does; the kernel takes the same two roundings."""
    dt = torch.float32 if a.shape[1] <= EXACT_F32_K_S8 else torch.float64
    return (a.to(dt) @ b.to(dt).T).to(torch.bfloat16)


def _int8_lib():
    """``csrc/int8_probe_gemm.cu``: a, b, out, M, N, K."""
    return _build.load("int8_probe_gemm",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


def int8_probe_gemm(a, b):
    """K6: ``a [M, K]`` int8 times ``b [N, K]`` int8 -> [M, N] bfloat16,
    the int32 sum over the whole K converted once."""
    global int8_launches
    _check(a, b, torch.int8, INT8_K)
    if a.device.type == "cpu":
        return int8_probe_gemm_ref(a, b)
    check_cuda_layout("int8_probe_gemm", a, b, aligned=(a, b))
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.bfloat16,
                      device=a.device)
    if out.numel() == 0:
        return out
    _build.launch(_int8_lib(), "int8_probe_gemm", a.device, a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0],
                  a.shape[1])
    int8_launches += 1
    return out


def bf16_probe_gemm_ref(a, b):
    """Plain version of K7: a float32 matmul of the bfloat16 values (every
    product is exact in float32), then ``.to(torch.bfloat16)``.  On a card
    this assumes TF32 is off for float32 matmuls (PyTorch's default)."""
    return (a.to(torch.float32) @ b.to(torch.float32).T).to(torch.bfloat16)


#: Bound on |kernel - plain| per element before the bf16 rounding, as a
#: share of ``sum_k |a*b|`` per term of K.  Every product of two bf16 values
#: is exact in float32 on both sides.  The plain version sums the K
#: products in float32 in some order: <= (K - 1) u of the sum of the
#: terms' sizes (u = 2^-24).  The kernel sums on tensor cores, which align
#: and truncate (<= 2 u per addition), over K terms: <= 2 K u.  In all
#: <= 3 K u.
K7_TOL_PER_K = 3 * 2.0 ** -24


def bf16_probe_gemm_tolerance(a, b):
    """Per-element bound on |kernel - plain| for K7: ``K7_TOL_PER_K * K *
    sum_k |a*b|`` for the f32 sums, plus one bfloat16 gap
    (``_checks.bf16_gap``)."""
    k = a.shape[1]
    mag = a.to(torch.float32).abs() @ b.to(torch.float32).abs().T
    tol = K7_TOL_PER_K * k * mag
    return tol + bf16_gap(bf16_probe_gemm_ref(a, b), tol)


def _bf16_lib():
    """``csrc/bf16_probe_gemm.cu``: a, b, out, M, N, K."""
    return _build.load("bf16_probe_gemm",
                       [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


def bf16_probe_gemm(a, b):
    """K7: ``a [M, K]`` bfloat16 times ``b [N, K]`` bfloat16 -> [M, N]
    bfloat16, float32 accumulators over the whole K."""
    global bf16_launches
    _check(a, b, torch.bfloat16, BF16_K)
    if a.device.type == "cpu":
        return bf16_probe_gemm_ref(a, b)
    check_cuda_layout("bf16_probe_gemm", a, b, aligned=(a, b))
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.bfloat16,
                      device=a.device)
    if out.numel() == 0:
        return out
    _build.launch(_bf16_lib(), "bf16_probe_gemm", a.device, a.data_ptr(),
                  b.data_ptr(), out.data_ptr(), a.shape[0], b.shape[0],
                  a.shape[1])
    bf16_launches += 1
    return out
