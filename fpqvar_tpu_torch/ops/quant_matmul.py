"""Packed-weight linears on the dequantize-in-register GEMM (kernel K2).

``packed_matmul`` computes

    out[m,n] = sum_g  s[g,n] * sum_{k in g} x[m,k] * grid[code[n,k]]

with float32 output, for ``x [M, K]`` in bf16 or float32, the codes of a
:class:`~fpqvar_tpu_torch.ops.packing.PackedTensor` (row-split e2m1 nibbles
``[N/2, K]`` or one code per byte ``[N, K]``) and float32 scales
``[G, N]``.  On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/packed_dequant_gemm.cu`` (the port of the TPU kernel
``fpqvar_tpu/ops/pallas/quant_matmul.py`` ``_kernel`` /
``_packed_matmul_2d``: for bf16 ``x`` a TMA + ``wgmma`` kernel that decodes
the weight into its register operand, for float32 ``x`` an ``mma.sync``
kernel over an exact three-way bf16 split of ``x``) or raises; on a CPU
tensor it runs the plain version ``packed_matmul_ref``.  ``launches``
counts kernel launches.

The plain version follows the kernel's arithmetic: exact grid values in
each group's dot, the float32 scale applied to each group's partial
product.  The JAX package's CPU fallback instead rounds ``grid * scale`` to
``x.dtype`` before one dense product; the two agree only within rounding.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from fpqvar_tpu_torch.ops import _build
from fpqvar_tpu_torch.ops import grids as G
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops._checks import check_cuda_layout, check_device

#: K chunk of the kernel: every group is a multiple of it
KERNEL_K = 128

#: format -> the kernel's decoder id (the formats K2 decodes in-kernel)
KERNEL_FMTS = {"fp_e2": 0, "fp6_e2m3": 1}

#: number of K2 kernel launches in this process
launches = 0

#: Bound on |kernel - plain| per element, as a share of
#: ``sum_g |s[g,n]| * sum_{k in g} |x[m,k] * grid[code[n,k]]|``.  Every
#: product is exact on the kernel's side (bf16 x or its three-way bf16
#: split times grid values of <= 4 significant bits) and rounded once
#: (u = 2^-24) on the plain side.  The plain version sums each group (128
#: or 256 terms) in float32 in some order: <= 255 u of the sum of the
#: terms' sizes.  The kernels sum on tensor cores, which align and
#: truncate (<= 2 u per addition): the wgmma kernel (bf16 x) adds a
#: group's terms into a fresh part, <= 512 u; the mma.sync kernel (float32
#: x) folds every 128 values of K, 3 * 128 terms a part, <= 768 u.  The
#: folds (at most K / 128 <= 32; the wgmma kernel fuses the scale product
#: into its multiply-add) and the sum over the groups add <= (32 + 2) * 2 u
#: on each side.  In all <= (1 + 255 + 768 + 136) u = 1160 u = 6.9e-5 for
#: groups of up to 256, which this covers.
K2_REL_TOL = 1e-4


def _check_format(fmt: str, nibble: bool):
    if fmt not in G.GRIDS:
        raise ValueError(f"unknown packed format {fmt!r}")
    if nibble and len(G.GRIDS[fmt]) > 16:
        raise ValueError(f"{fmt} codes do not fit in a nibble")


def _grouped_dot(x, w, scales, group_size: int):
    """``sum_g scales[g] * (x_g @ w_g.T)`` in float32, group by group in
    order, as the kernel accumulates: x [M, K], w [N, K], scales [G, N]."""
    m, k = x.shape
    xf = x.to(torch.float32)
    out = torch.zeros((m, w.shape[0]), dtype=torch.float32, device=x.device)
    for g in range(k // group_size):
        ks = slice(g * group_size, (g + 1) * group_size)
        out += (xf[:, ks] @ w[:, ks].T) * scales[g]
    return out


def _weight(codes, scales, fmt: str, group_size: int, nibble: bool):
    n, k = scales.shape[1], codes.shape[1]
    return P.grid_values(P.PackedTensor(codes, scales, fmt, (n, k),
                                        group_size, nibble))


def packed_matmul_ref(x, codes, scales, fmt: str, group_size: int,
                      nibble: bool):
    """Plain PyTorch version of K2: unpack, decode the exact grid values,
    one float32 dot per group, each output column scaled per group."""
    _check_format(fmt, nibble)
    w = _weight(codes, scales, fmt, group_size, nibble)
    return _grouped_dot(x, w, scales, group_size)


def packed_matmul_tolerance(x, codes, scales, fmt: str, group_size: int,
                            nibble: bool):
    """Per-element bound on |kernel - plain|: ``K2_REL_TOL * sum_g |s| *
    sum_k |x * grid[code]|``."""
    w = _weight(codes, scales, fmt, group_size, nibble)
    return K2_REL_TOL * _grouped_dot(x.abs(), w.abs(), scales.abs(),
                                     group_size)


def _check(x, codes, scales, fmt: str, group_size: int, nibble: bool):
    _check_format(fmt, nibble)
    if x.dim() != 2 or codes.dim() != 2 or scales.dim() != 2:
        raise ValueError("x [M, K], codes and scales [G, N] must be 2-D")
    m, k = x.shape
    n = scales.shape[1]
    if k % KERNEL_K or group_size % KERNEL_K or k % group_size:
        raise ValueError(f"K={k} and group_size={group_size} must be "
                         f"multiples of {KERNEL_K}, with K % group_size == 0")
    if nibble and n % 128:
        raise ValueError(f"nibble-packed codes need N % 128 == 0, got N={n}")
    want = (n // 2 if nibble else n, k)
    if tuple(codes.shape) != want:
        raise ValueError(f"codes must be {list(want)}, got "
                         f"{list(codes.shape)}")
    if scales.shape[0] != k // group_size:
        raise ValueError(f"scales must be [{k // group_size}, {n}], got "
                         f"{list(scales.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if codes.dtype != torch.int8:
        raise TypeError("codes must be int8")
    if scales.dtype != torch.float32:
        raise TypeError("scales must be float32")
    check_device(x, codes, scales)


def _lib():
    """``csrc/packed_dequant_gemm.cu``: x, codes, scales, out, M, N, K,
    group, x_f32, decoder, nibble."""
    return _build.load("packed_dequant_gemm",
                       [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7)


def packed_matmul(x, codes, scales, fmt: str, group_size: int = 128,
                  nibble: bool = True):
    """K2: x [M, K] times the decoded packed weight, per-group scaled ->
    [M, N] f32 (operands as in ``packed_matmul_ref``).  Ragged M works;
    byte codes also take a ragged N."""
    global launches
    _check(x, codes, scales, fmt, group_size, nibble)
    dev = x.device
    if dev.type == "cpu":
        return packed_matmul_ref(x, codes, scales, fmt, group_size, nibble)
    if fmt not in KERNEL_FMTS:
        raise NotImplementedError(
            f"K2 decodes {sorted(KERNEL_FMTS)} in-kernel; {fmt!r} has no "
            "decoder (packed_linear takes JAX's dequantize route for it, "
            "ROADMAP.md section 3)")
    check_cuda_layout("packed_matmul", x, codes, scales,
                      aligned=(x, codes))
    m, k = x.shape
    n = scales.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    _build.launch(_lib(), "packed_dequant_gemm", dev, x.data_ptr(),
                  codes.data_ptr(), scales.data_ptr(), out.data_ptr(), m, n,
                  k, group_size, int(x.dtype == torch.float32),
                  KERNEL_FMTS[fmt], int(nibble))
    launches += 1
    return out


def _packed_call(x2, pw: P.PackedTensor):
    """``x2 [M, K]`` times a packed weight (whole, or one rank's shard)
    -> [M, N] f32: K2, or JAX's dequantize route for a format without a
    decoder (the weight rounded once to ``x2.dtype``, one float32
    product)."""
    if pw.fmt in KERNEL_FMTS:
        return packed_matmul(x2.contiguous(), pw.codes, pw.scales, pw.fmt,
                             pw.group_size, pw.nibble_packed)
    n, k = pw.scales.shape[-1], pw.codes.shape[-1]
    w = P.dequantize(dataclasses.replace(pw, shape=(n, k)), x2.dtype)
    return x2.to(torch.float32) @ w.to(torch.float32).T


def packed_linear(x, pw: P.PackedTensor, *, mesh=None, parallel: str = None,
                  b=None):
    """``x [..., K]`` times the packed ``[N, K]`` weight, returned in
    ``x.dtype`` as ``[..., N]``.

    Formats that K2 decodes (:data:`KERNEL_FMTS`) go through K2 (f32 out).
    Every other format takes the JAX package's own route for it
    (``_packed_call``), on every device: the weight dequantized to
    ``x.dtype`` (``grid * scale`` in float32, rounded once), then one
    float32 product.

    With a ``mesh`` and ``parallel`` ("col" or "row") the product runs on
    this rank's shard of ``pw`` (``quant_matmul.py``'s ``shard_map``
    route): the rank's columns, all-gathered over tp, or its K-slice of
    ``x`` and scale groups, the f32 partials summed over tp; a replicated
    pack runs whole.  Every rank of the tp row gets the whole output.

    ``b``: the output's bias (under a column split, this rank's shard of
    it), added in ``x.dtype``; under a mesh before the columns are
    gathered (``collectives.linear_out``)."""
    n, k = pw.shape
    x2 = x.reshape(-1, k)
    if mesh is not None and parallel is not None:
        from fpqvar_tpu_torch.parallel import collectives as C
        from fpqvar_tpu_torch.parallel.mesh import linear_split

        split = linear_split(pw, parallel, mesh.tp)
        if not split:
            out = _packed_call(x2, pw)
        elif parallel == "col":
            out = _packed_call(C.copy_to_tp(x2, mesh), pw)
        else:
            out = C.sum_partials(_packed_call(C.take_slice(x2, mesh), pw),
                                 mesh)
        y = C.linear_out(out.to(x.dtype), b, mesh, parallel, split)
        return y.reshape(x.shape[:-1] + (n,))
    y = _packed_call(x2, pw).reshape(x.shape[:-1] + (n,)).to(x.dtype)
    return y if b is None else y + b.to(y.dtype)
