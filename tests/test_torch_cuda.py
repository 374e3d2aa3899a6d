"""Kernels K1 to K7 on the card: each Hopper kernel against its plain
PyTorch version at the VAR-d16 shapes, ragged ones and tiny ones.  K1
(``int8_group_gemm_ref``) within ``K1_REL_TOL`` of ``sum_g |sa*sw*part|``
per element (the group parts are exact; only the f32 order over the groups
differs), groups of 128 and 256; K2 (``packed_matmul_ref``) within
``K2_REL_TOL`` of ``sum_g |s| * sum_k |x * grid[code]|`` per element, for
row-split e2m1 nibbles and one-per-byte e2m3 and e2m1 codes, bfloat16 and
float32 ``x``, each x-tile width of the wgmma kernel, groups of 128 and
256, and its weight tensor-map cache across calls; the formats K2 does
not decode through ``packed_linear``'s dequantize route, against the CPU;
K3 (``int8ch_gemm_ref``) and K4 (``fused_ch_gemm_ref``) exactly equal
(the full-K int32 dot is exact and the epilogue runs the same two
multiplies), for float32 and bfloat16 outputs, the four K4 formats,
bfloat16 and float32 ``x``, an all-zero row, one K chunk (K = 128) and
K = 4096.  K5 (``int8_group_gemm_nd_ref``) within K1's bound plus one
bfloat16 gap for a bfloat16 output, on ``[B, T, K]`` codes with ragged T
and N, groups of 128 and 256, and equal to K1 followed by a cast; K6
(``int8_probe_gemm_ref``) exactly equal, sums above 2^24 included, at
ragged M and N, one K chunk and codes of the whole int8 range; K7
(``bf16_probe_gemm_ref``) within ``K7_TOL_PER_K * K * sum_k |a*b|`` plus
one bfloat16 gap, at one K chunk (K = 64), K = 4096, ragged M and N and
4096^3.  Every kernel but K2's float32-``x`` route runs the TMA + wgmma
pipeline, whose barriers hang the card if their phases are wrong (a wait
longer than 4 s traps instead); run the file under ``timeout``.

The teacher-forcing shapes: K1 to K5 at M = 8 * 680 = 5440 (K5 as ``[8,
680, K]``), whose last row tile is half full; one VAR-d16 ``var_forward``
at batch 8 under ``bf16``, ``int8``, ``packed`` and ``int8ch`` with each
kernel's exact launches; one mixed-precision ``train_step`` at width 256
against the CPU's.

The engine's fused mode (CUDA graphs) at width 256 under ``int8`` (K5 and
K1 captured): images ``torch.equal`` to the eager loop's for one generator
and for one per row, a second call with other labels and generators
without a new capture, and a new params tree captured again.  The device
transform (``transform_blocks_traced``) on the card against the CPU's:
rotated weights within ``test_torch_transform``'s bound of two float32
sums, and the quantize stage bit-equal given the same rotated weights.

The offline pipeline: one GALT step and the format search's nine fp4
pair losses at width 256, card against CPU (the GALT step within twice
the CPU's own response to a one-ulp change of its input); a bf16 tree
through ``save_params`` / ``load_params`` on the card keeps its bf16
leaves; a VAR-d16 fc1 ``IntPack`` round trip stays ``torch.equal``.

Evaluation: Inception features on the card against the CPU at 256 and
512 px (pool3 and spatial within ``INCEPTION_REL`` of their largest
magnitude, probs within ``PROBS_ATOL``); the score CLI in a fresh process
(cuDNN TF32 on by PyTorch's default) saving features ``torch.equal`` to
this process's; an eager ``int8`` eval set at width 256 with exact K1 and
K5 launches, and a fused one writing the same PNG bytes; the VQVAE
decode unchanged by the TF32 flag, and ``conv2d_plain`` bit-equal to
``F.conv2d`` with cuDNN and TF32 off while both TF32 flags are on.

The shards of a d16 tensor-parallel rank (tp = 2): K1 and K2 on both
ranks' column shards (qkv N = 1536, fc1 N = 2048) and row shards (proj K =
512, fc2 K = 2048) within their tolerances, K3 on the column shards
``torch.equal`` to its plain version and, concatenated, to the whole
product, and the row split's sum of two K1 halves within twice K1's bound
of the whole K1.

The tests are marked ``cuda`` and skip without a CUDA device.  The file
imports no JAX, so it also runs where JAX is not installed:

    timeout 600 python -m pytest --noconftest -q tests/test_torch_cuda.py

The user-facing CLIs: ``serve`` in a fresh process at ``--tiny`` against
a ``GenerationServer`` in this process; ``acceptance --tiny`` end to end
and resumed; ``motivation_plots --plot mse --depth 2`` on the card
against the CPU.
"""
import os

import numpy as np
import pytest
import torch

from fpqvar_tpu_torch.ops import int8_matmul as K
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import probe_gemm as PG
from fpqvar_tpu_torch.ops import quant_matmul as QM
from fpqvar_tpu_torch.ops._checks import bf16_gap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,group", [
    (4096, 1024, 3072, 128), (4096, 4096, 1024, 128),   # d16 qkv, fc2
    (16, 1024, 1000, 128), (37, 640, 384, 128), (1, 128, 7, 128),
    (16, 1024, 1000, 256),                              # two chunks a group
    (4096, 4096, 1024, 256), (200, 768, 130, 256),      # N % 4 != 0
    (5440, 4096, 1024, 128)])          # teacher-forcing fc2, ragged M tile
def test_cuda_kernel_matches_plain(cuda_device, m, k, n, group):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    ac, asc = P.quant_int_codes(torch.from_numpy(x).to(cuda_device),
                                "fp_e2", group)
    pw = P.pack_int_codes(torch.from_numpy(w).to(cuda_device), "fp_e2",
                          group)
    before = K.launches
    ours = K.int8_group_gemm(ac, asc, pw.codes, pw.scales, group)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    ref = K.int8_group_gemm_ref(ac, asc, pw.codes, pw.scales, group)
    tol = K.int8_group_gemm_tolerance(ac, asc, pw.codes, pw.scales, group)
    assert bool(((ours - ref).abs() <= tol).all())


#: the shards a d16 tp = 2 rank holds: (linear, split, K, N) of the whole
#: weight; the rank's K1 / K2 operands are its columns or its K-slice
TP2_SHARDS = [("qkv", "col", 1024, 3072), ("fc1", "col", 1024, 4096),
              ("proj", "row", 1024, 1024), ("fc2", "row", 4096, 1024)]


def _tp2_operands(x, pack, split, rank):
    """A tp = 2 rank's operands: its shard of ``pack`` (``parallel.mesh``'s
    split) and the whole activation ``x`` (codes and scales) or its
    K-slice."""
    from fpqvar_tpu_torch.parallel.mesh import Mesh, pack_dims, shard_tensor

    mesh = Mesh(dp=1, tp=2, rank=rank)
    cd, sd = pack_dims("fc1_w" if split == "col" else "fc2_w",
                       _stacked(pack), 2)
    codes = shard_tensor(pack.codes[None], cd, mesh)[0]
    scales = shard_tensor(pack.scales[None], sd, mesh)[0]
    if split == "row":
        x = tuple(shard_tensor(t, 1, mesh) for t in x)
    return x, codes, scales


def _stacked(pack):
    import dataclasses

    return dataclasses.replace(pack, codes=pack.codes[None],
                               scales=pack.scales[None])


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1024, 4096])
@pytest.mark.parametrize("name,split,k,n", TP2_SHARDS)
def test_cuda_k1_tp2_shards_match_plain(cuda_device, name, split, k, n, m):
    """K1 at a d16 tp = 2 rank's shard shapes (columns N / 2, or the
    K-slice K / 2 with its scale groups), both ranks, within K1's
    tolerance; M = 1024 is a batch-2 last scale, 4096 a batch-8 one."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.02)
                         .astype(np.float32))
    ac = P.quant_int_codes(x.to(cuda_device), "fp_e2", 128)
    pw = P.pack_int_codes(w.to(cuda_device), "fp_e2", 128)
    for rank in range(2):
        (a, sa), wc, ws = _tp2_operands(ac, pw, split, rank)
        assert wc.shape == ((n // 2, k) if split == "col" else (n, k // 2))
        ours = K.int8_group_gemm(a, sa, wc, ws, 128)
        ref = K.int8_group_gemm_ref(a, sa, wc, ws, 128)
        tol = K.int8_group_gemm_tolerance(a, sa, wc, ws, 128)
        assert bool(((ours - ref).abs() <= tol).all()), (name, rank)


@pytest.mark.cuda
@pytest.mark.parametrize("name,split,k,n", TP2_SHARDS)
def test_cuda_k2_tp2_shards_match_plain(cuda_device, name, split, k, n):
    """K2 (bf16 x, e2m1 nibbles) at a d16 tp = 2 rank's shard shapes, both
    ranks, within K2's tolerance."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.standard_normal((1024, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.02)
                         .astype(np.float32))
    pw = P.pack(w.to(cuda_device), "fp_e2", 128)
    for rank in range(2):
        (xs,), codes, scales = _tp2_operands((x.to(cuda_device, BF16),), pw,
                                             split, rank)
        ops = (xs, codes, scales, "fp_e2", 128, True)
        ours = QM.packed_matmul(*ops)
        assert ours.shape == (1024, n // 2 if split == "col" else n)
        tol = QM.packed_matmul_tolerance(*ops)
        assert bool(((ours - QM.packed_matmul_ref(*ops)).abs()
                     <= tol).all()), (name, rank)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1024, 4096])
@pytest.mark.parametrize("n", [3072, 4096])           # qkv, fc1 columns
def test_cuda_k3_tp2_column_shards_equal_plain(cuda_device, n, m):
    """K3 on a tp = 2 rank's columns of a per-channel qkv / fc1 (N / 2 =
    1536, 2048) equals its plain version, and the two ranks' columns
    equal the whole product's."""
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((m, 1024)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, 1024)) * 0.02)
                         .astype(np.float32))
    ac, asc = P.quant_int_codes(x.to(cuda_device), "fp_e2", 1024)
    pw = P.pack_int_codes(w.to(cuda_device), "fp_e2", 1024)
    whole = K.int8ch_gemm(ac, asc, pw.codes, pw.scales)
    parts = []
    for rank in range(2):
        (a, sa), wc, ws = _tp2_operands((ac, asc), pw, "col", rank)
        parts.append(K.int8ch_gemm(a, sa, wc, ws))
        assert torch.equal(parts[-1], K.int8ch_gemm_ref(a, sa, wc, ws))
    assert torch.equal(torch.cat(parts, 1), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1024, 4096])           # proj, fc2
def test_cuda_k1_row_split_sum_matches_whole(cuda_device, k):
    """The row split's sum of the two ranks' K1 halves against the whole
    K1: each lies within its ``K1_REL_TOL`` bound of the exact sum, the
    halves' bounds add up to the whole's, and the f32 add rounds once, so
    ``|sum - whole| <= 2 * tol + ulp(sum)``."""
    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((1024, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((1024, k)) * 0.02)
                         .astype(np.float32))
    ac = P.quant_int_codes(x.to(cuda_device), "fp_e2", 128)
    pw = P.pack_int_codes(w.to(cuda_device), "fp_e2", 128)
    halves = []
    for rank in range(2):
        (a, sa), wc, ws = _tp2_operands(ac, pw, "row", rank)
        halves.append(K.int8_group_gemm(a, sa, wc, ws, 128))
    total = halves[0] + halves[1]
    whole = K.int8_group_gemm(*ac, pw.codes, pw.scales, 128)
    tol = K.int8_group_gemm_tolerance(*ac, pw.codes, pw.scales, 128)
    ulp = total.abs() * 2.0 ** -23
    assert bool(((total - whole).abs() <= 2 * tol + ulp).all())


@pytest.mark.cuda
def test_cuda_wrapper_raises_on_bad_layout(cuda_device):
    ac = torch.zeros((4, 256), dtype=torch.int8, device=cuda_device)
    wc = torch.zeros((256, 8), dtype=torch.int8, device=cuda_device).t()
    asc = torch.ones((4, 2), device=cuda_device)
    wsc = torch.ones((2, 8), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K.int8_group_gemm(ac, asc, wc, wsc, 128)
    with pytest.raises(ValueError, match="several devices"):
        K.int8_group_gemm(ac, asc.cpu(), wc.contiguous(), wsc, 128)


BF16 = torch.bfloat16


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,m,k,n,dtype,group", [
    ("fp_e2", 4096, 1024, 3072, BF16, 128),           # d16 qkv, nibbles
    ("fp_e2", 4096, 1024, 1024, BF16, 128),           # d16 proj
    ("fp_e2", 4096, 1024, 4096, BF16, 128),           # d16 fc1
    ("fp_e2", 4096, 4096, 1024, BF16, 128),           # d16 fc2, G = 32
    ("fp6_e2m3", 4096, 1024, 3072, BF16, 128),        # the same, bytes
    ("fp6_e2m3", 4096, 1024, 1024, BF16, 128),
    ("fp6_e2m3", 4096, 1024, 4096, BF16, 128),
    ("fp6_e2m3", 4096, 4096, 1024, BF16, 128),
    ("fp_e2", 4096, 1024, 1024, torch.float32, 128),  # d16 proj, f32 x
    ("fp_e2", 16, 1024, 1024, BF16, 128),             # ragged M, 16-row tile
    ("fp_e2", 144, 1024, 3072, BF16, 128),            # 2 tiles, 16 rows
    ("fp_e2", 64, 128, 256, BF16, 128),               # one K chunk
    ("fp6_e2m3", 16, 1024, 1000, BF16, 128),          # ragged N, bytes
    ("fp6_e2m3", 37, 384, 200, BF16, 128),            # ragged M and N
    ("fp6_e2m3", 37, 384, 200, torch.float32, 128),
    ("fp_e2", 37, 384, 130, BF16, 128),               # N % 4 != 0
    ("fp_e2", 1, 128, 7, BF16, 128),                  # e2m1 bytes
    ("fp_e2", 16, 1024, 3072, BF16, 256),             # two chunks a group
    ("fp6_e2m3", 600, 2048, 1000, BF16, 256),
    ("fp_e2", 40, 512, 256, torch.float32, 256),
    ("fp_e2", 5440, 1024, 3072, BF16, 128),           # teacher forcing
    ("fp_e2", 5440, 1024, 1024, BF16, 128),           # (M = 8 * 680)
    ("fp_e2", 5440, 1024, 4096, BF16, 128),
    ("fp_e2", 5440, 4096, 1024, BF16, 128),
])
def test_cuda_k2_matches_plain(cuda_device, fmt, m, k, n, dtype, group):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    pw = P.pack(torch.from_numpy(w).to(cuda_device), fmt, group)
    assert pw.nibble_packed == (fmt == "fp_e2" and n % 128 == 0)
    ops = (x.to(cuda_device, dtype), pw.codes, pw.scales, fmt, group,
           pw.nibble_packed)
    before = QM.launches
    ours = QM.packed_matmul(*ops)
    torch.cuda.synchronize()
    assert QM.launches == before + 1
    ref = QM.packed_matmul_ref(*ops)
    tol = QM.packed_matmul_tolerance(*ops)
    assert ours.shape == (m, n) and ours.dtype == torch.float32
    assert bool(((ours - ref).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,out_dtype", [
    (4096, 4096, 1024, torch.float32),     # d16 fc2, as int8ch runs it
    (4096, 1024, 3072, torch.bfloat16),    # d16 qkv
    (16, 1024, 1000, torch.bfloat16),      # ragged M and N
    (37, 640, 384, torch.float32),
    (1, 128, 7, torch.float32),
    (16, 4096, 1000, torch.float32),       # ragged M and N at K = 4096
    (300, 128, 700, torch.bfloat16),       # one K chunk
    (5440, 4096, 1024, torch.float32),     # teacher-forcing fc2
])
def test_cuda_k3_equals_plain(cuda_device, m, k, n, out_dtype):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((n, k)) * 0.02)
                         .astype(np.float32))
    ac, asc = P.quant_int_codes(x.to(cuda_device), "fp_e2", k)
    pw = P.pack_int_codes(w.to(cuda_device), "fp_e2", k)
    before = K.ch_launches
    ours = K.int8ch_gemm(ac, asc, pw.codes, pw.scales, out_dtype)
    torch.cuda.synchronize()
    assert K.ch_launches == before + 1
    assert ours.shape == (m, n) and ours.dtype == out_dtype
    assert torch.equal(ours, K.int8ch_gemm_ref(ac, asc, pw.codes, pw.scales,
                                               out_dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,m,k,n,dtype", [
    ("fp_e2", 4096, 1024, 3072, torch.bfloat16),      # d16 qkv
    ("fp_e2", 4096, 4096, 1024, torch.bfloat16),      # d16 fc2 (int8chs)
    ("fp6_e2m3", 4096, 1024, 4096, torch.bfloat16),   # d16 fc1, 63 values
    ("fp_e2", 4096, 1024, 1024, torch.float32),       # d16 proj, f32 x
    ("fp_e3", 16, 1024, 1000, torch.bfloat16),        # ragged M and N
    ("fp6_e2m3", 16, 4096, 1000, torch.float32),      # ragged, K = 4096
    ("fp_e1", 37, 640, 384, torch.float32),
    ("fp_e2", 300, 128, 700, torch.bfloat16),         # one K chunk
    ("fp_e2", 1, 128, 7, torch.bfloat16),
    ("fp_e2", 5440, 1024, 3072, torch.bfloat16),      # teacher forcing
    ("fp_e2", 5440, 1024, 1024, torch.bfloat16),
    ("fp_e2", 5440, 1024, 4096, torch.bfloat16),
])
def test_cuda_k4_equals_plain(cuda_device, fmt, m, k, n, dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((m, k)).astype(np.float32) * 3.0
    x[m // 2] = 0.0                                   # an all-zero row
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    xt = torch.from_numpy(x).to(cuda_device, dtype)
    pw = P.pack_int_codes(torch.from_numpy(w).to(cuda_device), fmt, k)
    for out_dtype in (dtype, torch.float32):
        before = K.fused_launches
        ours = K.fused_ch_gemm(xt, pw.codes, pw.scales, fmt, out_dtype)
        torch.cuda.synchronize()
        assert K.fused_launches == before + 1
        assert ours.shape == (m, n) and ours.dtype == out_dtype
        assert torch.equal(ours, K.fused_ch_gemm_ref(xt, pw.codes, pw.scales,
                                                     fmt, out_dtype))


@pytest.mark.cuda
def test_cuda_k3_k4_raise_on_bad_layout(cuda_device):
    m, k, n = 8, 256, 128
    x = torch.randn((m, k), device=cuda_device, dtype=torch.bfloat16)
    wc = torch.zeros((k, n), dtype=torch.int8, device=cuda_device).t()
    ws = torch.ones((1, n), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_ch_gemm(x, wc, ws, "fp_e2")
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_ch_gemm(x.t().contiguous().t(), wc.contiguous(), ws, "fp_e2")
    shifted = torch.empty(m * k + 1, device=cuda_device,
                          dtype=torch.bfloat16)[1:].view(m, k)
    with pytest.raises(ValueError, match="aligned"):
        K.fused_ch_gemm(shifted, wc.contiguous(), ws, "fp_e2")
    ac = torch.zeros((m, k), dtype=torch.int8, device=cuda_device)
    asc = torch.ones((m, 1), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K.int8ch_gemm(ac, asc, wc, ws)
    codes = torch.zeros(m * k + 1, dtype=torch.int8,
                        device=cuda_device)[1:].view(m, k)
    with pytest.raises(ValueError, match="aligned"):
        K.int8ch_gemm(codes, asc, wc.contiguous(), ws)


@pytest.mark.cuda
def test_cuda_k2_raises_without_a_decoder(cuda_device):
    w = torch.randn((128, 256), device=cuda_device)
    pw = P.pack(w, "fp_e1", 128)
    x = torch.randn((4, 256), device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QM.packed_matmul(x, pw.codes, pw.scales, "fp_e1", 128,
                         pw.nibble_packed)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["fp_e1", "fp_e3", "fp6_e3m2"])
def test_cuda_packed_linear_without_a_decoder(cuda_device, fmt):
    """Formats K2 does not decode run JAX's dequantize route on the card,
    launch no K2, and give the CPU's numbers within float32 sum order
    (``2 K 2^-24 * (|x| @ |w|^T)``, then one bfloat16 gap)."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((2, 9, 256)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((256, 256)) * 0.02)
                         .astype(np.float32))
    pw = P.pack(w, fmt, 128)
    cpu = QM.packed_linear(x.to(BF16), pw).float()
    pwc = P.PackedTensor(pw.codes.to(cuda_device), pw.scales.to(cuda_device),
                         pw.fmt, pw.shape, pw.group_size, pw.nibble_packed)
    before = QM.launches
    ours = QM.packed_linear(x.to(cuda_device, BF16), pwc)
    torch.cuda.synchronize()
    assert QM.launches == before and ours.dtype == BF16
    size = x.to(BF16).float().abs().reshape(-1, 256) @ \
        P.dequantize(pw, BF16).float().abs().T
    tol = bf16_gap(cpu, (2 * 256 * 2.0 ** -24 * size).reshape(cpu.shape))
    assert bool(((ours.float().cpu() - cpu).abs() <= tol).all())


def _map_cache():
    """(hits, misses) of K2's weight tensor-map cache."""
    import ctypes
    fn = QM._lib().packed_dequant_gemm_map_cache
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = None
    hits, misses = ctypes.c_longlong(), ctypes.c_longlong()
    fn(ctypes.byref(hits), ctypes.byref(misses))
    return hits.value, misses.value


@pytest.mark.cuda
def test_cuda_k2_reuses_the_weight_tensor_map(cuda_device):
    """A weight's tensor map is encoded once and found again for a call
    with another x; a freed weight whose memory a weight of another shape
    takes over gets a map of its own (the key is everything the encoder
    reads)."""
    rng = np.random.default_rng(13)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(13)

    def check(pw, m):
        x = torch.randn((m, pw.shape[1]), generator=gen, device=cuda_device,
                        dtype=BF16)
        ops = (x, pw.codes, pw.scales, pw.fmt, 128, pw.nibble_packed)
        out = QM.packed_matmul(*ops)
        tol = QM.packed_matmul_tolerance(*ops)
        assert bool(((out - QM.packed_matmul_ref(*ops)).abs() <= tol).all())

    w = (rng.standard_normal((1024, 1024)) * 0.02).astype(np.float32)
    pw = P.pack(torch.from_numpy(w).to(cuda_device), "fp_e2", 128)
    h0, m0 = _map_cache()
    check(pw, 256)
    h1, m1 = _map_cache()
    assert h1 + m1 == h0 + m0 + 1          # a hit where a freed weight of
    check(pw, 16)                          # this shape had this address
    check(pw, 4096)
    h2, m2 = _map_cache()
    assert (h2, m2) == (h1 + 2, m1)
    del pw
    w2 = (rng.standard_normal((512, 2048)) * 0.02).astype(np.float32)
    pw2 = P.pack(torch.from_numpy(w2).to(cuda_device), "fp_e2", 128)
    check(pw2, 100)
    h3, m3 = _map_cache()
    assert h3 + m3 == h2 + m2 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,k,n,out_dtype", [
    (16, 256, 1024, 3072, torch.bfloat16),     # d16 qkv, last scale
    (16, 256, 1024, 4096, torch.float32),      # d16 fc1, f32 output
    (16, 9, 1024, 1000, torch.bfloat16),       # ragged T and N
    (3, 33, 640, 384, torch.float32),
    (3, 1, 128, 7, torch.bfloat16),            # tiny
    (16, 1, 1024, 3072, torch.bfloat16),       # d16 qkv, first scale
    (8, 680, 1024, 3072, torch.bfloat16),      # teacher forcing, all L
    (8, 680, 1024, 1024, torch.bfloat16),
    (8, 680, 1024, 4096, torch.bfloat16),
])
def test_cuda_k5_matches_plain(cuda_device, b, t, k, n, out_dtype):
    _check_k5(cuda_device, b, t, k, n, out_dtype, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,k,n,out_dtype", [
    (16, 256, 1024, 3072, torch.bfloat16),     # d16 qkv, two chunks a group
    (16, 256, 4096, 1024, torch.float32),      # d16 fc2's shape, G = 16
    (3, 9, 512, 130, torch.float32),           # rows of 520 bytes
])
def test_cuda_k5_groups_of_256_match_plain(cuda_device, b, t, k, n,
                                           out_dtype):
    _check_k5(cuda_device, b, t, k, n, out_dtype, 256)


def _check_k5(device, b, t, k, n, out_dtype, group):
    """K5 within its tolerance of the plain version, and equal to K1
    followed by a cast."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((b, t, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    ac, asc = P.quant_int_codes(torch.from_numpy(x).to(device), "fp_e2",
                                group)
    pw = P.pack_int_codes(torch.from_numpy(w).to(device), "fp_e2", group)
    ops = (ac, asc, pw.codes, pw.scales, group, out_dtype)
    before = K.nd_launches
    ours = K.int8_group_gemm_nd(*ops)
    torch.cuda.synchronize()
    assert K.nd_launches == before + 1
    assert ours.shape == (b, t, n) and ours.dtype == out_dtype
    ref = K.int8_group_gemm_nd_ref(*ops)
    tol = K.int8_group_gemm_nd_tolerance(*ops)
    assert bool(((ours.float() - ref.float()).abs() <= tol).all())
    k1 = K.int8_group_gemm(ac.reshape(b * t, k), asc.reshape(b * t, -1),
                           pw.codes, pw.scales, group)
    assert torch.equal(ours.reshape(b * t, n), k1.to(out_dtype))


def _witness_operands(device, m=64, k=4096, n=64):
    """Codes of +-127 whose signs mostly agree (most sums above 2^24); row
    0 of both holds a pair whose dot is 2^24 + 2^16 + 1 (2^24 after the
    conversion's two roundings), row 1 of ``a`` its negation."""
    rng = np.random.default_rng(9)
    a = np.where(rng.random((m, k)) < 0.9, 127, -127).astype(np.int8)
    b = np.where(rng.random((n, k)) < 0.9, 127, -127).astype(np.int8)
    a[:2], b[:2] = 0, 0
    a[0, :1044], b[0, :1044] = 127, 127
    a[0, 1044], b[0, 1044] = 63, 64
    a[0, 1045], b[0, 1045] = 45, 1
    a[1], b[1] = -a[0], b[0]
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 1024, 3072), (4096, 1920, 5760),
                                   (37, 640, 384), (1, 128, 7),
                                   ("witness", 4096, 64)])
def test_cuda_k6_equals_plain(cuda_device, m, k, n):
    if m == "witness":
        a, b = _witness_operands(cuda_device, 64, k, n)
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(10)
        a = torch.randint(-128, 128, (m, k), generator=gen,
                          device=cuda_device, dtype=torch.int8)
        b = torch.randint(-128, 128, (n, k), generator=gen,
                          device=cuda_device, dtype=torch.int8)
    before = PG.int8_launches
    ours = PG.int8_probe_gemm(a, b)
    torch.cuda.synchronize()
    assert PG.int8_launches == before + 1
    assert ours.dtype == torch.bfloat16
    assert torch.equal(ours, PG.int8_probe_gemm_ref(a, b))
    if m == "witness":
        assert float(ours[0, 0]) == 2.0 ** 24
        assert float(ours[1, 0]) == -2.0 ** 24
        exact = a.double() @ b.double().T
        assert bool((exact.abs() >= 2.0 ** 24).float().mean() > 0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(300, 4096, 1000), (130, 4096, 7),
                                   (4096, 4096, 520), (300, 128, 700)])
def test_cuda_k6_ragged_and_witness_on_wgmma(cuda_device, m, k, n):
    """K6 on the s8 wgmma pipeline's 128 x 256 tiles: ragged M and N (the
    last tiles partly outside, TMA stores clipped; N = 7 takes the direct
    store), one K chunk (K = 128), and codes of the whole int8 range.  At
    K = 4096 rows 0 and 1 hold the witness sums (+-(2^24 + 2^16 + 1),
    +-2^24 after the conversion's two roundings), row 2 of both operands
    is -128 throughout (a sum of exactly 2^26) and row 3 of ``a`` -128
    against ``b``'s 127s (-(2^26 - 2^19))."""
    if k >= 4096:
        a, b = _witness_operands(cuda_device, m, k, n)
        a[2], b[2] = -128, -128
        a[3], b[3] = -128, 127
    else:
        gen = torch.Generator(device=cuda_device).manual_seed(12)
        a = torch.randint(-128, 128, (m, k), generator=gen,
                          device=cuda_device, dtype=torch.int8)
        b = torch.randint(-128, 128, (n, k), generator=gen,
                          device=cuda_device, dtype=torch.int8)
    before = PG.int8_launches
    ours = PG.int8_probe_gemm(a, b)
    torch.cuda.synchronize()
    assert PG.int8_launches == before + 1
    assert ours.shape == (m, n) and ours.dtype == torch.bfloat16
    assert torch.equal(ours, PG.int8_probe_gemm_ref(a, b))
    if k >= 4096:
        assert float(ours[0, 0]) == 2.0 ** 24
        assert float(ours[1, 0]) == -2.0 ** 24
        assert float(ours[2, 2]) == 2.0 ** 26
        assert float(ours[3, 3]) == -(2.0 ** 26 - 2.0 ** 19)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 1024, 3072), (4096, 4096, 1024),
                                   (4096, 1920, 5760), (4096, 4096, 4096),
                                   (16, 1024, 1000), (16, 4096, 1000),
                                   (300, 64, 700), (37, 640, 384),
                                   (1, 64, 7)])
def test_cuda_k7_matches_plain(cuda_device, m, k, n):
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    a = torch.randn((m, k), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    b = torch.randn((n, k), generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    before = PG.bf16_launches
    ours = PG.bf16_probe_gemm(a, b)
    torch.cuda.synchronize()
    assert PG.bf16_launches == before + 1
    assert ours.shape == (m, n) and ours.dtype == torch.bfloat16
    ref = PG.bf16_probe_gemm_ref(a, b)
    tol = PG.bf16_probe_gemm_tolerance(a, b)
    assert bool(((ours.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_k5_k6_k7_raise_on_bad_layout(cuda_device):
    b, t, k, n = 2, 4, 256, 128
    ac = torch.zeros((b, t, k), dtype=torch.int8, device=cuda_device)
    asc = torch.ones((b, t, 2), device=cuda_device)
    wc = torch.zeros((k, n), dtype=torch.int8, device=cuda_device).t()
    ws = torch.ones((2, n), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        K.int8_group_gemm_nd(ac, asc, wc, ws, 128)
    shifted = torch.zeros(b * t * k + 1, dtype=torch.int8,
                          device=cuda_device)[1:].view(b, t, k)
    with pytest.raises(ValueError, match="aligned"):
        K.int8_group_gemm_nd(shifted, asc, wc.contiguous(), ws, 128)
    a8 = torch.zeros((8, k), dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        PG.int8_probe_gemm(a8, wc)
    with pytest.raises(ValueError, match="aligned"):
        PG.int8_probe_gemm(shifted.view(-1, k), wc.contiguous())
    a16 = torch.zeros((8, k), dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        PG.bf16_probe_gemm(a16, a16.t().contiguous().t())
    odd = torch.zeros(8 * k + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(8, k)
    with pytest.raises(ValueError, match="aligned"):
        PG.bf16_probe_gemm(odd, a16)


@pytest.mark.cuda
def test_cuda_d16_fp4_kv6_matches_cpu(cuda_device):
    """The paper's ``fp4_kv6`` (fake quantizers, a dense cache quantized
    per token to fp6_e2m3 on append) at VAR-d16's width and depth over its
    first three scales (1, 2, 3; a small VQVAE), float32 compute and cache
    at ``top_k=1``: the card samples the CPU's tokens at every scale,
    launches no GEMM of the port and the quantizer Q1 six times a block
    forward (four activations, the cache's k and v), and its ``f_hat``
    agrees within 1e-5 (it depends on the tokens alone, through the
    VQVAE's float32 convs)."""
    from fpqvar_tpu_torch.ops import quant_kernels as QK

    cpu_tokens, cpu_fhat, _ = _d16_fp4_kv6(torch.device("cpu"))
    counters = (K.launches, K.nd_launches, K.fused_launches, K.ch_launches,
                QM.launches, QK.codes_launches, QK.int_launches)
    tokens, fhat, n_q1 = _d16_fp4_kv6(cuda_device)
    assert (K.launches, K.nd_launches, K.fused_launches, K.ch_launches,
            QM.launches, QK.codes_launches, QK.int_launches) == counters
    assert n_q1 == 6 * 16 * 3
    assert len(tokens) == len(cpu_tokens) == 3
    for a, b in zip(tokens, cpu_tokens):
        assert torch.equal(a, b)
    torch.testing.assert_close(fhat, cpu_fhat, rtol=0, atol=1e-5)


def _d16_fp4_kv6(device):
    """(the tokens of each scale, f_hat, the generation's Q1 launches) of
    one seeded ``fp4_kv6`` generation of 3 labels at d16's width and depth
    on ``device``."""
    from fpqvar_tpu_torch.ops import quant_kernels as QK

    import dataclasses

    from fpqvar_tpu_torch.config import (GenerateConfig, VQVAEConfig,
                                         paper_recipes, var_d16)
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.quantize import quantize_var_params

    pn = (1, 2, 3)
    cfg = dataclasses.replace(var_d16(), patch_nums=pn, vae=VQVAEConfig(
        ch=16, ch_mult=(1, 2), num_res_blocks=1, patch_nums=pn))
    q = paper_recipes()["fp4_kv6"]
    rng = np.random.default_rng(7)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    params = init_var_params(cfg, seed=8, device="cpu", adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=9, device="cpu")
    qp = quantize_var_params(_tree_to(params, device), cfg, q, galt=galt)
    gen = VARGenerator(cfg, q, GenerateConfig(top_k=1, top_p=0.0),
                       cache_dtype=torch.float32,
                       compute_dtype=torch.float32, device=device,
                       fuse_steps=False)
    sample, tokens = V.sample_with_top_k_top_p, []

    def recorded(logits, *args, **kw):
        idx = sample(logits, *args, **kw)
        tokens.append(idx.cpu())
        return idx

    V.sample_with_top_k_top_p = recorded
    q1 = QK.grid_launches
    try:
        fhat = gen.generate(qp, _tree_to(vae, device), [3, 5, 998],
                            return_fhat=True)
    finally:
        V.sample_with_top_k_top_p = sample
    return tokens, fhat.cpu(), QK.grid_launches - q1


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _small_int8(device):
    import dataclasses

    from fpqvar_tpu_torch.config import bench_recipes, var_tiny
    from fpqvar_tpu_torch.models import init_var_params, init_vqvae_params
    from fpqvar_tpu_torch.quantize import quantize_var_params

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    q = bench_recipes()["int8"]
    params = init_var_params(cfg, seed=4, device=device, adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=5, device=device)
    galt = tuple(np.ones((cfg.depth, cfg.width), np.float32)
                 for _ in range(2))
    return cfg, q, params, vae, lambda: quantize_var_params(params, cfg, q,
                                                            galt=galt)


@pytest.mark.cuda
def test_cuda_fused_generation_equals_eager(cuda_device):
    from fpqvar_tpu_torch.models import VARGenerator

    cfg, q, _, vae, build = _small_int8(cuda_device)
    qp = build()
    eager = VARGenerator(cfg, q, device=cuda_device, fuse_steps=False)
    fused = VARGenerator(cfg, q, qrt=eager.qrt, device=cuda_device)

    def gens(seeds):
        out = [torch.Generator(device=cuda_device).manual_seed(s)
               for s in seeds]
        return out[0] if len(out) == 1 else out

    calls = (([3, 5, 7], [1]), ([9, 2, 4], [4, 5, 6]), ([0, 0, 1], [2]))
    outs = []
    for i, (labels, seeds) in enumerate(calls):
        params = qp if i < 2 else build()          # the third: a new tree
        want = eager.generate(params, vae, labels, gens(seeds))
        outs.append((fused.generate(params, vae, labels, gens(seeds)), want))
        assert fused.captures == (1 if i < 2 else 2), i
    # read after every call: a later replay leaves an earlier result alone
    for i, (got, want) in enumerate(outs):
        assert torch.equal(got, want), i
    stats = fused.capture_stats(3)
    assert stats["capture_s"] > 0 and stats["pool_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "packed", "fake"])
def test_cuda_device_transform_matches_cpu(cuda_device, mode):
    from fpqvar_tpu_torch.config import bench_recipes
    from fpqvar_tpu_torch.ops import hadamard as H
    from fpqvar_tpu_torch.quantize import recipe as R

    cfg, _, params, _, _ = _small_int8("cpu")
    q = bench_recipes()[mode]
    blocks = params["blocks"]
    rng = np.random.default_rng(6)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, cfg.width)))
                 .astype(np.float32) for _ in range(2))
    on_card = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else
                   {kk: vv.to(cuda_device) for kk, vv in v.items()})
               for k, v in blocks.items()}
    torch.backends.cuda.matmul.allow_tf32 = True      # the transform's own
    try:
        rot_card = R._rotate_f32(on_card, cfg, q, galt)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rot_cpu = R._rotate_f32(blocks, cfg, q, galt)
    qmat = np.abs(H.block_hadamard_block(128, 42))
    for key, g in zip(("mat_qkv_w", "fc1_w"), galt):
        w = np.abs(blocks[key].double().numpy() / g[:, None, :])
        d, o, i = w.shape
        bound = 2 * 128 * 2.0 ** -24 * (w.reshape(d, o, i // 128, 128)
                                        @ qmat).reshape(d, o, i)
        diff = (rot_card[key].cpu().double() - rot_cpu[key].double()).abs()
        assert bool((diff.numpy() <= bound).all()), key
    staged = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor) else v)
              for k, v in rot_cpu.items()}
    staged["ada_lin"] = on_card["ada_lin"]
    card = R._quantize_traced(staged, q, torch.float32)
    cpu = R._quantize_traced(rot_cpu, q, torch.float32)
    for key in ("mat_qkv_w", "proj_w", "fc1_w", "fc2_w"):
        a, b = card[key], cpu[key]
        pairs = ([(a, b)] if isinstance(a, torch.Tensor) else
                 [(a.codes, b.codes), (a.scales, b.scales)])
        for x, y in pairs:
            assert torch.equal(x.cpu(), y), key


#: port-kernel launches of one d16 teacher-forcing forward (16 blocks),
#: the activation quantizers Q1 and Q2 among them
TF_LAUNCHES = {"bf16": {},
               "int8": {"nd_launches": 48, "launches": 32, "q2": 64},
               "packed": {"qm": 64, "q1": 64},
               "int8ch": {"fused_launches": 48, "ch_launches": 32, "q2": 16}}


def _tf_counts():
    from fpqvar_tpu_torch.ops import quant_kernels as QK

    return {"launches": K.launches, "nd_launches": K.nd_launches,
            "ch_launches": K.ch_launches,
            "fused_launches": K.fused_launches, "qm": QM.launches,
            "q1": QK.grid_launches, "q2": QK.codes_launches,
            "q3": QK.int_launches}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(TF_LAUNCHES))
def test_cuda_d16_teacher_forcing_launches(cuda_device, mode):
    """One VAR-d16 ``var_forward`` at batch 8 (M = 5440 a linear) on
    ``synth_device_params`` launches each kernel exactly as the recipe
    routes 16 blocks, and gives finite float32 logits."""
    from fpqvar_tpu_torch.config import bench_recipes, var_d16
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.quantize import recipe
    from fpqvar_tpu_torch.quantize.runtime import build_runtime

    cfg, q = var_d16(), bench_recipes()[mode]
    galt = tuple(np.ones((cfg.depth, cfg.width), np.float32)
                 for _ in range(2))
    params = recipe.synth_device_params(cfg, q, seed=0, galt=galt)
    qrt = build_runtime(q, cfg.depth, cfg.width, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    labels = torch.randint(0, 1000, (8,), generator=gen, device=cuda_device)
    x = torch.randn((8, cfg.L - 1, 32), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    with torch.inference_mode():
        before = _tf_counts()
        logits = V.var_forward(params, cfg, qrt, labels, x)
        torch.cuda.synchronize()
        after = _tf_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: TF_LAUNCHES[mode].get(k, 0) for k in after}
    assert logits.shape == (8, cfg.L, 4096) and logits.dtype == torch.float32
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_cuda_mixed_precision_train_step_matches_cpu(cuda_device):
    """One mixed-precision ``train_step`` at width 256 on the card against
    the same step on the CPU (same float32 params and batch, TF32 off):
    bf16 rounds in other places on the two devices, so the loss agrees
    within a relative 1e-3 and each leaf's update lies within three times
    the L2 distance between the CPU's bf16 and float32 updates, plus 1e-3
    of its size (the leaves that only decay)."""
    import dataclasses

    from fpqvar_tpu_torch.config import var_tiny
    from fpqvar_tpu_torch.models import init_var_params
    from fpqvar_tpu_torch.train import make_train_state, train_step
    from fpqvar_tpu_torch.train.trainer import make_optimizer, tree_leaves

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    start = init_var_params(cfg, seed=4, device="cpu", adaln_gamma_std=0.02)
    rng = np.random.default_rng(9)
    batch = {"label": torch.from_numpy(rng.integers(0, 1000, 4)),
             "x": torch.from_numpy(rng.standard_normal(
                 (4, cfg.L - 1, cfg.vae.z_channels)).astype(np.float32)),
             "targets": torch.from_numpy(rng.integers(0, 64, (4, cfg.L)))}

    def step(device, mixed):
        opt = make_optimizer(peak_lr=3e-3)
        state = make_train_state(_tree_to(start, device), opt)
        state, m = train_step(state, cfg, opt, _tree_to(batch, device),
                              mixed_precision=mixed)
        return float(m["loss"]), [p.detach().cpu() - p0 for p, p0 in
                                  zip(tree_leaves(state.params),
                                      tree_leaves(start))]

    card_loss, card = step(cuda_device, True)
    cpu_loss, cpu = step("cpu", True)
    _, cpu_f32 = step("cpu", False)
    assert abs(card_loss - cpu_loss) <= 1e-3 * cpu_loss
    for a, b, f in zip(card, cpu, cpu_f32):
        noise = float((b - f).norm())
        assert float((a - b).norm()) <= 3 * noise + 1e-3 * float(b.norm())


def _galt_inputs(width=256, rows=(2, 8, 18)):
    """Width-256 activations of three scale steps and an fc1 weight."""
    rng = np.random.default_rng(21)
    acts = [rng.standard_normal((r, width)).astype(np.float32) for r in rows]
    w = (rng.standard_normal((4 * width, width)) * 0.02).astype(np.float32)
    return acts, w


@pytest.mark.cuda
def test_cuda_galt_step_matches_cpu(cuda_device):
    """One GALT epoch of one step (``train_galt_block``) on the card
    against the CPU: the loss before the update and ``s`` after it within
    the larger of 1e-6 (relative, and absolute in ``s``: Adam's first step
    moves each channel by ``lr g / (|g| + eps)``) and twice the CPU's own
    response to a one-ulp change of the activations (a code at a near-tie
    flips on one device only)."""
    from fpqvar_tpu_torch.quantize import galt as G

    acts, w = _galt_inputs()
    card_s, card_l = G.train_galt_block(acts[:1], w, epochs=1,
                                        device=cuda_device)
    cpu_s, cpu_l = G.train_galt_block(acts[:1], w, epochs=1, device="cpu")
    ulp_s, ulp_l = G.train_galt_block(
        [acts[0] * np.float32(1 + 2.0 ** -23)], w, epochs=1, device="cpu")
    s_tol = max(1e-6, 2 * float(np.abs(ulp_s - cpu_s).max()))
    l_tol = max(1e-6, 2 * abs(ulp_l - cpu_l) / cpu_l)
    assert float(np.abs(card_s - cpu_s).max()) <= s_tol
    assert abs(card_l - cpu_l) <= l_tol * cpu_l


@pytest.mark.cuda
def test_cuda_pair_loss_matches_cpu(cuda_device):
    """The search's loss of all nine fp4 pairs at width 256, card against
    CPU, within a relative 1e-4 (IEEE float32 on both; sums in another
    order)."""
    from fpqvar_tpu_torch.quantize import search as S

    acts, w = _galt_inputs()
    x = np.concatenate(acts)
    for wf in S.FP4_SPACE.values():
        for af in S.FP4_SPACE.values():
            card = S._pair_loss(torch.from_numpy(x).to(cuda_device),
                                torch.from_numpy(w).to(cuda_device), wf, af,
                                128)
            cpu = S._pair_loss(torch.from_numpy(x), torch.from_numpy(w), wf,
                               af, 128)
            assert abs(card - cpu) <= 1e-4 * cpu, (wf, af)


@pytest.mark.cuda
def test_cuda_load_params_keeps_bf16(cuda_device, tmp_path):
    """A bf16 tree saved from the card loads on the card with its bf16
    leaves bf16 and ``torch.equal``."""
    from fpqvar_tpu_torch.utils import checkpoint as C

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    tree = {"w": torch.randn((64, 128), generator=gen,
                             device=cuda_device).to(torch.bfloat16),
            "b": [torch.randn((7,), generator=gen, device=cuda_device)]}
    C.save_params(str(tmp_path / "t.npz"), tree)
    back = C.load_params(str(tmp_path / "t.npz"), cuda_device)
    assert back["w"].dtype == torch.bfloat16 and back["w"].is_cuda
    assert torch.equal(back["w"], tree["w"])
    assert back["b"][0].dtype == torch.float32
    assert torch.equal(back["b"][0], tree["b"][0])


@pytest.mark.cuda
def test_cuda_d16_intpack_save_load_equal(cuda_device, tmp_path):
    """A VAR-d16 fc1 IntPack (``[16, 4096, 1024]``, packed on the card)
    through ``save_params`` / ``load_params`` stays ``torch.equal``."""
    from fpqvar_tpu_torch.utils import checkpoint as C

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    w = torch.randn((16, 4096, 1024), generator=gen, device=cuda_device)
    pack = P.pack_int_codes(w * 0.02, "fp_e2")
    C.save_params(str(tmp_path / "p.npz"), {"fc1_w": pack})
    back = C.load_params(str(tmp_path / "p.npz"), cuda_device)["fc1_w"]
    assert isinstance(back, P.IntPack)
    assert (back.fmt, back.shape, back.group_size) == (
        pack.fmt, pack.shape, pack.group_size)
    assert back.codes.is_cuda and back.codes.shape == (16, 4096, 1024)
    assert torch.equal(back.codes, pack.codes)
    assert torch.equal(back.scales, pack.scales)


# ---------------------------------------------------------------------------
# Evaluation: the eval set, Inception features and the score CLI
# ---------------------------------------------------------------------------

#: card against CPU Inception features: each of the ~94 layers sums up to
#: K = 2048 * 9 float32 products, whose rounding (random-walk sqrt(K) u
#: ~ 8e-6 a layer) compounds to ~1e-4 of the largest feature over the
#: depth; probs (a softmax of logits of std ~3) within 1e-5
INCEPTION_REL = 1e-4
PROBS_ATOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [256, 512])
def test_cuda_inception_matches_cpu(cuda_device, hw):
    from fpqvar_tpu_torch.eval import inception as I

    imgs = torch.from_numpy(np.random.default_rng(hw).uniform(
        size=(2, 3, hw, hw)).astype(np.float32))
    cpu = I.inception_features(I.init_inception_params(0, "cpu"), imgs)
    card = I.inception_features(I.init_inception_params(0, cuda_device),
                                imgs.to(cuda_device))
    for name, c, g in zip(("pool3", "spatial", "probs"), cpu, card):
        atol = (PROBS_ATOL if name == "probs"
                else INCEPTION_REL * float(c.abs().max()))
        assert float((g.cpu() - c).abs().max()) <= atol, name


@pytest.mark.cuda
def test_cuda_score_subprocess_features_equal(cuda_device, tmp_path):
    """The score CLI in a fresh process (PyTorch's default flags: cuDNN
    TF32 on) saves the features that the pinned float32 extraction gives
    in this process, bit for bit."""
    import os
    import subprocess
    import sys

    from fpqvar_tpu_torch.eval import imaging as Im
    from fpqvar_tpu_torch.eval import inception as I

    imgs = np.random.default_rng(3).integers(0, 256, (6, 32, 32, 3),
                                             dtype=np.uint8)
    Im.save_uint8_png(imgs, str(tmp_path / "set"), 0)
    np.savez(tmp_path / "ref.npz", arr_0=imgs[::-1].copy())
    feats = str(tmp_path / "f.npz")
    torch.cuda.empty_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "fpqvar_tpu_torch.tools.score",
         str(tmp_path / "ref.npz"), str(tmp_path / "set"), "--inception",
         "random", "--save-features", feats], cwd=repo,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        want = I.extract_features_batched(
            I.init_inception_params(0, cuda_device),
            imgs.transpose(0, 3, 1, 2))
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    with np.load(feats) as d:
        for k, w in zip(("features", "spatial", "probs"), want):
            assert torch.equal(torch.from_numpy(d[k]), torch.from_numpy(w)), k


def _eval_counts():
    from fpqvar_tpu_torch.ops import quant_kernels as QK

    return {"K1": K.launches, "K5": K.nd_launches, "Q2": QK.codes_launches}


@pytest.mark.cuda
def test_cuda_eval_set_launches_and_fused_pngs_equal(cuda_device, tmp_path):
    """An eager ``int8`` eval set at width 256 (2 classes of 3 images at
    batch 2: 4 generations) launches K1, K5 and Q2 exactly as 4
    generations route them; a fused generator writes the same PNG bytes; a complete
    set runs nothing again."""
    import os

    from fpqvar_tpu_torch.eval.pipeline import generate_eval_set
    from fpqvar_tpu_torch.models import VARGenerator

    cfg, q, _, vae, build = _small_int8(cuda_device)
    qp = build()
    blocks = cfg.depth * cfg.num_scales
    eager = VARGenerator(cfg, q, device=cuda_device, fuse_steps=False)
    before = _eval_counts()
    runs = generate_eval_set(eager, qp, vae, str(tmp_path / "eager"), 3,
                             [4, 9], batch=2)
    torch.cuda.synchronize()
    after = _eval_counts()
    assert runs == 4
    assert {k: after[k] - before[k] for k in after} == {
        "K1": 4 * 2 * blocks, "K5": 4 * 3 * blocks, "Q2": 4 * 4 * blocks}
    fused = VARGenerator(cfg, q, qrt=eager.qrt, device=cuda_device)
    assert generate_eval_set(fused, qp, vae, str(tmp_path / "fused"), 3,
                             [4, 9], batch=2) == 4
    names = sorted(os.listdir(tmp_path / "eager"))
    assert names == sorted(os.listdir(tmp_path / "fused")) and len(names) == 6
    for n in names:
        assert (open(tmp_path / "eager" / n, "rb").read()
                == open(tmp_path / "fused" / n, "rb").read()), n
    assert generate_eval_set(fused, qp, vae, str(tmp_path / "fused"), 3,
                             [4, 9], batch=2) == 0


@pytest.mark.cuda
def test_cuda_vqvae_decode_ignores_tf32_flag(cuda_device):
    """PyTorch's default ``cudnn.allow_tf32 = True`` (a fresh process's)
    must not change the VQVAE decode: its convolutions pin float32.
    Before the pin, the evaluate CLI's decoded PNGs differed from the same
    generation's in a process with TF32 off."""
    from fpqvar_tpu_torch.config import var_d16
    from fpqvar_tpu_torch.models import init_vqvae_params
    from fpqvar_tpu_torch.models import vqvae as vq

    cfg = var_d16().vae
    vae = init_vqvae_params(cfg, seed=1, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    f_hat = torch.randn((2, cfg.z_channels, 16, 16), generator=gen,
                        device=cuda_device)
    prev = torch.backends.cudnn.allow_tf32
    out = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = flag
            with torch.inference_mode():
                out[flag] = vq.decode(vae, cfg, f_hat)
            assert torch.backends.cudnn.allow_tf32 is flag
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert torch.equal(out[False], out[True])


@pytest.mark.cuda
@pytest.mark.parametrize("stride,padding", [(1, 1), (2, 0), (1, 0)])
def test_cuda_conv2d_plain_is_the_no_cudnn_route(cuda_device, stride,
                                                 padding):
    """With both TF32 flags on, ``conv2d_plain`` on the card equals
    ``F.conv2d`` with cuDNN off and TF32 off (the route the decoder took
    when it switched cuDNN off around each call) bit for bit, and leaves
    every backend switch as it was."""
    import torch.nn.functional as F

    from fpqvar_tpu_torch.ops.precision import conv2d_plain

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((4, 128, 34, 34), generator=gen, device=cuda_device)
    w = torch.randn((256, 128, 3, 3), generator=gen, device=cuda_device)
    b = torch.randn(256, generator=gen, device=cuda_device)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            want = F.conv2d(x, w, b, stride=stride, padding=padding)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        got = conv2d_plain(x, w, b, stride=stride, padding=padding)
        assert (torch.backends.cudnn.enabled,
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32) == (True, True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    assert torch.equal(got, want)


def _read_pngs(folder, names):
    from fpqvar_tpu_torch.eval import png

    return [png.read_png(os.path.join(folder, n)) for n in names]


@pytest.mark.cuda
def test_cuda_serve_subprocess_matches_server(cuda_device, tmp_path):
    """The serve CLI in a fresh process at ``--tiny`` (W4A4 without GALT
    on the int8 backend: K1 and K5 inside the fused generator's graphs)
    writes the PNGs of a ``GenerationServer`` over the CLI's own trees in
    this process, pixel for pixel."""
    import subprocess
    import sys

    from fpqvar_tpu_torch.config import GenerateConfig, var_tiny
    from fpqvar_tpu_torch.eval import imaging as Im
    from fpqvar_tpu_torch.models import VARGenerator
    from fpqvar_tpu_torch.serving import GenerationServer
    from fpqvar_tpu_torch.tools import serve

    flags = ["--tiny", "--recipe", "w4a4", "--no-transform", "--backend",
             "int8", "--demo", "4", "--max-batch", "2", "--out",
             str(tmp_path / "served")]
    res = subprocess.run([sys.executable, "-m", "fpqvar_tpu_torch.tools.serve",
                          *flags], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr
    assert "served 4 requests" in res.stdout
    names = [f"class{i}_img{i}.png" for i in range(4)]
    assert sorted(os.listdir(tmp_path / "served")) == names
    args = serve.parse_args(flags)
    qcfg = serve.recipe(args)
    var_p, vae_p = serve.load_trees(args, var_tiny(), qcfg)
    srv = GenerationServer(VARGenerator(var_tiny(), qcfg, GenerateConfig()),
                           var_p, vae_p, max_batch=2)
    try:
        want = [Im.to_uint8(f.result()[None])[0]
                for f in [srv.submit(i, i) for i in range(4)]]
    finally:
        srv.stop()
    for got, w in zip(_read_pngs(tmp_path / "served", names), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.cuda
def test_cuda_acceptance_tiny_end_to_end(cuda_device, tmp_path):
    """``acceptance --tiny`` on the card: calibration, GALT, both legs
    (fused), Inception features and the metrics; a smoke-mode pass with
    JAX's artifacts, and a second run that resumes every stage."""
    from fpqvar_tpu_torch.tools import acceptance

    out = tmp_path / "acc"
    v = acceptance.main(["--tiny", "--out", str(out)])
    assert v["pass"] and v["smoke_mode"] and v["n_images"] == 8
    for rel in ("best_s/mat_qkv_best_s_fp4.npz", "figs_fp4.npz",
                "figs_fp16.npz", "features_fp4.npz", "ACCEPTANCE.json"):
        assert (out / rel).exists(), rel
    again = acceptance.main(["--tiny", "--out", str(out)])
    assert again["metrics"] == v["metrics"]


@pytest.mark.cuda
def test_cuda_motivation_mse_matches_cpu(cuda_device, tmp_path):
    """``motivation_plots --plot mse --depth 2`` (fc2 activations,
    block-Hadamard rotated) on the card against the same study on the CPU,
    on one store captured on the card: curves within a relative 1e-4 (the
    rotation's float32 sums run in another order, which moves near-tie
    codes; one flipped code moves a block's mean by a few 1e-7 of it)."""
    from fpqvar_tpu_torch.config import (PATCH_NUMS_256, VARConfig,
                                         VQVAEConfig)
    from fpqvar_tpu_torch.models.var import init_var_params
    from fpqvar_tpu_torch.models.vqvae import init_vqvae_params
    from fpqvar_tpu_torch.quantize.calibration import (CalibrationStore,
                                                       capture_generation)
    from fpqvar_tpu_torch.tools import motivation_plots

    cfg = VARConfig(depth=2, patch_nums=PATCH_NUMS_256,
                    vae=VQVAEConfig(patch_nums=PATCH_NUMS_256))
    var_p = init_var_params(cfg, seed=0, device=cuda_device)
    vae_p = init_vqvae_params(cfg.vae, seed=1, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    store = CalibrationStore(str(tmp_path / "calib"))
    store.append_run(capture_generation(var_p, vae_p, cfg, [1, 2], gen))
    curves = {}
    for dev in ("cuda", "cpu"):
        curves[dev] = motivation_plots.main([
            "--plot", "mse", "--tensor", "act", "--calib",
            str(tmp_path / "calib"), "--depth", "2", "--kind", "fc2",
            "--rotate", "--device", dev, "--out",
            str(tmp_path / f"{dev}.json")])["curves"]
    assert list(curves["cuda"]) == list(curves["cpu"])
    for name, ys in curves["cpu"].items():
        a, b = np.asarray(curves["cuda"][name]), np.asarray(ys)
        assert np.all(np.isfinite(a)), name
        np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# The quantizers Q1-Q3 (ops/quant_kernels.py)
# ---------------------------------------------------------------------------

def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit-equal as int views (``torch.equal`` treats -0 as +0)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = torch.int16 if a.element_size() == 2 else torch.int32
        return torch.equal(a.contiguous().view(view),
                           b.contiguous().view(view))
    return torch.equal(a, b)


def _all_bits_equal(got, want) -> bool:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        _bits_equal(a, b) for a, b in zip(got, want))


def _quant_cases():
    """(label, kernel call, plain call) over every grid a recipe can use:
    Q1 per group and per token (the per-token fp4 formats with their
    clamp), Q2's value codes, dual codes and grid-index codes (pack, the
    KV codec), Q3 symmetric and asymmetric at 4, 6 and 8 bits."""
    from fpqvar_tpu_torch.ops import grids as G
    from fpqvar_tpu_torch.ops import quant_kernels as QK
    from fpqvar_tpu_torch.ops import quantizers as Q

    def pack_ref(x, fmt):
        codes, scales = P.pack_codes_ref(x, fmt)
        return codes.to(torch.int8), scales

    cases = []
    for fmt in G.GRIDS:
        for gran in ("per_group", "per_token"):
            clip = 3.0 if gran == "per_token" and fmt.startswith("fp_e") else None
            kw = dict(granularity=gran, clip_abs=clip)
            cases.append((f"Q1 {fmt} {gran}", G.GRIDS[fmt], None,
                          lambda x, f=fmt, kw=kw: Q.fake_quant_fp(x, f, **kw),
                          lambda x, f=fmt, kw=kw: Q.fake_quant_fp_ref(
                              x, f, **kw)))
        cases.append((f"Q2 pack {fmt}", G.GRIDS[fmt], None,
                      lambda x, f=fmt: QK.pack_codes(x, f),
                      lambda x, f=fmt: pack_ref(x, f)))
        cases.append((f"Q2 KV index {fmt}", G.GRIDS[fmt], None,
                      lambda x, f=fmt: QK.grid_index_codes(x.view(-1, 64), f),
                      lambda x, f=fmt: P.grid_index_codes_ref(
                          x.view(-1, 64), f)))
        if fmt in P.CODE_MULT:
            for gs in (128, 1024):
                cases.append((f"Q2 codes {fmt} {gs}", G.GRIDS[fmt], None,
                              lambda x, f=fmt, g=gs: P.quant_int_codes(
                                  x, f, g),
                              lambda x, f=fmt, g=gs: P.quant_int_codes_ref(
                                  x, f, g)))
    for fmt, (neg, pos) in G.DUAL_GRIDS.items():
        lead = [-float(np.abs(neg).max()), float(np.abs(pos).max())]
        for half, grid in (("neg", neg), ("pos", pos)):
            for gran in ("per_group", "per_token"):
                cases.append((f"Q1 {fmt} {half} {gran}", grid, lead,
                              lambda x, f=fmt, g=gran: Q.fake_quant_dual(
                                  x, f, granularity=g),
                              lambda x, f=fmt, g=gran: Q.fake_quant_dual_ref(
                                  x, f, granularity=g)))
            if fmt in P.DUAL_CODE_MULT:
                cases.append((f"Q2 dual {fmt} {half}", grid, lead,
                              lambda x, f=fmt: P.quant_int_codes_dual(x, f),
                              lambda x, f=fmt: P.quant_int_codes_dual_ref(
                                  x, f)))
    for n_bits in (4, 6, 8):
        q_max = 2 ** (n_bits - 1) - 1
        grid = np.arange(-q_max - 1, q_max + 1, dtype=np.float32)
        for asym in (False, True):
            fn, ref = ((Q.fake_quant_int_asym, Q.fake_quant_int_asym_ref)
                       if asym else (Q.fake_quant_int_sym,
                                     Q.fake_quant_int_sym_ref))
            for gran in ("per_group", "per_token"):
                cases.append((f"Q3 int{n_bits} {'asym' if asym else 'sym'} "
                              f"{gran}", grid, None,
                              lambda x, fn=fn, b=n_bits, g=gran: fn(
                                  x, b, granularity=g),
                              lambda x, ref=ref, b=n_bits, g=gran: ref(
                                  x, b, granularity=g)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_quantizers_bit_equal_on_adversarial_inputs(cuda_device, dtype):
    """Q1, Q2 and Q3 bit-equal (int views, NaN bits included) to their
    plain versions on the card, over every grid and dual-grid half, per
    group and per token: 10^5 scaled normals, every midpoint, grid value
    and +-0 at scale ~1, +-inf, NaN, +-1e30 and denormal scales, each
    with its neighbours (``test_torch_quant_kernels.adversarial``)."""
    from test_torch_quant_kernels import adversarial

    bf16 = dtype == "bfloat16"
    bad = []
    for label, grid, lead, run, plain in _quant_cases():
        x = torch.from_numpy(adversarial(grid, bf16, 11, lead=lead)).to(
            cuda_device, getattr(torch, dtype)).reshape(-1, 1024)
        if not _all_bits_equal(run(x), plain(x)):
            bad.append(label)
    assert not bad


#: (group, shape) of the quantizer kernels' layouts of groups over threads
#: (chip_smoke.py's QUANT_LAYOUTS): groups of 64, 128 and 256 values, of
#: 24, 40 and 12 (3 and 5 vectors of 16 bytes in bf16, 3 of 12 f32), rows
#: of 1,024 to 9,216 (one warp; blocks of 2, 3, 4 and 9 warps in bf16),
#: each in a count that fills no whole warp or block, and 16 rows (the
#: first scale's M at batch 8)
QUANT_LAYOUTS = [(64, (2, 3, 5, 4160)), (128, (2, 3, 5, 4224)),
                 (256, (2, 3, 5, 4352)), (24, (2, 3, 5, 4104)),
                 (40, (2, 3, 5, 4120)), (12, (2, 3, 5, 4104)),
                 (1024, (2, 3, 5, 1024)), (1920, (2, 3, 5, 1920)),
                 (2304, (2, 3, 5, 2304)), (4096, (2, 3, 5, 4096)),
                 (9216, (2, 3, 5, 9216)), (128, (16, 1024)),
                 (1024, (16, 1024)), (4096, (16, 4096))]


@pytest.mark.cuda
@pytest.mark.parametrize("gs,shape", QUANT_LAYOUTS,
                         ids=[f"{g}-{'x'.join(map(str, s))}"
                              for g, s in QUANT_LAYOUTS])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_quantizers_group_sizes_with_leading_dims(cuda_device, gs,
                                                       shape, dtype):
    """Groups of ``gs`` over ``shape`` (``QUANT_LAYOUTS``): each kernel
    (Q3 symmetric and asymmetric) bit-equal to its plain version, one
    launch a call; an all-zero group, a group of x's smallest subnormals
    (a scale that rounds to 0), a group all strictly negative and one all
    strictly positive (whose min and max no idle lane's zero may enter)
    among them.  A group that is no multiple of 16 bytes raises."""
    from fpqvar_tpu_torch.ops import quant_kernels as QK
    from fpqvar_tpu_torch.ops import quantizers as Q

    gen = torch.Generator(device=cuda_device).manual_seed(gs)
    x = (torch.randn(shape, generator=gen, device=cuda_device)
         * 3).to(dtype)
    flat = x.view(-1)
    flat[:gs] = 0.0                                     # an all-zero group
    flat[gs:2 * gs] = 2.0 ** (-133 if dtype == torch.bfloat16 else -149)
    flat[2 * gs:3 * gs] = -flat[2 * gs:3 * gs].abs() - 0.25
    flat[3 * gs:4 * gs] = flat[3 * gs:4 * gs].abs() + 0.25
    pairs = [
        (lambda: Q.fake_quant_fp(x, "fp_e2", group_size=gs),
         lambda: Q.fake_quant_fp_ref(x, "fp_e2", group_size=gs), "grid"),
        (lambda: Q.fake_quant_dual(x, "fp6_int_neg_e2m3_pos", group_size=gs),
         lambda: Q.fake_quant_dual_ref(x, "fp6_int_neg_e2m3_pos",
                                       group_size=gs), "grid"),
        (lambda: P.quant_int_codes(x, "fp6_e2m3", gs),
         lambda: P.quant_int_codes_ref(x, "fp6_e2m3", gs), "codes"),
        (lambda: P.quant_int_codes_dual(x, "fp_e1m2_neg_e2m1_pos", gs),
         lambda: P.quant_int_codes_dual_ref(x, "fp_e1m2_neg_e2m1_pos", gs),
         "codes"),
        (lambda: Q.fake_quant_int_sym(x, 4, granularity="per_group",
                                      group_size=gs),
         lambda: Q.fake_quant_int_sym_ref(x, 4, granularity="per_group",
                                          group_size=gs), "int"),
        (lambda: Q.fake_quant_int_asym(x, 4, granularity="per_group",
                                       group_size=gs),
         lambda: Q.fake_quant_int_asym_ref(x, 4, granularity="per_group",
                                           group_size=gs), "int"),
    ]
    attr = {"grid": "grid_launches", "codes": "codes_launches",
            "int": "int_launches"}
    for run, plain, kind in pairs:
        if (gs * x.element_size()) % 16:
            with pytest.raises(ValueError, match="16 bytes"):
                run()
            continue
        before = getattr(QK, attr[kind])
        got = run()
        assert getattr(QK, attr[kind]) == before + 1
        assert _all_bits_equal(got, plain()), kind


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_dual_grid_zero_scale_half_bit_equal(cuda_device, dtype):
    """The dual-grid kernels on groups where one half's absmax is x's
    smallest subnormal (``adversarial``'s subnormal groups): where that
    half's scale rounds to 0 (an empty half, absmax 0, takes the scale 1:
    ``adversarial``'s one-signed groups), its +0 takes position 0 (0 / 0
    is NaN), which the kernels find by the real division once a group;
    bit-equal to the plain versions, and in float32 some such code is not
    the half's code of +0 (``test_torch_quant_kernels`` holds the numpy
    model to the same)."""
    from fpqvar_tpu_torch.ops import grids as G
    from fpqvar_tpu_torch.ops import quant_kernels as QK
    from fpqvar_tpu_torch.ops import quantizers as Q
    from test_torch_quant_kernels import adversarial

    bf16 = dtype == "bfloat16"
    distinct = False
    for fmt in sorted(P.DUAL_CODE_MULT):
        neg, _ = G.DUAL_GRIDS[fmt]
        x = torch.from_numpy(adversarial(neg, bf16, 12)).to(
            cuda_device, getattr(torch, dtype)).reshape(-1, 128)
        assert _all_bits_equal(Q.fake_quant_dual(x, fmt),
                               Q.fake_quant_dual_ref(x, fmt)), fmt
        got = P.quant_int_codes_dual(x, fmt)
        assert _all_bits_equal(got, P.quant_int_codes_dual_ref(x, fmt)), fmt
        for h, half in enumerate(("neg", "pos")):
            t = QK.code_table(fmt, half)
            scale = torch.where(x <= 0, x, 0) if h == 0 else torch.where(
                x > 0, x, 0)
            amax = scale.float().abs().amax(dim=1)
            zero = (amax > 0) & (amax * t.inv == 0)    # not an empty half
            held = (x > 0 if h == 0 else ~(x > 0)) & zero[:, None]
            codes = got[2 * h][held]
            assert bool((codes == int(t.out[0])).all()), (fmt, half)
            distinct |= bool(held.any()) and int(t.out[0]) != 0
    assert bf16 or distinct


@pytest.mark.cuda
def test_cuda_quantizers_in_a_cuda_graph(cuda_device):
    """Q1, Q2 and Q3 captured in one CUDA graph and replayed on new inputs
    give the plain versions' outputs bit for bit."""
    from fpqvar_tpu_torch.ops import quantizers as Q

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((512, 1024), generator=gen, device=cuda_device).to(BF16)
    calls = (lambda t: Q.fake_quant_fp(t, "fp6_e2m3",
                                       granularity="per_token"),
             lambda t: P.quant_int_codes_dual(t, "fp_e1m2_neg_e2m1_pos"),
             lambda t: Q.fake_quant_int_sym(t, 4))
    plains = (lambda t: Q.fake_quant_fp_ref(t, "fp6_e2m3",
                                            granularity="per_token"),
              lambda t: P.quant_int_codes_dual_ref(t, "fp_e1m2_neg_e2m1_pos"),
              lambda t: Q.fake_quant_int_sym_ref(t, 4))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for c in calls:                                   # builds, warm-up
            c(x)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [c(x) for c in calls]
    for seed in (5, 6):
        gen.manual_seed(seed)
        x.copy_(torch.randn(x.shape, generator=gen, device=cuda_device))
        graph.replay()
        torch.cuda.synchronize()
        for out, plain in zip(outs, plains):
            assert _all_bits_equal(out, plain(x))


@pytest.mark.cuda
def test_cuda_quantizers_raise_on_what_they_do_not_take(cuda_device):
    """On the card: a tensor that autograd would record raises (no
    backward), and passes under ``no_grad``; float16 and groups that are
    no multiple of 16 bytes raise; ``per_tensor`` takes its named plain
    route."""
    from fpqvar_tpu_torch.ops import quant_kernels as QK
    from fpqvar_tpu_torch.ops import quantizers as Q

    x = torch.randn((4, 256), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        Q.fake_quant_fp(x, "fp_e2")
    with torch.no_grad():
        assert _bits_equal(Q.fake_quant_fp(x, "fp_e2"),
                           Q.fake_quant_fp_ref(x, "fp_e2"))
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        Q.fake_quant_fp(x.detach().half(), "fp_e2")
    with pytest.raises(ValueError, match="16 bytes"):
        Q.fake_quant_int_sym(torch.randn((4, 6), device=cuda_device), 4)
    before = QK.grid_launches
    y = Q.fake_quant_fp(x.detach(), "fp_e2", granularity="per_tensor")
    assert QK.grid_launches == before
    assert torch.equal(y, Q.fake_quant_fp_ref(x.detach(), "fp_e2",
                                              granularity="per_tensor"))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["packed", "int8", "int8kv", "fp6_kv6",
                                  "int4_rtn"])
def test_cuda_generation_with_quantizer_kernels_equals_plain(cuda_device,
                                                             mode,
                                                             monkeypatch):
    """A width-256 generation (bf16 compute, top_k=1) with the quantizer
    kernels against the same generation with every quantizer on its plain
    version on the card: the same tokens at every scale and
    ``torch.equal`` images; the kernels launched, the plain run none."""
    import dataclasses

    from fpqvar_tpu_torch.config import (GenerateConfig, bench_recipes,
                                         paper_recipes, var_tiny)
    from fpqvar_tpu_torch.models import (VARGenerator, init_var_params,
                                         init_vqvae_params)
    from fpqvar_tpu_torch.models import var as V
    from fpqvar_tpu_torch.ops import quant_kernels as QK
    from fpqvar_tpu_torch.quantize import quantize_var_params

    cfg = dataclasses.replace(var_tiny(), embed_dim=256, num_heads=4)
    q = {**bench_recipes(), **paper_recipes()}[mode]
    params = init_var_params(cfg, seed=4, device=cuda_device,
                             adaln_gamma_std=0.02)
    vae = init_vqvae_params(cfg.vae, seed=5, device=cuda_device)
    rng = np.random.default_rng(5)
    galt = tuple(np.exp(0.1 * rng.standard_normal((cfg.depth, 256)))
                 .astype(np.float32) for _ in range(2))
    sample, tokens = V.sample_with_top_k_top_p, []

    def recorded(logits, *args, **kw):
        idx = sample(logits, *args, **kw)
        tokens.append(idx.cpu())
        return idx

    def run():
        tokens.clear()
        qp = quantize_var_params(params, cfg, q, galt=galt)
        g = VARGenerator(cfg, q, GenerateConfig(top_k=1, top_p=0.0),
                         device=cuda_device, fuse_steps=False)
        before = (QK.grid_launches, QK.codes_launches, QK.int_launches)
        img = g.generate(qp, vae, [3, 5, 7])
        after = (QK.grid_launches, QK.codes_launches, QK.int_launches)
        return img, list(tokens), sum(after) - sum(before)

    monkeypatch.setattr(V, "sample_with_top_k_top_p", recorded)
    img, toks, n = run()
    monkeypatch.setattr(QK, "_on_card", lambda x: False)
    img_plain, toks_plain, n_plain = run()
    assert n > 0 and n_plain == 0
    assert len(toks) == cfg.num_scales
    assert all(torch.equal(a, b) for a, b in zip(toks, toks_plain))
    assert torch.equal(img, img_plain)


# ---------------------------------------------------------------------------
# The capacity study (tools/capacity_study.py)
# ---------------------------------------------------------------------------

#: rows of a d36-512 batch-64 linear at the last scale: 2 * 64 * 32^2
D36_B64_ROWS = 2 * 64 * 1024


@pytest.mark.cuda
def test_cuda_capacity_probe_child_d16_int8kv(cuda_device):
    """One probe child (a fresh process) at VAR-d16 under ``int8kv``,
    batch 8: its eager warm-up launches exactly K4 480 + K3 320 + Q2 480
    and nothing else, the capture as many, the images are finite and the
    memory readings are there."""
    from fpqvar_tpu_torch.tools import capacity_study as CS

    r = CS.probe("d16", "int8kv", 8, 1, 900, "cuda")
    assert r["ok"], r
    rec = r["record"]
    want = {"K4": 480, "K3": 320, "Q2": 480}
    assert rec["warmup_launches"] == {k: want.get(k, 0)
                                      for k in rec["warmup_launches"]}
    assert rec["capture_launches"] == rec["warmup_launches"]
    assert rec["images_finite"] and rec["image_shape"] == [8, 3, 256, 256]
    assert rec["ips"] > 0 and rec["pool_bytes"] > 0
    assert rec["max_memory_allocated"] >= rec["static_bytes"] > 0


def _big_rows(k: int, seed: int) -> torch.Tensor:
    """``[D36_B64_ROWS, k]`` bf16 normals with a few rows scaled apart,
    drawn on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((D36_B64_ROWS, k), generator=g, device="cuda")
    x[::977] *= 1e3
    x[5::1013] *= 1e-3
    return x.to(torch.bfloat16)


@pytest.mark.cuda
def test_cuda_q2_dual_per_token_at_d36_batch64_rows(cuda_device):
    """Q2's dual per-token codes on ``[131072, 9216]`` (d36-512 fc2's input
    at batch 64: 1.2e9 values, 2.4 GB) bit-equal to the plain version."""
    fmt = "fp_e1m2_neg_e2m1_pos"
    x = _big_rows(9216, 31)
    got = P.quant_int_codes_dual(x, fmt, 9216)
    torch.cuda.synchronize()
    want = P.quant_int_codes_dual_ref(x, fmt, 9216)
    assert _all_bits_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("gran", ["per_group", "per_token"])
def test_cuda_q1_fp_grid_at_d36_batch64_rows(cuda_device, gran):
    """Q1's fp_e2 grid on ``[131072, 2304]`` bit-equal to the plain
    version."""
    from fpqvar_tpu_torch.ops import quantizers as Q

    x = _big_rows(2304, 32)
    got = Q.fake_quant_fp(x, "fp_e2", granularity=gran)
    torch.cuda.synchronize()
    assert _bits_equal(got, Q.fake_quant_fp_ref(x, "fp_e2",
                                                granularity=gran))


@pytest.mark.cuda
def test_cuda_k3_at_d36_batch64_fc2(cuda_device):
    """K3 at ``131072 x 9216 x 2304`` (d36-512 fc2 at batch 64, float32
    out: 1.2 GB) ``torch.equal`` to its plain version."""
    x = _big_rows(9216, 33)
    ac, asc = P.quant_int_codes(x, "fp_e2", 9216)
    del x
    w = torch.randn((2304, 9216), device="cuda") * 0.02
    pw = P.pack_int_codes(w, "fp_e2", 9216)
    before = K.ch_launches
    ours = K.int8ch_gemm(ac, asc, pw.codes, pw.scales, torch.float32)
    torch.cuda.synchronize()
    assert K.ch_launches == before + 1
    assert torch.equal(ours, K.int8ch_gemm_ref(ac, asc, pw.codes, pw.scales,
                                               torch.float32))
