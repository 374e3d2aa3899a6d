"""Kernels K1 to K4 on the card: each Hopper kernel against its plain
PyTorch version at the VAR-d16 shapes, ragged ones and tiny ones.  K1
(``int8_group_gemm_ref``) within ``K1_REL_TOL`` of ``sum_g |sa*sw*part|``
per element (the group parts are exact; only the f32 order over the groups
differs); K2 (``packed_matmul_ref``) within ``K2_REL_TOL`` of
``sum_g |s| * sum_k |x * grid[code]|`` per element, for row-split e2m1
nibbles and one-per-byte e2m3 and e2m1 codes, bfloat16 and float32 ``x``;
K3 (``int8ch_gemm_ref``) and K4 (``fused_ch_gemm_ref``) exactly equal
(the full-K int32 dot is exact and the epilogue runs the same two
multiplies), for float32 and bfloat16 outputs, the four K4 formats,
bfloat16 and float32 ``x`` and an all-zero row.

The tests are marked ``cuda`` and skip without a CUDA device.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from fpqvar_tpu_torch.ops import int8_matmul as K
from fpqvar_tpu_torch.ops import packing as P
from fpqvar_tpu_torch.ops import quant_matmul as QM


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(4096, 1024, 3072), (4096, 4096, 1024),
                                   (16, 1024, 1000), (37, 640, 384),
                                   (1, 128, 7)])
def test_cuda_kernel_matches_plain(cuda_device, m, k, n):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    ac, asc = P.quant_int_codes(torch.from_numpy(x).to(cuda_device),
                                "fp_e2", 128)
    pw = P.pack_int_codes(torch.from_numpy(w).to(cuda_device), "fp_e2", 128)
    before = K.launches
    ours = K.int8_group_gemm(ac, asc, pw.codes, pw.scales, 128)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    ref = K.int8_group_gemm_ref(ac, asc, pw.codes, pw.scales, 128)
    tol = K.int8_group_gemm_tolerance(ac, asc, pw.codes, pw.scales, 128)
    assert bool(((ours - ref).abs() <= tol).all())


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


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,m,k,n,dtype", [
    ("fp_e2", 4096, 1024, 3072, torch.bfloat16),      # d16 qkv, nibbles
    ("fp_e2", 4096, 4096, 1024, torch.bfloat16),      # d16 fc2, G = 32
    ("fp6_e2m3", 4096, 1024, 4096, torch.bfloat16),   # d16 fc1, bytes
    ("fp_e2", 4096, 1024, 1024, torch.float32),       # d16 proj, f32 x
    ("fp_e2", 16, 1024, 1024, torch.bfloat16),        # ragged M
    ("fp6_e2m3", 37, 384, 200, torch.float32),        # ragged M and N
    ("fp_e2", 1, 128, 7, torch.bfloat16),             # e2m1 bytes
])
def test_cuda_k2_matches_plain(cuda_device, fmt, m, k, n, dtype):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = (rng.standard_normal((n, k)) * 0.02).astype(np.float32)
    pw = P.pack(torch.from_numpy(w).to(cuda_device), fmt, 128)
    assert pw.nibble_packed == (fmt == "fp_e2" and n % 128 == 0)
    ops = (x.to(cuda_device, dtype), pw.codes, pw.scales, fmt, 128,
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
    ("fp_e1", 37, 640, 384, torch.float32),
    ("fp_e2", 1, 128, 7, torch.bfloat16),
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
