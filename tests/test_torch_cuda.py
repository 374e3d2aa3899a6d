"""Kernels K1 and K2 on the card: each Hopper kernel against its plain
PyTorch version at the VAR-d16 shapes, ragged ones and tiny ones.  K1
(``int8_group_gemm_ref``) within ``K1_REL_TOL`` of ``sum_g |sa*sw*part|``
per element (the group parts are exact; only the f32 order over the groups
differs); K2 (``packed_matmul_ref``) within ``K2_REL_TOL`` of
``sum_g |s| * sum_k |x * grid[code]|`` per element, for row-split e2m1
nibbles and one-per-byte e2m3 and e2m1 codes, bfloat16 and float32 ``x``.

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
def test_cuda_k2_raises_without_a_decoder(cuda_device):
    w = torch.randn((128, 256), device=cuda_device)
    pw = P.pack(w, "fp_e1", 128)
    x = torch.randn((4, 256), device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        QM.packed_matmul(x, pw.codes, pw.scales, "fp_e1", 128,
                         pw.nibble_packed)
