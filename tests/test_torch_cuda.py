"""Kernel K1 on the card: the Hopper kernel against its plain PyTorch
version (``int8_group_gemm_ref``) at the VAR-d16 shapes, a ragged one and
tiny ones, within 1e-5 of ``sum_g |sa*sw*part|`` per element (the group
parts are exact; only the f32 order over the groups differs).

The tests are marked ``cuda`` and skip without a CUDA device.  The file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from fpqvar_tpu_torch.ops import int8_matmul as K
from fpqvar_tpu_torch.ops import packing as P


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
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
