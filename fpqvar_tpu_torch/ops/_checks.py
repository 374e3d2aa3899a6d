"""Operand checks and a tolerance helper shared by the kernel wrappers."""
from __future__ import annotations

import torch


def check_device(*ops):
    """All operands on one device, the CPU (plain version) or a CUDA card."""
    devs = {t.device for t in ops}
    if len(devs) != 1:
        raise ValueError(f"operands on several devices: {devs}")
    dev = ops[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


def check_cuda_layout(name: str, *ops, aligned=()):
    """The kernels read contiguous rows in 16-byte chunks."""
    if not all(t.is_contiguous() for t in ops):
        raise ValueError(f"{name} operands must be contiguous")
    if any(t.data_ptr() % 16 for t in aligned):
        raise ValueError(f"{name} row operands must be 16-byte aligned "
                         "(the kernel copies them in 16-byte chunks)")


def bf16_gap(plain: torch.Tensor, tol: torch.Tensor) -> torch.Tensor:
    """One bfloat16 gap (float32) at the largest magnitude that two float32
    sums within ``tol`` of the bfloat16 value ``plain`` can have: such sums
    may round to neighbouring bfloat16 values, each moving by half a gap at
    its magnitude, which is at most ``(|plain| + tol) * (1 + 2^-6)``.  The
    gap is ``2^(e - 7)`` for a magnitude in ``[2^e, 2^(e+1))`` (8
    significant bits), floored at the smallest normal's."""
    v = (plain.abs().to(torch.float32) + tol) * (1 + 2.0 ** -6)
    _, e = torch.frexp(v.clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)
