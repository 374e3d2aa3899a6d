"""Straight-through estimators for quantization-aware optimization.

The JAX package's ``quantize/ste.py``: forward = fake quantization,
backward = identity.  The forward keeps JAX's expression ``x + (q(x) -
x)``, which in float32 can differ from ``q(x)`` in the last bit; the
difference is taken without a graph, so autograd sees only ``x + const``.
"""
from __future__ import annotations

from functools import partial

import torch

from fpqvar_tpu_torch.ops import quantizers as Q


def ste(quant_fn):
    """Wrap a fake-quant function with identity gradients."""

    def wrapped(x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            delta = quant_fn(x) - x
        return x + delta

    return wrapped


def fp_quant_ste(fmt: str = "fp_e2", group_size: int = 128):
    """STE fp-grid per-group quantizer."""
    return ste(partial(Q.fake_quant_fp, fmt=fmt, granularity="per_group",
                       group_size=group_size))


def int_sym_ste(n_bits: int = 4, group_size: int = 128):
    """STE symmetric int per-group quantizer."""
    return ste(partial(Q.fake_quant_int_sym, n_bits=n_bits,
                       granularity="per_group", group_size=group_size))
