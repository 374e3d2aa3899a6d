"""Randomized block-Hadamard rotation.

Every 128-block of the block-diagonal rotation is the same matrix
``Q_b = diag(signs) @ H_128 / sqrt(128)``, so the online activation rotation
``x @ block_diag(Q_b, ..., Q_b)`` is one ``[..., C/128, 128] @ [128, 128]``
matmul.  The signs are the frozen seed-42 table that the JAX package keeps
(``_SEED42_SIGNS_128``); the port never draws them from torch's RNG.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# torch.manual_seed(42); torch.randint(0, 2, (128,)) * 2 - 1   (frozen)
_SEED42_SIGNS_128 = np.array([
    -1, 1, -1, -1, -1, 1, -1, -1, -1, 1, -1, -1, -1, -1, 1, -1,
    1, 1, 1, -1, 1, -1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
    1, 1, 1, -1, 1, -1, -1, -1, -1, -1, 1, 1, 1, 1, 1, -1,
    1, 1, -1, 1, -1, 1, -1, 1, 1, -1, -1, -1, -1, -1, -1, -1,
    -1, 1, 1, -1, 1, 1, 1, 1, -1, 1, -1, 1, 1, 1, -1, 1,
    -1, 1, -1, 1, -1, -1, 1, -1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, -1, -1, 1, 1, 1, 1, 1, 1, 1, 1, -1, 1, -1,
    1, 1, -1, 1, -1, 1, 1, -1, 1, -1, 1, -1, -1, 1, 1, -1,
], dtype=np.float64)


@lru_cache(maxsize=None)
def sylvester_hadamard(n: int) -> np.ndarray:
    """Unnormalized symmetric Hadamard matrix of power-of-two order."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"sylvester_hadamard needs a power of 2, got {n}")
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


def random_hadamard_matrix(size: int = 128, seed: int = 42) -> np.ndarray:
    """``diag(signs) @ H / sqrt(n)`` in float64, for the one sign table the
    port carries (size 128, seed 42)."""
    if (size, seed) != (128, 42):
        raise NotImplementedError(
            "only the 128-block, seed-42 rotation is ported "
            "(ROADMAP: full-size rotation)")
    s = _SEED42_SIGNS_128
    return (s[:, None] * sylvester_hadamard(size)) / np.sqrt(size)


def block_hadamard_block(block_size: int = 128, seed: int = 42) -> np.ndarray:
    """The 128x128 block Q_b shared by every block of the rotation."""
    return random_hadamard_matrix(block_size, seed)


def apply_block_hadamard(x: torch.Tensor, q_block: torch.Tensor) -> torch.Tensor:
    """``x @ block_diag(Q_b, ..., Q_b)`` as one ``[..., C/b, b] @ [b, b]``
    matmul; ``x`` is ``[..., C]`` with ``C % b == 0``."""
    b = q_block.shape[0]
    xb = x.reshape(x.shape[:-1] + (x.shape[-1] // b, b))
    return (xb @ q_block.to(x.dtype)).reshape(x.shape)
