"""Value grids of the low-bit floating-point formats (numpy only).

Same constructor and tables as the JAX package's ``ops/grids.py``: every
grid is sorted ascending and quantization uses
``scale = absmax(x) / max(|grid|)``.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np


def fp_grid(exp_bits: int, man_bits: int, *, bias: int | None = None) -> np.ndarray:
    """Sorted value grid of a signed ExMy mini-float with no inf/nan codes,
    subnormals included; the e1 formats use bias 1, the others
    ``2^(e-1) - 1``."""
    if bias is None:
        bias = (2 ** (exp_bits - 1) - 1) if exp_bits >= 2 else 1
    vals = set()
    n_man = 2 ** man_bits
    for e_field in range(2 ** exp_bits):
        for m_field in range(n_man):
            if e_field == 0:
                v = (m_field / n_man) * 2.0 ** (1 - bias)
            else:
                v = (1.0 + m_field / n_man) * 2.0 ** (e_field - bias)
            vals.add(v)
            vals.add(-v)
    vals.add(0.0)
    return np.array(sorted(vals), dtype=np.float32)


FP4_E3M0 = fp_grid(3, 0)                     # ±{0.25,0.5,1,2,4,8,16}, 0
FP4_E2M1 = fp_grid(2, 1)                     # ±{0.5,1,1.5,2,3,4,6}, 0
FP4_E1M2 = fp_grid(1, 2)                     # ±{0.25..1.75 step .25}, 0
FP6_E2M3 = fp_grid(2, 3)                     # ±{0.125..7.5}
FP6_E3M2 = fp_grid(3, 2)                     # ±{0.0625..28}
FP8_E4M3 = fp_grid(4, 3, bias=7)

# half-grids of the asymmetric dual-grid fc2 formats
E1M2_NEG = np.concatenate([FP4_E1M2[FP4_E1M2 < 0], [0.0]]).astype(np.float32)
E2M1_POS = np.concatenate([[0.0], FP4_E2M1[FP4_E2M1 > 0]]).astype(np.float32)
E2M1_NEG = np.concatenate([FP4_E2M1[FP4_E2M1 < 0], [0.0]]).astype(np.float32)
INT_NEG = np.arange(-32.0, 1.0, dtype=np.float32)
E2M3_POS = np.concatenate([[0.0], FP6_E2M3[FP6_E2M3 > 0]]).astype(np.float32)

#: name -> grid used by the single-grid quantizers
GRIDS = {
    "fp_e1": FP4_E1M2,
    "fp_e2": FP4_E2M1,
    "fp_e3": FP4_E3M0,
    "fp6_e2m3": FP6_E2M3,
    "fp6_e3m2": FP6_E3M2,
    "fp8_e4m3": FP8_E4M3,
}

#: name -> (neg_grid, pos_grid) used by the dual-grid quantizers
DUAL_GRIDS = {
    "fp_e1m2_neg_e2m1_pos": (E1M2_NEG, E2M1_POS),
    "fp4_afpq": (E2M1_NEG, E2M1_POS),
    "fp6_int_neg_e2m3_pos": (INT_NEG, E2M3_POS),
}


@lru_cache(maxsize=None)
def grid_midpoints(name: str) -> np.ndarray:
    g = GRIDS[name]
    return ((g[1:] + g[:-1]) / 2.0).astype(np.float32)


def int_grid(n_bits: int, symmetric: bool = True) -> np.ndarray:
    """The integer grid of an ``n_bits`` INT format: ``[-q_max, q_max]``,
    or ``[-q_max - 1, q_max]`` where it is not symmetric."""
    q_max = 2 ** (n_bits - 1) - 1
    q_min = -q_max if symmetric else -q_max - 1
    return np.arange(q_min, q_max + 1, dtype=np.float32)
