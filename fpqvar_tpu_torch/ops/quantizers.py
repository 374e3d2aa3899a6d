"""Nearest-grid snap shared by the integer-code quantizers."""
from __future__ import annotations

import numpy as np
import torch


def snap_to_grid(x: torch.Tensor, grid) -> torch.Tensor:
    """Map every element of ``x`` to the nearest value of a sorted grid.

    Gather-free compare-sum, in the JAX package's order:
    ``snapped = grid[0] + sum_i deltas[i] * [x >= mids[i]]`` accumulated in
    float32, so the result is bit-equal.  ``x == mid`` counts as ``>=``:
    an exact midpoint snaps to the larger value.
    """
    g = np.asarray(grid, dtype=np.float32)
    mids = (g[1:] + g[:-1]) * np.float32(0.5)
    deltas = g[1:] - g[:-1]
    xf = x.to(torch.float32)
    out = torch.full(x.shape, float(g[0]), dtype=torch.float32,
                     device=x.device)
    for m, d in zip(mids.tolist(), deltas.tolist()):
        # [x >= m] * d is exactly d or +0, as JAX's where(x >= m, d, 0)
        out = out + (xf >= m).to(torch.float32) * d
    return out.to(x.dtype)
