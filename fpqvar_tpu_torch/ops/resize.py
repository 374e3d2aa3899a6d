"""Image resizing with torch ``F.interpolate`` semantics as separable
matrices (bicubic A = -0.75 with edge-clamped taps, and ``area``), built in
numpy once per size pair and applied with two ``einsum``s — the same
operators as the JAX package's ``ops/resize.py``; and the nearest 2x
upsampling of the VQVAE decoder."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_A = -0.75  # torch's bicubic coefficient


def _cubic1(t):
    return ((_A + 2.0) * t - (_A + 3.0)) * t * t + 1.0


def _cubic2(t):
    return (((t - 5.0) * t + 8.0) * t - 4.0) * _A


@lru_cache(maxsize=None)
def bicubic_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of a 1-D bicubic resize (align_corners=False,
    border-replicate tap clamping)."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        x0 = int(np.floor(src))
        t = src - x0
        w = np.array([
            _cubic2(t + 1.0), _cubic1(t), _cubic1(1.0 - t), _cubic2(2.0 - t),
        ])
        for k in range(4):
            j = min(max(x0 - 1 + k, 0), in_size - 1)
            m[i, j] += w[k]
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def area_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) matrix of ``mode='area'`` (adaptive average pooling):
    output i averages inputs [floor(i*in/out), ceil((i+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float64)
    for i in range(out_size):
        i0 = (i * in_size) // out_size
        i1 = -((-(i + 1) * in_size) // out_size)
        m[i, i0:i1] = 1.0 / (i1 - i0)
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def _matrix(mode: str, in_size: int, out_size: int, device: torch.device,
            dtype: torch.dtype) -> torch.Tensor:
    """The resize matrix as a tensor on ``device``, copied there once (as a
    normal tensor, even when first asked for under inference mode)."""
    mk = bicubic_matrix if mode == "bicubic" else area_matrix
    with torch.inference_mode(False):
        return torch.from_numpy(mk(in_size, out_size)).to(device=device,
                                                           dtype=dtype)


def resize2d(x: torch.Tensor, out_hw: tuple, mode: str) -> torch.Tensor:
    """Resize ``[..., H, W]`` -> ``[..., out_h, out_w]``."""
    h, w = x.shape[-2], x.shape[-1]
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    mh = _matrix(mode, h, oh, x.device, x.dtype)
    mw = _matrix(mode, w, ow, x.device, x.dtype)
    y = torch.einsum("oh,...hw->...ow", mh, x)
    return torch.einsum("pw,...ow->...op", mw, y)


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """``[..., H, W]`` -> ``[..., 2H, 2W]``, nearest: each value repeated
    twice along both axes (the VQVAE decoder's upsampling)."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
