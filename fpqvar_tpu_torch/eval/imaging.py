"""Image I/O: uint8 conversion, PNG writing and npz packing of a sample
folder.

The JAX package's ``eval/imaging.py``: the reference's per-image PNG save
(``evaluate_fp_quant_transform_rotate.py:203-207``) and ``pack_figs.py``
(``create_npz_from_sample_folder``).  The uint8 conversion runs on the
images' device with the native encoder's semantics (``clamp(x * 255, 0,
255)`` in float32, then truncation), so only uint8 data crosses to the
host; PNGs go through ``eval/png.py``.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from fpqvar_tpu_torch.eval import png


def to_uint8_device(images: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] floats in [0, 1] -> [B, H, W, 3] uint8 on their device:
    ``x * 255`` in float32, clamped to [0, 255], truncated (the native
    ``fpq_images_to_u8``, and JAX's numpy fallback)."""
    x = images.to(torch.float32) * 255.0
    return x.clamp(0.0, 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def to_uint8(images) -> np.ndarray:
    """[B, 3, H, W] floats in [0, 1] (a tensor on any device, or numpy) ->
    [B, H, W, 3] uint8 numpy."""
    return to_uint8_device(torch.as_tensor(images)).cpu().numpy()


def png_paths(out_dir: str, class_id: int, start_idx: int, n: int):
    """``class{c}_img{j}.png`` for j from ``start_idx`` (the reference's
    naming)."""
    return [os.path.join(out_dir, f"class{class_id}_img{start_idx + j}.png")
            for j in range(n)]


def save_uint8_png(arr: np.ndarray, out_dir: str, class_id: int,
                   start_idx: int = 0) -> None:
    """Write [B, H, W, 3] uint8 images as PNGs, a thread per image."""
    os.makedirs(out_dir, exist_ok=True)
    png.write_png_batch(arr, png_paths(out_dir, class_id, start_idx,
                                       arr.shape[0]))


def save_images_png(images, out_dir: str, class_id: int,
                    start_idx: int = 0) -> None:
    """Save a batch of [B, 3, H, W] floats in [0, 1] as
    ``class{c}_img{j}.png``."""
    save_uint8_png(to_uint8(images), out_dir, class_id, start_idx)


def read_png_folder(sample_dir: str) -> np.ndarray:
    """Every PNG of a folder, in sorted name order -> [N, H, W, 3] uint8,
    decoded by a thread pool."""
    files = sorted(f for f in os.listdir(sample_dir)
                   if f.lower().endswith(".png"))
    with ThreadPoolExecutor(min(16, (os.cpu_count() or 4) * 2)) as ex:
        samples = list(ex.map(
            lambda f: png.read_png(os.path.join(sample_dir, f)), files))
    if not samples:
        raise ValueError(f"{sample_dir}: no PNG files")
    return np.stack(samples)


def create_npz_from_sample_folder(
    sample_dir: str, expected: Optional[int] = 50_000
) -> str:
    """Pack a folder of PNGs into ``<dir>.npz`` with key ``arr_0`` [N, H,
    W, 3] uint8 (``pack_figs.py:8-24``; its 50k assert becomes an
    optional check)."""
    arr = read_png_folder(sample_dir)
    if expected is not None and arr.shape[0] != expected:
        raise ValueError(f"expected {expected} samples, found {arr.shape[0]}")
    out = sample_dir.rstrip("/") + ".npz"
    np.savez(out, arr_0=arr)
    return out
