"""ctypes bindings of the host library ``csrc/fpq_native.cpp``.

The JAX package's ``utils/native.py``, with its functions and their numpy
fallbacks.  The library is compiled at first use with ``g++ -O3 -fPIC
-shared ... -lpthread -lz`` by ``ops/_build.py`` :func:`build_host` into
the port's build directory; nothing is written beside the sources.  A
failed build is not silent: the compiler's message is kept
(:func:`build_error`) and warned about once, and the numpy fallbacks take
over, with the same results (:func:`write_png_batch` then returns False
and its callers write through ``eval/png.py``).
"""
from __future__ import annotations

import ctypes
import threading
import time
import warnings
from typing import Optional

import numpy as np

from fpqvar_tpu_torch.ops import _build

ABI_VERSION = 2
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None
_build_s: Optional[float] = None


def _bind(lib: ctypes.CDLL) -> None:
    i64, i32 = ctypes.c_int64, ctypes.c_int
    f32p, i32p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)
    i8p, u8p = ctypes.POINTER(ctypes.c_int8), ctypes.POINTER(ctypes.c_uint8)
    lib.fpq_snap.argtypes = [f32p, i64, f32p, i32, f32p]
    lib.fpq_snap.restype = None
    lib.fpq_encode.argtypes = [f32p, i64, f32p, i32, i32p]
    lib.fpq_encode.restype = None
    lib.fpq_pack_rows.argtypes = [i32p, i64, i64, i8p]
    lib.fpq_pack_rows.restype = None
    lib.fpq_images_to_u8.argtypes = [f32p, i64, i64, i64, u8p]
    lib.fpq_images_to_u8.restype = None
    lib.fpq_write_png_batch.argtypes = [
        u8p, i64, i64, i64, ctypes.POINTER(ctypes.c_char_p)]
    lib.fpq_write_png_batch.restype = i32
    lib.fpq_zlib_version.argtypes = []
    lib.fpq_zlib_version.restype = ctypes.c_char_p
    lib.fpq_abi_version.argtypes = []
    lib.fpq_abi_version.restype = i32


def _load() -> Optional[ctypes.CDLL]:
    """The library, built and loaded once; None (with :func:`build_error`
    set) where it cannot be."""
    global _lib, _tried, _error, _build_s
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            t0 = time.perf_counter()
            path = _build.build_host("fpq_native")
            _build_s = time.perf_counter() - t0
            lib = ctypes.CDLL(str(path))
            _bind(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _error = str(e)
        else:
            if lib.fpq_abi_version() == ABI_VERSION:
                _lib = lib
            else:
                _error = (f"fpq_native ABI {lib.fpq_abi_version()}, expected "
                          f"{ABI_VERSION}")
        if _error is not None:
            warnings.warn(f"native host library unavailable, numpy "
                          f"fallbacks in use: {_error}", RuntimeWarning,
                          stacklevel=3)
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's output, or the load
    error), or None when it loaded."""
    _load()
    return _error


def build_seconds() -> Optional[float]:
    """Seconds the first load spent compiling (or finding the cached
    library); None before a load, or if the build failed."""
    _load()
    return _build_s


def abi_version() -> Optional[int]:
    lib = _load()
    return None if lib is None else lib.fpq_abi_version()


def zlib_version() -> Optional[str]:
    """``zlibVersion()`` of the libz the library runs on (None without the
    library); ``eval/png.py``'s bytes equal the native encoder's only where
    Python's ``zlib.ZLIB_RUNTIME_VERSION`` is the same."""
    lib = _load()
    return None if lib is None else lib.fpq_zlib_version().decode()


def _fp(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _mids(g: np.ndarray) -> np.ndarray:
    return (g[1:] + g[:-1]) / 2


def snap_to_grid(x: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Nearest-grid snap of float32 ``x`` onto a sorted grid; a midpoint
    snaps to the larger value (``searchsorted(mids, x, side="right")``),
    as ``ops/quantizers.snap_to_grid``."""
    xf = np.ascontiguousarray(x, np.float32)
    g = np.ascontiguousarray(grid, np.float32)
    lib = _load()
    if lib is None:
        return g[np.searchsorted(_mids(g), xf, side="right")]
    out = np.empty_like(xf)
    lib.fpq_snap(_fp(xf, ctypes.c_float), xf.size, _fp(g, ctypes.c_float),
                 len(g), _fp(out, ctypes.c_float))
    return out.reshape(np.shape(x))


def encode_to_grid(x: np.ndarray, grid: np.ndarray) -> np.ndarray:
    """Nearest-grid code indices (int32), the tie rule of
    :func:`snap_to_grid`."""
    xf = np.ascontiguousarray(x, np.float32)
    g = np.ascontiguousarray(grid, np.float32)
    lib = _load()
    if lib is None:
        return np.searchsorted(_mids(g), xf, side="right").astype(np.int32)
    out = np.empty(xf.shape, np.int32)
    lib.fpq_encode(_fp(xf, ctypes.c_float), xf.size, _fp(g, ctypes.c_float),
                   len(g), _fp(out, ctypes.c_int32))
    return out


def pack_rows(codes: np.ndarray) -> np.ndarray:
    """Row-split nibble pack: ``[rows, cols]`` int32 codes -> ``[rows / 2,
    cols]`` int8 (rows % 128 == 0), ``ops/packing.py``'s layout: in each
    128-row tile, byte row r holds code r in its low and code r + 64 in its
    high nibble."""
    c = np.ascontiguousarray(codes, np.int32)
    rows, cols = c.shape
    if rows % 128:
        raise ValueError(f"rows must be divisible by 128, got {rows}")
    lib = _load()
    if lib is None:
        ct = c.reshape(rows // 128, 128, cols)
        return ((ct[:, :64] & 0xF) | ((ct[:, 64:] & 0xF) << 4)).astype(
            np.int8).reshape(rows // 2, cols)
    out = np.empty((rows // 2, cols), np.int8)
    lib.fpq_pack_rows(_fp(c, ctypes.c_int32), rows, cols,
                      _fp(out, ctypes.c_int8))
    return out


def images_to_uint8(imgs: np.ndarray) -> np.ndarray:
    """``[B, 3, H, W]`` floats in [0, 1] -> ``[B, H, W, 3]`` uint8: ``x *
    255`` in float32, clamped to [0, 255], truncated."""
    x = np.ascontiguousarray(imgs, np.float32)
    b, c, h, w = x.shape
    if c != 3:
        raise ValueError(f"images_to_uint8 takes [B, 3, H, W], got {x.shape}")
    lib = _load()
    if lib is None:
        arr = np.transpose(x, (0, 2, 3, 1)) * np.float32(255.0)
        return np.clip(arr, 0, 255).astype(np.uint8)
    out = np.empty((b, h, w, 3), np.uint8)
    lib.fpq_images_to_u8(_fp(x, ctypes.c_float), b, h, w,
                         _fp(out, ctypes.c_uint8))
    return out


def write_png_batch(imgs: np.ndarray, paths) -> bool:
    """Write ``[B, H, W, 3]`` uint8 images as PNGs, a thread per image
    (zlib level 1, None / Sub row filters).  Returns False without the
    library (the caller writes through ``eval/png.py``) and raises
    ``OSError`` when an image could not be written."""
    lib = _load()
    if lib is None:
        return False
    x = np.ascontiguousarray(imgs, np.uint8)
    b, h, w, c = x.shape
    if c != 3 or len(paths) != b:
        raise ValueError(f"{len(paths)} paths for images of shape {x.shape}")
    arr = (ctypes.c_char_p * b)(*[str(p).encode() for p in paths])
    fails = lib.fpq_write_png_batch(_fp(x, ctypes.c_uint8), b, h, w, arr)
    if fails:
        raise OSError(f"fpq_write_png_batch: {fails}/{b} images failed")
    return True
