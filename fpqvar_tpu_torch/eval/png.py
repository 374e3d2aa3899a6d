"""A small PNG codec on the standard library's ``zlib``.

The evaluation path writes tens of thousands of PNGs and reads them back,
on machines without Pillow.  The writer does what the JAX package's native
encoder does (``native/fpq_native.cpp`` ``encode_png``): 8-bit RGB, one
IDAT chunk at deflate level 1, each row filtered None or Sub, whichever
has the smaller sum of absolute residuals; a batch is written by a thread
pool (``zlib`` releases the GIL).  The reader takes 8-bit grey, grey +
alpha, RGB and RGBA images, non-interlaced, with every filter type (0-4),
so it reads what Pillow and the native encoder write; it returns RGB.
"""
from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels per PNG colour type (8-bit): grey, RGB, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _filter_rows(img: np.ndarray) -> bytes:
    """The filtered scanlines of an [H, W, 3] uint8 image: per row None
    (0) or Sub (1), by the native encoder's cost (None: each byte as a
    signed residual; Sub: the signed difference from the byte 3 back)."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3)
    left = np.zeros_like(rows)
    left[:, 3:] = rows[:, :-3]
    sub = rows - left                                   # uint8, wraps
    none_cost = np.minimum(rows, 256 - rows.astype(np.int32)).sum(1)
    sub_cost = np.abs(sub.view(np.int8).astype(np.int32)).sum(1)
    use_sub = sub_cost < none_cost
    out = np.empty((h, w * 3 + 1), np.uint8)
    out[:, 0] = use_sub
    out[:, 1:] = np.where(use_sub[:, None], sub, rows)
    return out.tobytes()


def encode_png(img: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> the bytes of an 8-bit RGB PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w, c = img.shape
    if c != 3:
        raise ValueError(f"encode_png takes [H, W, 3] uint8, got {img.shape}")
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(_filter_rows(img), 1))
            + _chunk(b"IEND", b""))


def write_png(img: np.ndarray, path: str) -> None:
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def write_png_batch(imgs: np.ndarray, paths: Sequence[str]) -> None:
    """[B, H, W, 3] uint8 -> one PNG per path, encoded and written by a
    thread pool (a thread a core, at most 16)."""
    if len(paths) != imgs.shape[0]:
        raise ValueError(f"{len(paths)} paths for {imgs.shape[0]} images")
    workers = max(1, min(16, os.cpu_count() or 4, len(paths)))
    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(write_png, imgs, paths))


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of ``raw`` -> [H, W * bpp] uint8."""
    stride = w * bpp
    data = np.frombuffer(raw, np.uint8)
    if data.size != h * (stride + 1):
        raise ValueError(f"PNG data of {data.size} bytes, expected "
                         f"{h * (stride + 1)}")
    data = data.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = data[y, 0], data[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:          # Sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(stride)
        elif ft == 2:          # Up
            cur = line + prior
        elif ft in (3, 4):     # Average, Paeth: each pixel needs its left
            cur = np.empty(stride, np.uint8)
            a = np.zeros(bpp, np.int32)
            lin = line.astype(np.int32)
            pri = prior.astype(np.int32)
            c = np.zeros(bpp, np.int32)
            for i in range(0, stride, bpp):
                b = pri[i:i + bpp]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                a = (lin[i:i + bpp] + pred) & 0xFF
                cur[i:i + bpp] = a
                c = b
        else:
            raise ValueError(f"PNG filter type {ft} unknown")
        out[y] = cur
        prior = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """The bytes of an 8-bit, non-interlaced PNG (grey, grey + alpha, RGB
    or RGBA) -> [H, W, 3] uint8 RGB (grey replicated, alpha dropped)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}: only 8-bit grey / RGB "
                         "(+ alpha), non-interlaced, is read")
    bpp = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w, bpp).reshape(
        h, w, bpp)
    if bpp in (1, 2):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
