"""Image files and resizing without an imaging package.

The JAX package reads, writes and resizes images through PIL
(``tpgan_tpu/data/multipie.py:67-71,165-177``, ``prepare.py:44-72``,
``synthetic_faces.py:272``). The port does the same work with the
standard library's ``zlib`` and numpy alone:

* :func:`read_png` decodes 8-bit, non-interlaced PNGs (grey, grey+alpha,
  RGB, RGBA) with all five row filters, so files written by PIL's
  adaptive-filter encoder read back pixel for pixel;
* :func:`write_png` writes 8-bit RGB with filter 0 on every row, which
  :func:`read_png` decodes on its vectorised path;
* :func:`resize_lanczos_u8` reproduces PIL's 8-bit
  ``Image.resize(size, Image.LANCZOS)`` (``ImagingResample`` in Pillow's
  ``Resample.c``) to the bit.
"""

from __future__ import annotations

import math
import struct
import zlib
from typing import List, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels, for bit depth 8
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    # each scanline starts with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def _chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends before IEND")


def _unfilter_slow(kind: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) rows in place: each byte depends on the
    reconstructed byte ``bpp`` to its left."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG to a uint8 (H, W, C) array, C
    = 1 (grey), 2 (grey + alpha), 3 (RGB) or 4 (RGBA). Other PNGs
    (palette, 16-bit, interlaced) raise ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: unsupported PNG (bit depth {depth}, colour type {color}, "
                         f"interlace {interlace}); 8-bit non-interlaced grey/RGB(A) only")
    c = _CHANNELS[color]
    stride = w * c
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"{path}: PNG image data holds {raw.size} bytes, expected "
                         f"{h * (stride + 1)}")
    raw = raw.reshape(h, stride + 1)
    kinds = raw[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"{path}: PNG row filter {int(kinds.max())} is not 0-4")
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        line, kind = raw[y, 1:], int(kinds[y])
        if kind == 0:
            out[y] = line
        elif kind == 1:  # Sub: a running sum mod 256 along each channel
            out[y] = np.cumsum(line.reshape(w, c), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            out[y] = line + prev
        else:
            buf = bytearray(line.tobytes())
            _unfilter_slow(kind, buf, prev.tobytes(), c)
            out[y] = np.frombuffer(buf, np.uint8)
        prev = out[y]
    return out.reshape(h, w, c)


def read_rgb(path: str) -> np.ndarray:
    """:func:`read_png` as (H, W, 3) RGB, as PIL's ``convert("RGB")``
    gives it: grey is repeated, alpha is dropped."""
    img = read_png(path)
    if img.shape[2] <= 2:
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


# ---- PIL's 8-bit Lanczos resize ----------------------------------------

_PRECISION_BITS = 32 - 8 - 2  # Resample.c: 22 fractional bits
_LANCZOS_SUPPORT = 3.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    if -3.0 <= x < 3.0:
        return _sinc(x) * _sinc(x / 3)
    return 0.0


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """Per output pixel: the first input index and the fixed-point weights
    of its window ((out, ksize) int64, zero past the window), as
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` make them. The
    weights use ``math.sin`` (C's libm, as Pillow does): numpy's SIMD sine
    may differ in the last ulp, which the 22-bit rounding can expose."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _LANCZOS_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    starts = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    one = float(1 << _PRECISION_BITS)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k: List[float] = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        # rounded half away from zero, as the C casts in
        # normalize_coeffs_8bpc truncate toward zero
        weights[xx, :xmax] = [int(w * one - 0.5) if w < 0 else int(w * one + 0.5) for w in k]
        starts[xx] = xmin
    return starts, weights


def _resample_axis(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass of ``ImagingResampleHorizontal/Vertical_8bpc`` along
    ``axis`` (1 = width, 0 = height) of an (H, W, C) uint8 image."""
    in_size = img.shape[axis]
    starts, weights = _coeffs(in_size, out_size)
    idx = np.minimum(starts[:, None] + np.arange(weights.shape[1]), in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.einsum("ok,okjc->ojc", weights, src[idx])
    acc += 1 << (_PRECISION_BITS - 1)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize_lanczos_u8(arr: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.fromarray(arr).resize(size, Image.LANCZOS)`` for an
    (H, W) grey or (H, W, 3) RGB uint8 array; ``size`` is (width,
    height), as PIL takes it. The horizontal pass runs first and the
    vertical pass reads its uint8 result; a pass whose size is unchanged
    is skipped."""
    arr = np.asarray(arr)
    if arr.dtype != np.uint8 or arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] != 3):
        raise ValueError(f"resize_lanczos_u8 takes (H, W) or (H, W, 3) uint8, got "
                         f"{arr.shape} {arr.dtype}")
    w, h = size
    img = arr[:, :, None] if arr.ndim == 2 else arr
    if w != img.shape[1]:
        img = _resample_axis(img, 1, w)
    if h != img.shape[0]:
        img = _resample_axis(img, 0, h)
    return img[:, :, 0] if arr.ndim == 2 else np.ascontiguousarray(img)
