"""ctypes binding of the host data-pipeline library
(``tpgan_tpu_torch/csrc/host/tpgan_host.cpp``) — the port of
``tpgan_tpu/data/native.py``, plus the JPEG codec's Huffman entropy
decode and encode (:mod:`tpgan_tpu_torch.data.imageio`).

The library is built with ``g++`` at first use (``ops/_build.py::
build_host``) into ``build/tpgan_tpu_torch/``. Unlike the JAX binding,
nothing falls back: a failed build or load raises. The numpy versions
stay beside each function as ``*_reference``, for the tests.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Optional, Tuple

import numpy as np

from tpgan_tpu_torch.ops import _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The host library, built first if needed; raises if it cannot be."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build.build_host()))
        u8, f32, i32 = (ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
                        ctypes.POINTER(ctypes.c_int))
        lib.u8_to_pm1.argtypes = [u8, f32, ctypes.c_int64]
        lib.u8_to_unit.argtypes = [u8, f32, ctypes.c_int64]
        lib.crop_patch_f32.argtypes = [
            f32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_int, ctypes.c_int, f32,
        ]
        lib.letterbox_u8.argtypes = [
            u8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, f32, f32, i32, i32,
        ]
        for fn in (lib.u8_to_pm1, lib.u8_to_unit, lib.crop_patch_f32, lib.letterbox_u8):
            fn.restype = None
        i32p, i64 = ctypes.POINTER(ctypes.c_int32), ctypes.c_int64
        lib.jpeg_huff_decode.argtypes = [u8, i64, i64, ctypes.c_int, i32p, u8, u8, i64,
                                         ctypes.c_int, i32p]
        lib.jpeg_huff_decode.restype = i64
        lib.jpeg_huff_encode.argtypes = [i32p, i64, ctypes.c_int, i32p, ctypes.c_int, u8, u8,
                                         u8, i64]
        lib.jpeg_huff_encode.restype = i64
        _lib = lib
        return _lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def u8_to_pm1(src: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1] (ToTensor*2-1), as (2v - 255) / 255:
    endpoint-exact (0 -> -1.0, 255 -> 1.0)."""
    src = np.ascontiguousarray(src, np.uint8)
    out = np.empty(src.shape, np.float32)
    load().u8_to_pm1(_u8ptr(src), _fptr(out), src.size)
    return out


def u8_to_pm1_reference(src: np.ndarray) -> np.ndarray:
    return (2.0 * np.asarray(src, np.uint8).astype(np.float32) - 255.0) / 255.0


def u8_to_unit(src: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [0, 1] (ToTensor)."""
    src = np.ascontiguousarray(src, np.uint8)
    out = np.empty(src.shape, np.float32)
    load().u8_to_unit(_u8ptr(src), _fptr(out), src.size)
    return out


def u8_to_unit_reference(src: np.ndarray) -> np.ndarray:
    # the C loop multiplies by the float32 1/255, as here
    return np.asarray(src, np.uint8).astype(np.float32) * np.float32(1.0 / 255.0)


def crop_patch(img: np.ndarray, center_xy: Tuple[float, float],
               size_wh: Tuple[int, int]) -> np.ndarray:
    """Single landmark-centred zero-padded crop (DataAndDataset.py:46-54
    geometry) from an HWC float32 image."""
    img = np.ascontiguousarray(img, np.float32)
    if img.ndim != 3:
        raise ValueError(f"crop_patch takes an HWC image, got {img.shape}")
    w, h = size_wh
    out = np.empty((h, w, img.shape[2]), np.float32)
    load().crop_patch_f32(
        _fptr(img), img.shape[0], img.shape[1], img.shape[2],
        ctypes.c_float(center_xy[0]), ctypes.c_float(center_xy[1]), w, h, _fptr(out),
    )
    return out


def crop_patch_reference(img: np.ndarray, center_xy: Tuple[float, float],
                         size_wh: Tuple[int, int]) -> np.ndarray:
    img = np.asarray(img, np.float32)
    w, h = size_wh
    x = int(np.floor(np.float32(center_xy[0])))
    y = int(np.floor(np.float32(center_xy[1])))
    left, top = x - w // 2 + 1, y - h // 2 + 1
    out = np.zeros((h, w, img.shape[2]), np.float32)
    src_t, src_b = max(top, 0), min(top + h, img.shape[0])
    src_l, src_r = max(left, 0), min(left + w, img.shape[1])
    if src_b > src_t and src_r > src_l:
        out[src_t - top:src_b - top, src_l - left:src_r - left] = img[src_t:src_b, src_l:src_r]
    return out


def letterbox(src: np.ndarray, size: int):
    """uint8 HWC -> ([0,1] float32 (size,size,C), scale, (pad_l, pad_t)):
    an aspect-preserving bilinear resize (align_corners=False, no
    antialias) centred in a zero square."""
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim != 3:
        raise ValueError(f"letterbox takes an HWC image, got {src.shape}")
    h, w, c = src.shape
    out = np.empty((size, size, c), np.float32)
    scale, pl, pt = ctypes.c_float(), ctypes.c_int(), ctypes.c_int()
    load().letterbox_u8(
        _u8ptr(src), h, w, c, size, _fptr(out),
        ctypes.byref(scale), ctypes.byref(pl), ctypes.byref(pt),
    )
    return out, float(scale.value), (int(pl.value), int(pt.value))


def letterbox_reference(src: np.ndarray, size: int):
    """The C loop of :func:`letterbox` in float32 numpy, in its order of
    operations."""
    src = np.asarray(src, np.uint8)
    ih, iw, c = src.shape
    f = np.float32
    scale = f(size) / f(max(ih, iw))
    # std::lround of the float product, halves away from zero (the +0.5
    # in double is exact for a float)
    nh = min(max(math.floor(float(f(ih) * scale) + 0.5), 1), size)
    nw = min(max(math.floor(float(f(iw) * scale) + 0.5), 1), size)
    pad_top, pad_left = (size - nh) // 2, (size - nw) // 2
    ry, rx = f(ih) / f(nh), f(iw) / f(nw)

    def axis(n, r, limit):
        s = (np.arange(n, dtype=f) + f(0.5)) * r - f(0.5)
        s = np.minimum(np.maximum(s, f(0.0)), f(limit - 1))
        i0 = s.astype(np.int64)
        return i0, np.minimum(i0 + 1, limit - 1), s - i0.astype(f)

    y0, y1, fy = axis(nh, ry, ih)
    x0, x1, fx = axis(nw, rx, iw)
    p = src.astype(f)
    fx3, fy3 = fx[None, :, None], fy[:, None, None]
    top = p[y0][:, x0] * (f(1.0) - fx3) + p[y0][:, x1] * fx3
    bot = p[y1][:, x0] * (f(1.0) - fx3) + p[y1][:, x1] * fx3
    out = np.zeros((size, size, c), f)
    out[pad_top:pad_top + nh, pad_left:pad_left + nw] = (top * (f(1.0) - fy3) + bot * fy3) * (
        f(1.0) / f(255.0))
    return out, float(scale), (pad_left, pad_top)


# ---- JPEG Huffman entropy coding -----------------------------------------
#
# A scan's tables are passed per component of the scan as (dc_bits,
# dc_vals, ac_bits, ac_vals, blocks per MCU): the 16 code-length counts
# and the symbol values of a DHT segment. Coefficients travel as
# (n_mcus, blocks_per_mcu, 64) int32 arrays in zigzag order, the blocks
# of an MCU component after component.

def _huff_arrays(tables):
    n = len(tables)
    bits = np.zeros((2, n, 16), np.uint8)
    vals = np.zeros((2, n, 256), np.uint8)
    for k, (dcb, dcv, acb, acv, *_rest) in enumerate(tables):
        for j, (b, v) in enumerate(((dcb, dcv), (acb, acv))):
            bits[j, k] = np.frombuffer(bytes(b), np.uint8)
            vals[j, k, :len(v)] = np.frombuffer(bytes(v), np.uint8)
    return bits, vals


_DECODE_ERRORS = {
    -1: "a Huffman code that is in no table",
    -2: "a coefficient run past the end of its block",
    -3: "scan data ends before its last MCU",
    -4: "a restart marker is missing",
    -5: "a Huffman table with more codes than its lengths allow",
}


def jpeg_huff_decode(data: bytes, start: int, tables, n_mcus: int, restart_interval: int):
    """Decode one baseline scan's entropy-coded data from ``data[start:]``:
    returns ((n_mcus, blocks_per_mcu, 64) int32 zigzag coefficients, the
    offset of the marker that ends the scan). Raises ``ValueError`` on
    corrupt data."""
    buf = np.frombuffer(data, np.uint8)
    if not 1 <= len(tables) <= 4 or not 0 <= start <= buf.size:
        raise ValueError(f"a scan of {len(tables)} components from byte {start} of {buf.size}")
    bits, vals = _huff_arrays(tables)
    blocks = np.asarray([t[4] for t in tables], np.int32)
    out = np.zeros((n_mcus, int(blocks.sum()), 64), np.int32)
    i32 = ctypes.POINTER(ctypes.c_int32)
    end = load().jpeg_huff_decode(
        _u8ptr(buf), buf.size, start, len(tables), blocks.ctypes.data_as(i32),
        _u8ptr(bits), _u8ptr(vals), n_mcus, restart_interval, out.ctypes.data_as(i32))
    if end < 0:
        raise ValueError(f"corrupt JPEG scan: {_DECODE_ERRORS.get(end, end)}")
    return out, int(end)


def _canonical_codes(bits: bytes, vals: bytes):
    """(code, length) per symbol of a DHT table (JPEG Annex C)."""
    codes = {}
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitReader:
    """JPEG scan bits, MSB first: 0xFF00 is a stuffed 0xFF; any other
    marker ends the data."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.acc, self.n = data, pos, 0, 0

    def bit(self) -> int:
        if self.n == 0:
            d = self.data
            if self.pos >= len(d) or (d[self.pos] == 0xFF and (
                    self.pos + 1 >= len(d) or d[self.pos + 1] != 0x00)):
                raise ValueError(f"corrupt JPEG scan: {_DECODE_ERRORS[-3]}")
            self.acc = d[self.pos]
            self.pos += 2 if d[self.pos] == 0xFF else 1
            self.n = 8
        self.n -= 1
        return (self.acc >> self.n) & 1

    def bits(self, count: int) -> int:
        v = 0
        for _ in range(count):
            v = (v << 1) | self.bit()
        return v

    def restart(self) -> None:
        """Drop the byte's remaining bits and read an RSTn marker."""
        self.n = 0
        d = self.data
        if not (self.pos + 1 < len(d) and d[self.pos] == 0xFF and 0xD0 <= d[self.pos + 1] <= 0xD7):
            raise ValueError(f"corrupt JPEG scan: {_DECODE_ERRORS[-4]}")
        self.pos += 2


def _decode_symbol(reader: _BitReader, table) -> int:
    code, length = 0, 0
    while length < 16:
        code = (code << 1) | reader.bit()
        length += 1
        sym = table.get((code, length))
        if sym is not None:
            return sym
    raise ValueError(f"corrupt JPEG scan: {_DECODE_ERRORS[-1]}")


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def jpeg_huff_decode_reference(data: bytes, start: int, tables, n_mcus: int,
                               restart_interval: int):
    """:func:`jpeg_huff_decode` in plain Python."""
    lookups = [[{(c, n): s for s, (c, n) in _canonical_codes(b, v).items()}
                for b, v in ((t[0], t[1]), (t[2], t[3]))] for t in tables]
    reader = _BitReader(bytes(data), start)
    out = np.zeros((n_mcus, sum(t[4] for t in tables), 64), np.int32)
    pred = [0] * len(tables)
    for m in range(n_mcus):
        if restart_interval and m and m % restart_interval == 0:
            reader.restart()
            pred = [0] * len(tables)
        blk = 0
        for k, t in enumerate(tables):
            dc, ac = lookups[k]
            for _ in range(t[4]):
                s = _decode_symbol(reader, dc)
                pred[k] += _extend(reader.bits(s), s) if s else 0
                out[m, blk, 0] = pred[k]
                i = 1
                while i < 64:
                    rs = _decode_symbol(reader, ac)
                    r, s = rs >> 4, rs & 15
                    if s:
                        i += r
                        if i > 63:
                            raise ValueError(f"corrupt JPEG scan: {_DECODE_ERRORS[-2]}")
                        out[m, blk, i] = _extend(reader.bits(s), s)
                        i += 1
                    elif r == 15:
                        i += 16
                    else:
                        break
                blk += 1
    # the scan's data ends at the next marker
    d, pos = reader.data, reader.pos
    while pos + 1 < len(d) and not (d[pos] == 0xFF and d[pos + 1] != 0x00):
        pos += 1
    return out, pos


def jpeg_huff_encode(coefs: np.ndarray, block_comp: np.ndarray, tables) -> bytes:
    """Huffman-code (n_mcus, blocks_per_mcu, 64) int32 zigzag
    coefficients, block b of each MCU coded with the tables of component
    ``block_comp[b]`` and its own DC prediction: the scan's bytes, 0xFF
    stuffed, the last byte padded with 1 bits."""
    coefs = np.ascontiguousarray(coefs, np.int32)
    block_comp = np.ascontiguousarray(block_comp, np.int32)
    if coefs.ndim != 3 or coefs.shape[2] != 64 or block_comp.shape != coefs.shape[1:2]:
        raise ValueError(f"coefficients {coefs.shape} and block components {block_comp.shape}: "
                         "expected (n_mcus, blocks, 64) and (blocks,)")
    if not 1 <= len(tables) <= 4 or block_comp.min(initial=0) < 0 or \
            block_comp.max(initial=0) >= len(tables):
        raise ValueError(f"{len(tables)} Huffman table sets for block components "
                         f"{block_comp.tolist()}")
    bits, vals = _huff_arrays(tables)
    n_mcus, nblocks = coefs.shape[:2]
    # at most 26 bits per coefficient, doubled by stuffing
    cap = n_mcus * nblocks * 64 * 8 + 64
    out = np.empty(cap, np.uint8)
    i32 = ctypes.POINTER(ctypes.c_int32)
    n = load().jpeg_huff_encode(
        coefs.ctypes.data_as(i32), n_mcus, nblocks, block_comp.ctypes.data_as(i32),
        len(tables), _u8ptr(bits), _u8ptr(vals), _u8ptr(out), cap)
    if n < 0:
        raise ValueError("JPEG Huffman encode failed: a coefficient out of range for 8-bit data")
    return out[:n].tobytes()


def jpeg_huff_encode_reference(coefs: np.ndarray, block_comp: np.ndarray, tables) -> bytes:
    """:func:`jpeg_huff_encode` in plain Python."""
    codes = [(_canonical_codes(t[0], t[1]), _canonical_codes(t[2], t[3])) for t in tables]
    out = bytearray()
    acc, n = 0, 0

    def emit(value: int, length: int) -> None:
        nonlocal acc, n
        acc = (acc << length) | (value & ((1 << length) - 1))
        n += length
        while n >= 8:
            byte = (acc >> (n - 8)) & 0xFF
            out.append(byte)
            if byte == 0xFF:
                out.append(0)
            n -= 8
        acc &= (1 << n) - 1

    pred = [0] * len(tables)
    for mcu in np.asarray(coefs).tolist():
        for b, block in enumerate(mcu):
            k = int(block_comp[b])
            dc, ac = codes[k]
            diff = block[0] - pred[k]
            pred[k] = block[0]
            size = abs(diff).bit_length()
            emit(*dc[size])
            if size:
                emit(diff - 1 if diff < 0 else diff, size)
            run = 0
            for v in block[1:]:
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    emit(*ac[0xF0])
                    run -= 16
                size = abs(v).bit_length()
                emit(*ac[(run << 4) | size])
                emit(v - 1 if v < 0 else v, size)
                run = 0
            if run:
                emit(*ac[0x00])
    if n:
        emit((1 << (8 - n)) - 1, 8 - n)
    return bytes(out)
