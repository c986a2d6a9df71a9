"""ctypes binding of the host data-pipeline library
(``tpgan_tpu_torch/csrc/host/tpgan_host.cpp``) — the port of
``tpgan_tpu/data/native.py``.

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
