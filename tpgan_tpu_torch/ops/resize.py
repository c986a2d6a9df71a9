"""The port's copy of the parts of ``jax.image`` that the JAX package
calls (``jax/_src/image/scale.py`` in jax 0.9.0): the resampling weight
matrices, ``resize`` and a batched ``scale_and_translate``.

A resize along one axis is a product with an (in, out) weight matrix;
JAX builds the matrices in ``compute_weight_mat`` and applies them with
one ``einsum``, outside any Pallas kernel, so here they are plain
matmuls. Everything is computed in float32, as JAX computes it with x64
off: a scale given as a Python number is rounded to float32 before it
is used, as JAX's weak typing rounds it.

A division by a Python number is the product with its float32
reciprocal (:func:`reciprocal_f32`): XLA compiles JAX's jitted division
by a constant so, and PyTorch's CUDA kernels divide by a CPU scalar so,
which gives the same bits on the card and on the CPU. No constant is
copied from the host, so the functions also run inside a CUDA-graph
capture.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

LANCZOS3_RADIUS = 3.0
METHODS = ("nearest", "linear", "bilinear", "lanczos3")


def reciprocal_f32(value: float) -> float:
    """float32(1 / float32(value)), as a Python number (exact in float32):
    ``x * reciprocal_f32(c)`` is what XLA makes of JAX's ``x / c``."""
    return float(np.float32(1.0) / np.float32(value))


def lanczos3_kernel(x: torch.Tensor) -> torch.Tensor:
    """``_fill_lanczos_kernel(3, x)`` (``scale.py:33-37``): r sin(pi x)
    sin(pi x / r) / (pi x)^2 where x > 1e-3, 1 nearer 0, 0 beyond r."""
    r = LANCZOS3_RADIUS
    pix = math.pi * x
    y = r * torch.sin(pix) * torch.sin(pix * reciprocal_f32(r))
    den = torch.where(x != 0, math.pi ** 2 * (x * x), torch.ones_like(x))
    out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
    return torch.where(x > r, torch.zeros_like(x), out)


def triangle_kernel(x: torch.Tensor) -> torch.Tensor:
    """``_fill_triangle_kernel`` (``scale.py:50-51``): max(0, 1 - |x|)."""
    return torch.clamp_min(1 - torch.abs(x), 0)


KERNELS: dict = {"linear": triangle_kernel, "bilinear": triangle_kernel,
                 "lanczos3": lanczos3_kernel}


def _kernel(method: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if method not in KERNELS:
        raise ValueError(f"unknown resize method {method!r}; expected one of {METHODS}")
    return KERNELS[method]


def compute_weight_mat(
    input_size: int,
    output_size: int,
    scale,
    translation,
    kernel: Callable[[torch.Tensor], torch.Tensor],
    antialias: bool,
    device=None,
) -> torch.Tensor:
    """The (..., input_size, output_size) weights of ``scale.py:54-86``:
    output sample i reads the input at (i + 0.5) / scale - translation /
    scale - 0.5; the kernel widens by 1 / scale when the image shrinks
    (``antialias``); each column is normalised to sum 1 unless its sum is
    within 1000 eps of 0 (then it is 0), and a column whose sample falls
    outside [-0.5, input_size - 0.5] is 0.

    ``scale`` and ``translation`` are Python numbers, or float32 tensors
    of one shape (...,) for a matrix per entry (a batch of images, each
    its own scale). float32 throughout."""
    if torch.is_tensor(scale):
        device = scale.device
        scale = scale.to(torch.float32)
        inv_scale = torch.ones_like(scale) / scale
        kernel_scale = torch.clamp_min(inv_scale, 1.0) if antialias else torch.ones_like(scale)
        translation = torch.as_tensor(translation, dtype=torch.float32, device=device)
        inv_scale, kernel_scale = inv_scale[..., None], kernel_scale[..., None]
        shift = (translation * inv_scale[..., 0])[..., None]
    else:
        inv_scale = 1.0 / scale  # a double, rounded to float32 where it is used
        kernel_scale = max(inv_scale, 1.0) if antialias else 1.0
        shift = translation * inv_scale
    i = torch.arange(output_size, dtype=torch.float32, device=device)
    sample = (i + 0.5) * inv_scale - shift - 0.5  # (..., out)
    j = torch.arange(input_size, dtype=torch.float32, device=device)
    dist = torch.abs(sample[..., None, :] - j[:, None])
    if torch.is_tensor(kernel_scale):
        x = dist / kernel_scale[..., None]
    else:
        x = dist * reciprocal_f32(kernel_scale)
    weights = kernel(x)  # (..., in, out)
    total = torch.sum(weights, dim=-2, keepdim=True)
    safe = torch.where(total != 0, total, torch.ones_like(total))
    weights = torch.where(torch.abs(total) > 1000.0 * float(torch.finfo(torch.float32).eps),
                          weights / safe, torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= input_size - 0.5)
    return torch.where(inside[..., None, :], weights, torch.zeros_like(weights))


def nearest_offsets(input_size: int, output_size: int, device=None) -> torch.Tensor:
    """``_resize_nearest``'s source indices (``scale.py:256-271``):
    floor(float32((i + 0.5) * m / n)), as int64."""
    i = torch.arange(output_size, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * input_size * reciprocal_f32(output_size)).to(torch.int64)


def _along(x: torch.Tensor, dim: int, w: torch.Tensor) -> torch.Tensor:
    """``x`` with axis ``dim`` contracted against the (in, out) matrix
    ``w``: one matmul, the new axis put back in place."""
    moved = torch.movedim(x, dim, -1)
    return torch.movedim(torch.matmul(moved, w), -1, dim)


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``jax.image.resize(x, shape, method)`` (antialiased, its default). Each axis whose size
    changes is resampled (any axis: NHWC and NCHW alike); an axis whose
    size does not change is skipped, as ``_resize`` skips it
    (``scale.py:287-293``), so it passes through bit for bit. ``linear``
    / ``bilinear`` and ``lanczos3`` apply the weight matrices of the
    scale out / in, one axis after the other; an integer input is taken
    as float32 and a float input keeps its dtype, as JAX promotes it.
    ``nearest`` gathers, in ``x``'s dtype."""
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"shape {shape} must have one entry per axis of {tuple(x.shape)}")
    dims = [d for d in range(x.dim()) if x.shape[d] != shape[d]]
    if method == "nearest":
        for d in dims:
            x = torch.index_select(x, d, nearest_offsets(x.shape[d], shape[d], x.device))
        return x
    kernel = _kernel(method)
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for d in dims:
        m, n = x.shape[d], shape[d]
        w = compute_weight_mat(m, n, n / m, 0.0, kernel, True, x.device)
        x = _along(x, d, w.to(x.dtype))
    return x


def scale_and_translate(
    x: torch.Tensor,
    out_hw: Tuple[int, int],
    scale: torch.Tensor,
    translation: torch.Tensor,
    method: str,
) -> torch.Tensor:
    """``jax.vmap`` of ``jax.image.scale_and_translate`` (antialiased, its
    default) over a batch of
    NHWC images (``tpgan_tpu/frontalize.py:131-140``): image b's output
    pixel (y, x) reads its input at the inverse of ``in * scale[b] +
    translation[b]``. ``scale`` (B,) is one scale for both axes;
    ``translation`` (B, 2) is in JAX's axis order, (y, x). The channel
    axis keeps scale 1 and translation 0, an identity JAX contracts and
    this skips: a product with an identity matrix changes no bit. Output
    samples that fall outside the input are 0. One pair of float32 weight
    matrices per image, applied with ``torch.bmm``."""
    if method == "nearest":
        raise ValueError("nearest resampling is not supported by scale_and_translate, "
                         "as in jax.image")
    kernel = _kernel(method)
    b, h, w, c = x.shape
    oh, ow = (int(v) for v in out_hw)
    scale = scale.to(torch.float32)
    translation = translation.to(torch.float32)
    wy = compute_weight_mat(h, oh, scale, translation[:, 0], kernel, True)  # (B, h, oh)
    wx = compute_weight_mat(w, ow, scale, translation[:, 1], kernel, True)  # (B, w, ow)
    x = x.to(torch.float32)
    # rows: (B, oh, h) @ (B, h, w*c) -> (B, oh, w*c)
    rows = torch.bmm(wy.transpose(1, 2), x.reshape(b, h, w * c)).reshape(b, oh, w, c)
    # columns: per image, (oh*c, w) @ (w, ow)
    cols = rows.permute(0, 1, 3, 2).reshape(b, oh * c, w)
    out = torch.bmm(cols, wx).reshape(b, oh, c, ow)
    return out.permute(0, 1, 3, 2).contiguous()
