"""Pixel-space reconstruction losses — the port of
``tpgan_tpu/losses/pixel.py`` (reference: config.py:73-78,81), on NCHW
tensors.

As in the JAX module, the 64 and 32 scales are area downsamples of the
128x128 output (the reference's 32/64 decoder heads are dead code).

Gradient at ties: JAX differentiates ``abs`` as ``select(x >= 0, g, -g)``,
so |d| at d == 0 passes +g, where torch's ``abs`` backward passes 0.
:func:`jax_abs` is written as ``where(d >= 0, d, -d)``, whose autograd
gives JAX's +1 (and stays twice differentiable). ``symmetry_loss`` and
``total_variation`` are the two halves of ``ops.kernels.symmetry_tv_losses``
(the fused K2 reduction, with its plain version on a CPU tensor and the
same gradient at ties), which the composite loss calls once for both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpgan_tpu_torch.ops.kernels import symmetry_tv_losses


def jax_abs(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's derivative: +1 at d >= 0 (so at 0), -1 below."""
    return torch.where(d >= 0, d, -d)


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """mean |a - b| in f32."""
    return jax_abs(a.float() - b.float()).mean()


def _downsample_area(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Area (average-pool) downsample by an integer factor, NCHW."""
    return F.avg_pool2d(x, factor)


def multiscale_pixel_loss(
    fake128: torch.Tensor,
    gt128: torch.Tensor,
    gt64: torch.Tensor,
    gt32: torch.Tensor,
    weight_128: float = 1.0,
    weight_64: float = 1.0,
    weight_32: float = 1.5,
) -> torch.Tensor:
    """Scale-weighted L1 against the three ground-truth resolutions
    (weights: config.py:73-75)."""
    return (
        weight_128 * l1(fake128, gt128)
        + weight_64 * l1(_downsample_area(fake128, 2), gt64)
        + weight_32 * l1(_downsample_area(fake128, 4), gt32)
    )


def local_pixel_loss(fused_fake: torch.Tensor, fused_frontal_gt: torch.Tensor) -> torch.Tensor:
    """L1 between the fused fake-patch mosaic and the fused frontal
    ground-truth-patch mosaic (weight: config.py:77)."""
    return l1(fused_fake, fused_frontal_gt)


def symmetry_loss(fake: torch.Tensor) -> torch.Tensor:
    """L1 between the output and its horizontal mirror (NCHW: flip W)."""
    return symmetry_tv_losses(fake)[0]


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Mean absolute forward differences along H and W."""
    return symmetry_tv_losses(x)[1]
