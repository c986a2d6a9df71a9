"""Landmark-centred patch cropping — the port of
``tpgan_tpu/data/patches.py``, the reference's ``process`` geometry
(DataAndDataset.py:10-56):

* mouth centre = mean of the two mouth-corner landmarks (:42-43),
* per part, with (x, y) = floor(landmark):
  crop box = [x - w//2 + 1, x + w//2 + 1) x [y - h//2 + 1, y + h//2 + 1)
  (:46-54), zero-padded where it leaves the image.

Patch sizes (W x H): eyes 40x40, nose 40x32, mouth 48x32 (:35-40).

:func:`crop_patches` is the host-side numpy crop of dataset preparation;
:func:`crop_patches_batch` crops NHWC tensors on their own device with
index grids over a zero pad, as the JAX one slices a padded image with
``lax.dynamic_slice``. The fuse slots of the generator are a separate
geometry (``ops/geometry.py``).
"""

from __future__ import annotations

from math import floor
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# (width, height) per part, reference order
PATCH_SIZES: Dict[str, Tuple[int, int]] = {
    "left_eye": (40, 40),
    "right_eye": (40, 40),
    "nose": (40, 32),
    "mouth": (48, 32),
}

_MAX_PAD = 64  # >= max patch dimension; padding margin for OOB crops


def mouth_center(landmarks5: np.ndarray) -> np.ndarray:
    """5-point landmarks -> 4 centres (left eye, right eye, nose, mouth):
    the mouth is the midpoint of the two corner landmarks."""
    lm = np.asarray(landmarks5, np.float32)
    out = lm[:4].copy()
    out[3] = (lm[3] + lm[4]) / 2.0
    return out


def crop_patches(image: np.ndarray, landmarks5: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side crop. ``image`` is HWC; ``landmarks5`` is (5, 2) (x, y).
    Returns part name -> (h, w, C) array, zero-padded at borders."""
    centers = mouth_center(landmarks5)
    h_img, w_img = image.shape[:2]
    out = {}
    for i, (name, (w, h)) in enumerate(PATCH_SIZES.items()):
        x = floor(centers[i, 0])
        y = floor(centers[i, 1])
        left = x - w // 2 + 1
        top = y - h // 2 + 1
        patch = np.zeros((h, w) + image.shape[2:], image.dtype)
        src_l, src_t = max(left, 0), max(top, 0)
        src_r, src_b = min(left + w, w_img), min(top + h, h_img)
        if src_r > src_l and src_b > src_t:
            patch[src_t - top : src_b - top, src_l - left : src_r - left] = image[
                src_t:src_b, src_l:src_r
            ]
        out[name] = patch
    return out


def crop_patches_batch(
    images: torch.Tensor, landmarks5: torch.Tensor
) -> Dict[str, torch.Tensor]:
    """Batched crop on the tensors' device: images (B, H, W, C),
    landmarks (B, 5, 2) (x, y). Returns part name -> (B, h, w, C).

    The image is padded by 64 zeros on each side and each window's start
    is clamped into the padded image, as ``lax.dynamic_slice`` clamps it:
    a landmark far outside the image reads an all-zero patch."""
    b, h_img, w_img, _ = images.shape
    lm = landmarks5.to(torch.float32)
    centers = torch.cat([lm[:, :3], ((lm[:, 3] + lm[:, 4]) / 2.0)[:, None]], dim=1)
    xy = torch.floor(centers).to(torch.long)  # floor, not int(): -10.5 -> -11
    padded = F.pad(images, (0, 0, _MAX_PAD, _MAX_PAD, _MAX_PAD, _MAX_PAD))
    bi = torch.arange(b, device=images.device)[:, None, None]
    out = {}
    for i, (name, (w, h)) in enumerate(PATCH_SIZES.items()):
        left = (xy[:, i, 0] - w // 2 + 1 + _MAX_PAD).clamp(0, w_img + 2 * _MAX_PAD - w)
        top = (xy[:, i, 1] - h // 2 + 1 + _MAX_PAD).clamp(0, h_img + 2 * _MAX_PAD - h)
        rows = top[:, None] + torch.arange(h, device=images.device)
        cols = left[:, None] + torch.arange(w, device=images.device)
        out[name] = padded[bi, rows[:, :, None], cols[:, None, :]]
    return out
