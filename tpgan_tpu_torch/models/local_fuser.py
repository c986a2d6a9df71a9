"""LocalFuser — place the four part maps (left eye, right eye, nose,
mouth) at their canonical mean-landmark positions on a 128x128 canvas and
fuse with an elementwise max (reference: D_and_G_model.py:112-159). The
port of ``tpgan_tpu/models/local_fuser.py``, on NCHW maps.

:func:`fuse_parts` is the plain version with the shape checks; the
Generator calls the kernel wrapper ``ops.kernels.fuse_parts`` instead,
which computes the same on a CUDA tensor with the hand-written kernel.
The slots are in :mod:`tpgan_tpu_torch.ops.geometry`.
"""

from __future__ import annotations

from typing import Dict

import torch

from tpgan_tpu_torch.ops.geometry import PART_GEOMETRY
from tpgan_tpu_torch.ops.kernels import check_parts, fuse_parts_plain


def fuse_parts(
    left_eye: torch.Tensor,
    right_eye: torch.Tensor,
    nose: torch.Tensor,
    mouth: torch.Tensor,
) -> torch.Tensor:
    """Max-fuse four NCHW part maps onto the 128x128 canvas, for any
    channel count (features, fake patches or ground-truth patches — the
    reference fuses all three at D_and_G_model.py:396-398)."""
    parts = (left_eye, right_eye, nose, mouth)
    check_parts(parts)
    return fuse_parts_plain(*parts)


def extract_parts(canvas: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`fuse_parts` placement: slice each part's canvas
    slot back out of an NCHW canvas."""
    return {
        name: canvas[:, :, top : top + h, left : left + w]
        for name, ((h, w), (top, left)) in PART_GEOMETRY.items()
    }
