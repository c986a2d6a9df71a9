"""Small utilities (reference: UtilityMethods.py) — the port's copy of
``tpgan_tpu/utils/misc.py``: channel scaling, the 68 → 5 landmark
reduction and the image resize, on torch tensors."""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from tpgan_tpu_torch.ops.resize import resize


def scale_channels(channels: Sequence[int], multiplier: float) -> List[int]:
    """Channel-width scaling: int(v * multiplier) per entry — the
    reference's ``elementwise_multiply_and_cast_to_int``
    (UtilityMethods.py:109-121)."""
    return [int(v * multiplier) for v in channels]


# Dlib 68-point index ranges for (left eye, right eye, nose, left mouth
# corner, right mouth corner) — reference: UtilityMethods.py:148. The
# reference's last range is (68, 68), which on a true 68-row array is an
# empty slice (NaN mean) — its landmark files evidently carry a 69th row.
FIVE_PTS_IDX = ((36, 41), (42, 47), (27, 35), (48, 48), (68, 68))


def five_landmarks_from_68(landmarks68: np.ndarray) -> np.ndarray:
    """Reduce dlib-style landmarks to 5 key points by averaging each index
    range (reference: UtilityMethods.py:147-164). Input (N, 2) with
    N >= 68; output float32 (5, 2).

    As in the JAX package: for a standard 68-row array the reference's
    (68, 68) right-mouth range is out of bounds (NaN), so it falls back to
    dlib's right mouth corner, index 54.
    """
    n = landmarks68.shape[0]
    out = []
    for lo, hi in FIVE_PTS_IDX:
        if lo >= n:  # reference's 69th-row quirk on a 68-row array
            lo = hi = 54
        out.append(np.mean(landmarks68[lo : hi + 1], axis=0))
    return np.asarray(out, np.float32)


def resize_image(x: torch.Tensor, size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """Bilinear resize of an NHWC or HWC float tensor — the port of the
    JAX ``resize_image`` (``jax.image.resize(method="bilinear")``, which
    antialiases when it shrinks), through the port's copy of that
    resampler, ``ops.resize``. ``size`` is (height, width) or one int for
    a square."""
    h, w = (size, size) if isinstance(size, int) else size
    if x.dim() not in (3, 4):
        raise ValueError(f"expected HWC or NHWC, got shape {tuple(x.shape)}")
    return resize(x, (*x.shape[:-3], h, w, x.shape[-1]), "bilinear")


def small_mean(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The mean over a short axis ``dim`` as XLA's CPU program takes
    ``jnp.mean`` there: the entries summed in order, then multiplied by
    float32(1 / n) (XLA turns the division by a constant into that
    product). ``torch.mean`` sums in another order and divides, one
    rounding off it in some entries."""
    parts = torch.unbind(x, dim)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total * (1.0 / len(parts))
