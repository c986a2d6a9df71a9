"""Canonical face-part canvas geometry — the port's own copy of
``tpgan_tpu/ops/geometry.py`` (that module cannot be imported without jax,
because ``tpgan_tpu/ops/__init__.py`` pulls in the Flax blocks). The
LocalFuser placement (reference: D_and_G_model.py:148-157) and the patch
sizes (reference: DataAndDataset.py:35-40):

    part       size (W,H)   canvas slot (row=top, col=left)
    left_eye   (40, 40)     rows 19:59,  cols 18:58
    right_eye  (40, 40)     rows 18:58,  cols 65:105
    nose       (40, 32)     rows 47:79,  cols 43:83
    mouth      (48, 32)     rows 72:104, cols 40:88

The CUDA fuse kernel receives these slots as launch arguments from
:mod:`tpgan_tpu_torch.ops.kernels`, so this table stays the single source.
"""

from __future__ import annotations

from typing import Dict, Tuple

CANVAS_SIZE = 128

# name -> ((height, width), (top, left)); order matters (reference order).
PART_GEOMETRY: Dict[str, Tuple[Tuple[int, int], Tuple[int, int]]] = {
    "left_eye": ((40, 40), (19, 18)),
    "right_eye": ((40, 40), (18, 65)),
    "nose": ((32, 40), (47, 43)),
    "mouth": ((32, 48), (72, 40)),
}

PART_NAMES = tuple(PART_GEOMETRY.keys())
