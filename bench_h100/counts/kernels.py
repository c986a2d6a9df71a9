"""Roofline bounds of the port's four kernels on the GAN path: the least
time each call could take, its bytes over the HBM rate, each input byte
read once and each output byte written once (every one of them is bound
by bytes, not operations).

* K1, the fuse of four part maps onto the 128x128 canvas: the parts read
  and the canvas written.
* K1 backward: the parts read, their gradients written and the canvas
  gradient read over the pixels the slots cover (the canvas itself is
  recomputed from the parts, not read).
* K2, the symmetry and total-variation sums: the image read.
* K2 backward: the image read and its gradient written.

Shapes are (B, C) over the canvas geometry below; ``itemsize`` is the
element size of the call's dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

from bench_h100.counts.peaks import HBM_BYTES_PER_S

CANVAS = 128
# name -> ((height, width), (top, left)), as the reference places them
SLOTS: Dict[str, Tuple[Tuple[int, int], Tuple[int, int]]] = {
    "left_eye": ((40, 40), (19, 18)),
    "right_eye": ((40, 40), (18, 65)),
    "nose": ((32, 40), (47, 43)),
    "mouth": ((32, 48), (72, 40)),
}
# the kernels' names as the profiler shows them
NAMES = {"k1": r"fuse_parts_kernel", "k1_bwd": r"fuse_parts_bwd_kernel",
         "k2": r"sym_tv_kernel", "k2_bwd": r"sym_tv_bwd(_general)?_kernel"}
ALL = r"fuse_parts_kernel|fuse_parts_bwd_kernel|sym_tv_kernel|sym_tv_bwd(_general)?_kernel"


def part_pixels() -> int:
    return sum(h * w for (h, w), _ in SLOTS.values())


def covered_pixels() -> int:
    """Canvas pixels inside at least one slot."""
    cells = set()
    for (h, w), (top, left) in SLOTS.values():
        cells.update((top + i, left + j) for i in range(h) for j in range(w))
    return len(cells)


def k1_bytes(b: int, c: int, itemsize: int) -> int:
    return b * c * (part_pixels() + CANVAS * CANVAS) * itemsize


def k1_bwd_bytes(b: int, c: int, itemsize: int) -> int:
    return b * c * (2 * part_pixels() + covered_pixels()) * itemsize


def k2_bytes(b: int, c: int, itemsize: int) -> int:
    return b * c * CANVAS * CANVAS * itemsize


def k2_bwd_bytes(b: int, c: int, itemsize: int) -> int:
    return 2 * b * c * CANVAS * CANVAS * itemsize


def bound_s(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S


def gan_step(b: int, feature_dim: int = 64, compute_itemsize: int = 2,
             input_itemsize: int = 4) -> Dict[str, Tuple[int, float]]:
    """{kernel: (calls, summed bound in seconds)} of one WGAN-GP D+G step
    at batch ``b``: two generator forwards of three fuses each (the local
    features and fake patches in the compute dtype, the input patches in
    theirs) and the frontal patches' fuse; the fuse backward of the
    features and fake patches; the symmetry and TV sums and their
    backward on the output image."""
    fwd = (k1_bytes(b, feature_dim, compute_itemsize) + k1_bytes(b, 3, compute_itemsize)
           + k1_bytes(b, 3, input_itemsize))
    return {
        "k1": (7, bound_s(2 * fwd + k1_bytes(b, 3, input_itemsize))),
        "k1_bwd": (2, bound_s(k1_bwd_bytes(b, feature_dim, compute_itemsize)
                              + k1_bwd_bytes(b, 3, compute_itemsize))),
        "k2": (1, bound_s(k2_bytes(b, 3, compute_itemsize))),
        "k2_bwd": (1, bound_s(k2_bwd_bytes(b, 3, compute_itemsize))),
    }


def synthesis(b: int, feature_dim: int = 64, compute_itemsize: int = 2,
              input_itemsize: int = 4) -> Dict[str, Tuple[int, float]]:
    """{kernel: (calls, summed bound in seconds)} of one generator forward."""
    fwd = (k1_bytes(b, feature_dim, compute_itemsize) + k1_bytes(b, 3, compute_itemsize)
           + k1_bytes(b, 3, input_itemsize))
    return {"k1": (3, bound_s(fwd))}
