"""kernel_roofline_pct.train: the port's four kernels (K1, K1 backward, K2,
K2 backward) in the traced train steps, their summed bytes bounds
(``counts/kernels.py``) over their summed device time; moves
``train_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.kernel_roofline_pct(run)
