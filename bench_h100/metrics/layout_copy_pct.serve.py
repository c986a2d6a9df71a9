"""layout_copy_pct.serve: the share of the traced device busy time in cuDNN's
NCHW<->NHWC layout kernels (``nchwToNhwc``, ``nhwcToNchw``); moves
``serve_images_per_s``."""

from bench_h100 import harness

PATTERN = r"nchwToNhwc|nhwcToNchw"


def read(run):
    return harness.busy_share_pct(run, PATTERN)
