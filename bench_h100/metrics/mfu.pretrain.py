"""mfu.pretrain: the detector step's model FLOPs per image (counted from layer
shapes, ``counts/flops.py``) times the window's pretraining images/s, over
the configuration's peak; moves ``pretrain_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.mfu_pct(run, "pretrain_images_per_s")
