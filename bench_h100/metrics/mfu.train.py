"""mfu.train: the train step's model FLOPs per image (counted from layer
shapes, ``counts/flops.py``) times the window's training images/s, over
the configuration's peak; moves ``train_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.mfu_pct(run, "train_images_per_s")
