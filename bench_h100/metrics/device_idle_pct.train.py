"""device_idle_pct.train: the share of the traced segment in which no
operation ran on the device; moves ``train_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.idle_pct(run)
