"""device_idle_pct.serve: the share of the traced segment in which no
operation ran on the device; moves ``serve_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.idle_pct(run)
