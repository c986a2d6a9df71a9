"""kernel_roofline_pct.serve: K1's three calls per traced forward, their
summed bytes bounds over their summed device time; moves
``serve_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.kernel_roofline_pct(run)
