"""mfu.serve: the generator forward's model FLOPs per image times the
window's synthesis images/s, over the configuration's peak; moves
``serve_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.mfu_pct(run, "serve_images_per_s")
