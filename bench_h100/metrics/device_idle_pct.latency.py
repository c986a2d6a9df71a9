"""device_idle_pct.latency: the share of the traced segment in which no
operation ran on the device; moves ``serve_p95_ms``."""

from bench_h100 import harness


def read(run):
    return harness.idle_pct(run)
