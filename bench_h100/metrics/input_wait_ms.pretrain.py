"""input_wait_ms.pretrain: device milliseconds per train step in which no
operation ran while the host was fetching the step's batch from the port's
device sampler (the idle time of the traced segment under the benchmark's
``fetch`` spans, over the traced steps); moves ``pretrain_images_per_s``."""

from bench_h100 import harness


def read(run):
    return harness.idle_ms_per_unit(run, "fetch")
