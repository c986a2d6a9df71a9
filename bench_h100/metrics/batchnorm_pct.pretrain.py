"""batchnorm_pct.pretrain: the share of the traced device busy time in
BatchNorm kernels (cuDNN's ``bn_fw`` / ``bn_bw``, torch's ``batch_norm``);
moves ``pretrain_images_per_s``."""

from bench_h100 import harness

PATTERN = r"(?i)bn_fw|bn_bw|batch_?norm"


def read(run):
    return harness.busy_share_pct(run, PATTERN)
