"""Timing on the card and the H100's published peaks, shared by
``chip_smoke.py`` and the port's A/B scripts. Needs a CUDA device: a CPU
run has no device time to report."""

from __future__ import annotations

import math
import subprocess

import torch

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores
F32_FLOPS = 67e12  # CUDA cores, no TF32
L2_BYTES = 50e6


def card_info() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def gpu_time_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: one warm-up call, then a sleep kernel
    lets the host queue all ``iters`` launches, so the events bracket device
    work only."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotated(make, nbytes: int):
    """Copies of an input set of ``nbytes``, enough to rotate past the L2."""
    return [make() for _ in range(max(1, math.ceil(4 * L2_BYTES / nbytes)))]
