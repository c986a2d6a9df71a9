"""Metrics, throughput and NaN checks of the training loop — the port of
``tpgan_tpu/train/metrics.py``.

Nothing in the step prints or reads a value back: the step returns 0-d
device tensors, and the writer brings them to the host at a log step —
to a ``metrics.jsonl`` always, and to TensorBoard when
``torch.utils.tensorboard`` imports. Throughput (images/s) is taken from
a host clock bracketed by device synchronisations.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Mapping, Optional

import torch


def _host_float(v: Any) -> float:
    return float(v.item() if isinstance(v, torch.Tensor) else v)


def _synchronize(x: Any) -> None:
    """Wait for the device of every CUDA tensor in ``x`` (a tensor, or a
    mapping or sequence of them): the counterpart of
    ``jax.block_until_ready``."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, Mapping):
        for v in x.values():
            _synchronize(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _synchronize(v)


class MetricWriter:
    """Appends ``{"step": n, <metric>: <float>, ...}`` lines to
    ``<log_dir>/metrics.jsonl``, and scalars to TensorBoard when
    ``use_tensorboard`` and ``torch.utils.tensorboard`` imports."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:  # no tensorboard package: the jsonl alone
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir=log_dir)

    def write(self, step: int, metrics: Mapping[str, Any]) -> None:
        host = {k: _host_float(v) for k, v in metrics.items()}
        self._jsonl.write(json.dumps({"step": int(step), **host}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in host.items():
                self._tb.add_scalar(k, v, int(step))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


class Throughput:
    """Images per second over a window whose ends wait for the device
    (``sync``: a tensor, or a mapping of them, the window's last output)."""

    def __init__(self):
        self._t0: Optional[float] = None
        self._images = 0

    def start(self, sync: Any = None) -> None:
        _synchronize(sync)
        self._t0 = time.perf_counter()
        self._images = 0

    def count(self, n: int) -> None:
        self._images += n

    def rate(self, sync: Any = None) -> float:
        _synchronize(sync)
        dt = time.perf_counter() - self._t0
        return self._images / dt if dt > 0 else float("inf")


class NaNMonitor:
    """Checks a metrics dict for NaN or Inf on the host and raises
    ``FloatingPointError`` naming the keys. It reads only values the step
    already returned, so it costs the step nothing."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled

    def check(self, step: int, metrics: Mapping[str, Any]) -> None:
        if not self.enabled:
            return
        bad = [k for k, v in metrics.items() if not math.isfinite(_host_float(v))]
        if bad:
            raise FloatingPointError(f"non-finite metrics at step {step}: {bad}")
