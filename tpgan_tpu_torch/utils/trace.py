"""The port's spans.

``span(name)`` marks a stretch of host work at a layer boundary of the
program (``data.sample``, ``graph.dispatch``, ``pretrain.backward``, ...).
While a ``torch.profiler`` profile records, it is a
``torch.profiler.record_function``: the span lands in the profiler's
trace as a ``user_annotation``, on the clock of the device's kernels and
nested under its caller's spans, so a stretch with the device idle can
be put down to what the host was doing. Otherwise it is one shared no-op
and costs one flag check. There is no other switch: any profiler
turns the spans on (the benchmark's traced segment,
``run_gan_training(profile_dir=...)``), and the trace holds them; this
module keeps no copy.
"""

from __future__ import annotations

import contextlib
from typing import ContextManager

import torch

_profiling = torch._C._autograd._profiler_enabled

# The span while no profiler records: enters and leaves, nothing else.
NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager[None]:
    """A ``record_function(name)`` while a profiler records, else
    :data:`NO_SPAN`."""
    if not _profiling():
        return NO_SPAN
    return torch.profiler.record_function(name)
