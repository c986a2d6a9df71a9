"""Small utilities (reference: UtilityMethods.py) — the port's copy of
``tpgan_tpu/utils/misc.py::scale_channels``."""

from __future__ import annotations

from typing import List, Sequence


def scale_channels(channels: Sequence[int], multiplier: float) -> List[int]:
    """Channel-width scaling: int(v * multiplier) per entry — the
    reference's ``elementwise_multiply_and_cast_to_int``
    (UtilityMethods.py:109-121)."""
    return [int(v * multiplier) for v in channels]
