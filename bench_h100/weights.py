"""Seeded weights for a model the reference describes, made on the device
in a few large calls: one normal draw for every drawn leaf from a
``torch.Generator`` on ``device``, scaled per leaf, and a fill for each
constant leaf (BatchNorm's scale, shift and running statistics)."""

from __future__ import annotations

from typing import Dict

import torch

from bench_h100.reference.net import Leaf


def make(spec: Dict[str, Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``spec`` (``reference.*.spec(...).spec``): the
    same seed gives the same weights on the same device type."""
    drawn = [(k, leaf) for k, leaf in spec.items() if leaf.std is not None]
    total = sum(torch.Size(leaf.shape).numel() for _, leaf in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.randn(total, generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    offset = 0
    for k, leaf in drawn:
        n = torch.Size(leaf.shape).numel()
        out[k] = flat[offset:offset + n].view(leaf.shape).mul_(leaf.std)
        offset += n
    for k, leaf in spec.items():
        if leaf.std is None:
            out[k] = torch.full(leaf.shape, leaf.const, dtype=leaf.dtype, device=device)
    return {k: out[k] for k in spec}


def load(module: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``module``'s parameters and buffers; every
    name and shape must match (``strict``)."""
    module.load_state_dict(weights, strict=True)
