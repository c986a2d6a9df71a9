"""Explicit model registry — the port of ``tpgan_tpu/models/registry.py``,
which replaces the reference's string-``eval`` model lookup (reference:
Pretrain.py:113, ``eval(pretrain['model_name'])``) with a dict of
constructors. Keys are matched case-blind; ``mobilenetv2`` is the
reference's own spelling of the detector (config.py:7)."""

from __future__ import annotations

from typing import Callable, Dict

import torch.nn as nn

from tpgan_tpu_torch.models.discriminator import Discriminator
from tpgan_tpu_torch.models.feature_extract import FeatureExtractModel, MobileNetV2Classifier
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2
from tpgan_tpu_torch.models.resnet import ResNet18

_REGISTRY: Dict[str, Callable[..., nn.Module]] = {
    "mobilenet_v2": MobileNetV2,
    "mobilenetv2": MobileNetV2,  # reference spelling (config.py:7)
    "mobilenet_v2_classifier": MobileNetV2Classifier,
    "resnet18": ResNet18,
    "feature_extract": FeatureExtractModel,
    "generator": Generator,
    "discriminator": Discriminator,
}


def get_model(name: str, **kwargs) -> nn.Module:
    """The model registered as ``name``, built with ``kwargs``; raises
    ``KeyError`` naming the registered models for an unknown name."""
    key = name.lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {sorted(set(_REGISTRY))}")
    return _REGISTRY[key](**kwargs)


def register_model(name: str, ctor: Callable[..., nn.Module]) -> None:
    _REGISTRY[name.lower()] = ctor
