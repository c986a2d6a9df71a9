"""MobileNetV2's inverted residual block — the part of
``tpgan_tpu/models/mobilenet_v2.py`` (reference: MobileNetV2.py:81-142)
that the identity embedder's MobileNetV2 branch
(:class:`tpgan_tpu_torch.models.feature_extract.MobileNetV2Classifier`)
is built from.

The landmark detector's ``MobileNetV2`` backbone, its ``SSDHead`` and
``find_best_coordinates`` come with the detector slice (ROADMAP A10).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpgan_tpu_torch.ops import initializers as init_lib
from tpgan_tpu_torch.ops.activations import RELU6, apply_activation
from tpgan_tpu_torch.ops.blocks import BatchNorm2d, Conv2d

# t (expansion), c (out channels), n (repeats), s (first stride)
# (reference: MobileNetV2.py:133-142)
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)


class InvertedResidual(nn.Module):
    """expand (1x1, x``expand_ratio``) -> depthwise (3x3, ``groups`` =
    width) -> project (1x1), each followed by BatchNorm, the first two by
    RELU6; the input is added back iff stride is 1 and in == out. Convs
    are bias-free with MobileNetV2's He init (``init_lib.he_ssd_conv``)."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expand_ratio: int = 6,
                 device=None):
        super().__init__()
        mid = inp * expand_ratio
        he = init_lib.he_ssd_conv()
        self.expand = Conv2d(inp, mid, 1, 1, 0, use_bias=False, kernel_init=he, device=device)
        self.expand_bn = BatchNorm2d(mid, device=device)
        self.depthwise = Conv2d(mid, mid, 3, stride, 1, use_bias=False, kernel_init=he,
                                groups=mid, device=device)
        self.depthwise_bn = BatchNorm2d(mid, device=device)
        self.project = Conv2d(mid, oup, 1, 1, 0, use_bias=False, kernel_init=he, device=device)
        self.project_bn = BatchNorm2d(oup, device=device)
        self.residual = stride == 1 and inp == oup

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = apply_activation(self.expand_bn(self.expand(x)), RELU6)
        h = apply_activation(self.depthwise_bn(self.depthwise(h)), RELU6)
        h = self.project_bn(self.project(h))
        return x + h if self.residual else h
