"""ResNet18 identity embedder — the port of ``tpgan_tpu/models/resnet.py``,
the JAX package's reconstruction of the reference's ResNet.py:5-125
(which cannot construct as written; SURVEY.md §2 #29). Its decisions are
kept:

* 4 sections of 2 residual blocks at widths 64/128/256/512 (:28-29);
* every residual block runs stride 1, with a 1x1 projection shortcut
  where the width changes (:40);
* stem: 7x7 stride-2 conv + BatchNorm + activation, then a 3x3 stride-2
  max-pool (:31-33), so a 128x128 input gives 32x32 section maps and a
  512-d pooled feature;
* an optional pre-FC bottleneck ``fc0`` (Linear + BatchNorm), whose
  output is the identity feature; the forward returns
  ``(logits, fc0_features or None)`` (:119).

NCHW: the global mean is over H and W (dims 2, 3), JAX's
``jnp.mean(h, axis=(1, 2))`` on NHWC.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgan_tpu_torch.ops.activations import RELU, Activation
from tpgan_tpu_torch.ops.blocks import ConvBlock, LinearBlock, ResidualBlock, dropout

NUM_FEATURES = (64, 128, 256, 512)
NUM_SECTIONS = (2, 2, 2, 2)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, 2, 1)`` on NCHW (padding counts as -inf)."""
    return F.max_pool2d(x, 3, 2, 1)


class ResNet18(nn.Module):
    def __init__(
        self,
        num_of_output_classes: int = 1000,
        use_batchnorm: bool = True,
        feature_layer_dim_before_fc: Optional[int] = None,
        activation: Activation = RELU,
        dropout_rate: float = 0.0,
        device=None,
    ):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv1 = ConvBlock(3, NUM_FEATURES[0], 7, 2, 3, "kaiming", activation,
                               use_batchnorm=use_batchnorm, device=device)
        self.blocks = []
        cin = NUM_FEATURES[0]
        for sec, (width, n_blocks) in enumerate(zip(NUM_FEATURES, NUM_SECTIONS)):
            for blk in range(n_blocks):
                name = f"section{sec}_block{blk}"
                setattr(self, name, ResidualBlock(
                    cin, width, 3, 1, activation=activation, use_projection=cin != width,
                    use_batchnorm=use_batchnorm, device=device))
                self.blocks.append(name)
                cin = width
        fdim = feature_layer_dim_before_fc
        self.fc0 = (LinearBlock(NUM_FEATURES[-1], fdim, use_batchnorm=use_batchnorm, device=device)
                    if fdim is not None else None)
        self.fc = LinearBlock(NUM_FEATURES[-1] if fdim is None else fdim, num_of_output_classes,
                              device=device)

    def forward(
        self,
        x: torch.Tensor,
        use_dropout: bool = False,
        drop_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``(logits, fc0 features or None)`` of an NCHW batch. BatchNorm
        follows the module's mode (train: batch statistics, advanced);
        dropout before ``fc`` (rate ``dropout_rate``, 0 by default) takes
        ``drop_mask`` or draws from ``generator``."""
        h = max_pool_3x3_s2(self.conv1(x))
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = h.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)
        fc0_out = None
        if self.fc0 is not None:
            h = fc0_out = self.fc0(h)
        h = dropout(h, self.dropout_rate, use_dropout, generator, drop_mask)
        return self.fc(h), fc0_out
