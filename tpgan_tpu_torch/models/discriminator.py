"""Discriminator — the PatchGAN critic: five stride-2 convs
(3->64->128->256->512->512) with residual blocks after the fourth and
fifth, and a 3x3 head to one channel, giving a (B, 1, 4, 4) map of local
realism scores on 128x128 inputs (reference: D_and_G_model.py:409-435).
The port of ``tpgan_tpu/models/discriminator.py``, on NCHW tensors.

Kept from the JAX module: the RGB input stays at 3 channels at every
``fm_multiplier`` (the reference scales it too, which breaks for any
multiplier but 1), and the residual blocks carry no BatchNorm even when
the convs do. Parameter names are the JAX ones (``conv0``..``conv4``,
``res3``, ``res4``, ``head``), so :mod:`tpgan_tpu_torch.convert` maps the
JAX tree by name.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from tpgan_tpu_torch.ops.activations import LEAKY_RELU, leaky_relu
from tpgan_tpu_torch.ops.blocks import ConvBlock, ResidualBlock
from tpgan_tpu_torch.utils.misc import scale_channels


class Discriminator(nn.Module):
    def __init__(self, use_batchnorm: bool = False, fm_multiplier: float = 1.0, device=None):
        super().__init__()
        n_fmap = [3] + scale_channels([64, 128, 256, 512, 512], fm_multiplier)
        self.depth = len(n_fmap) - 1
        for i in range(self.depth):
            setattr(self, f"conv{i}", ConvBlock(
                n_fmap[i], n_fmap[i + 1], 3, 2, 1, "kaiming", leaky_relu(1e-2),
                use_batchnorm=use_batchnorm, device=device,
            ))
            if i >= 3:  # residual blocks from layer 4 (D_and_G_model.py:428-429)
                setattr(self, f"res{i}", ResidualBlock(
                    n_fmap[i + 1], activation=LEAKY_RELU, device=device
                ))
        self.head = ConvBlock(
            n_fmap[-1], 1, 3, 1, 1, None, None, use_batchnorm=False, device=device
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.depth):
            h = getattr(self, f"conv{i}")(h)
            if i >= 3:
                h = getattr(self, f"res{i}")(h)
        return self.head(h)
