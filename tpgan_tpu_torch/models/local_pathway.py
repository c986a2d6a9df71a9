"""LocalPathway — per-patch U-Net that reconstructs a face part and
emits a feature map for the global decoder (reference:
D_and_G_model.py:18-110). The port of ``tpgan_tpu/models/local_pathway.py``.

Architecture (channels at FM_multiplier=1.0):

    encoder: conv0 3->64 (s1) | conv1 64->128 (s2) | conv2 128->256 (s2)
             | conv3 256->512 (s2), each = ConvBlock + ResidualBlock
    decoder: deconv0 512->256, skip-concat conv2, after_select0 -> 256
             deconv1 256->128, skip-concat conv1, after_select1 -> 128
             deconv2 128->feature_dim, skip-concat conv0, after_select2
    head:    1x1 conv -> 3-channel patch image (no init/act,
             D_and_G_model.py:81)

Returns ``(local_img, deconv2)`` — the feature output is the raw deconv2
activation, *before* the select stage (D_and_G_model.py:110).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from tpgan_tpu_torch.ops.activations import LEAKY_RELU, RELU, leaky_relu
from tpgan_tpu_torch.ops.blocks import ConvBlock, DeconvBlock, ResidualBlock
from tpgan_tpu_torch.utils.misc import scale_channels


class LocalPathway(nn.Module):
    def __init__(
        self,
        use_batchnorm: bool = True,
        feature_layer_dim: int = 64,
        fm_multiplier: float = 1.0,
        upsample_mode: str = "deconv",
        device=None,
    ):
        super().__init__()
        enc = scale_channels([64, 128, 256, 512], fm_multiplier)
        dec = scale_channels([256, 128], fm_multiplier)
        kw = dict(use_batchnorm=use_batchnorm, device=device)
        lrelu2 = leaky_relu(1e-2)
        for i, (cin, cout, stride) in enumerate(
            [(3, enc[0], 1), (enc[0], enc[1], 2), (enc[1], enc[2], 2), (enc[2], enc[3], 2)]
        ):
            setattr(self, f"conv{i}_conv",
                    ConvBlock(cin, cout, 3, stride, 1, "kaiming", lrelu2, **kw))
            setattr(self, f"conv{i}_res",
                    ResidualBlock(cout, activation=LEAKY_RELU, device=device))
        for j, (cin, cout, skip_ch) in enumerate(
            [(enc[3], dec[0], enc[2]), (dec[0], dec[1], enc[1]),
             (dec[1], feature_layer_dim, enc[0])]
        ):
            setattr(self, f"dec{j}_deconv", DeconvBlock(
                cin, cout, 3, 2, 1, 1, "kaiming", RELU, mode=upsample_mode, **kw
            ))
            setattr(self, f"dec{j}_select_conv", ConvBlock(
                cout + skip_ch, cout, 3, 1, 1, "kaiming", LEAKY_RELU, **kw
            ))
            setattr(self, f"dec{j}_select_res",
                    ResidualBlock(cout, activation=LEAKY_RELU, device=device))
        self.local_img = ConvBlock(
            feature_layer_dim, 3, 1, 1, 0, None, None, use_batchnorm=False, device=device
        )

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        skips = []
        h = x
        for i in range(4):
            h = getattr(self, f"conv{i}_res")(getattr(self, f"conv{i}_conv")(h))
            skips.append(h)
        for j, skip in enumerate(skips[2::-1]):
            deconv = getattr(self, f"dec{j}_deconv")(h)
            h = torch.cat([deconv, skip], dim=1)
            h = getattr(self, f"dec{j}_select_res")(getattr(self, f"dec{j}_select_conv")(h))
        local_img = self.local_img(h)
        if local_img.shape != x.shape:
            raise ValueError(f"patch {tuple(x.shape)} came back as {tuple(local_img.shape)}")
        return local_img, deconv
