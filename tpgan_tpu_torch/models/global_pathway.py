"""GlobalPathway — 128x128 encoder-decoder with skip connections, a
256-d identity bottleneck, and local-feature injection at full resolution
(reference: D_and_G_model.py:161-329). The port of
``tpgan_tpu/models/global_pathway.py``, on NCHW tensors.

It keeps the JAX module's two documented deviations from the reference:
``add_128`` is sized for the 75 channels it is fed
(``cat[deconv_128, conv0, i128]``, the reference sizes it for 72), and the
encoder residual widths scale with ``fm_multiplier``.
``use_residual_block`` is accepted and, as in the reference, changes
nothing. The JAX module's ``scaling_factor`` (default 1.0, which the
Generator never changes) is left out.

fc1 flattens conv4 in CHW order (torch's habit, and the reference's); the
JAX module flattens HWC, so :mod:`tpgan_tpu_torch.convert` permutes the
fc1 weight's columns.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn

from tpgan_tpu_torch.ops import initializers as init_lib
from tpgan_tpu_torch.ops.activations import LEAKY_RELU, RELU, leaky_relu
from tpgan_tpu_torch.ops.blocks import ConvBlock, DeconvBlock, LinearBlock, ResidualBlock
from tpgan_tpu_torch.utils.misc import scale_channels

# (name, kernel, stride, padding, residual blocks) of the encoder stages
_ENCODER = (
    ("conv0", 7, 1, 3, 1),  # 128x128
    ("conv1", 5, 2, 2, 1),  # 64x64
    ("conv2", 3, 2, 1, 1),  # 32x32
    ("conv3", 3, 2, 1, 1),  # 16x16
    ("conv4", 3, 2, 1, 4),  # 8x8
)


class GlobalPathway(nn.Module):
    def __init__(
        self,
        zdim: int,
        local_feature_layer_dim: int = 64,
        use_batchnorm: bool = True,
        use_residual_block: bool = True,  # parity no-op, see module docstring
        fm_multiplier: float = 1.0,
        upsample_mode: str = "deconv",
        device=None,
    ):
        super().__init__()
        enc = scale_channels([64, 64, 128, 256, 512], fm_multiplier)
        dec = scale_channels([64, 32, 16, 8], fm_multiplier)
        enh = scale_channels([512, 256, 128, 64], fm_multiplier)
        head = scale_channels([64, 32], fm_multiplier)
        kw = dict(use_batchnorm=use_batchnorm, device=device)
        dkw = dict(kw, mode=upsample_mode)
        lrelu2 = leaky_relu(1e-2)

        def rb(ch, name, **extra):
            setattr(self, name, ResidualBlock(ch, activation=LEAKY_RELU, device=device, **extra))

        # ---- encoder (D_and_G_model.py:192-209) ----
        cin = 3
        for (name, k, stride, pad, n_res), cout in zip(_ENCODER, enc):
            setattr(self, f"{name}_conv",
                    ConvBlock(cin, cout, k, stride, pad, "kaiming", lrelu2, **kw))
            for i in range(n_res):
                setattr(self, f"{name}_res{i}", ResidualBlock(
                    cout, cout, k, 1, pad, "kaiming", lrelu2, device=device
                ))
            cin = cout

        # ---- bottleneck: fc1 (512) -> pairwise max -> fc2 (256) ----
        self.fc1 = LinearBlock(
            enc[4] * 8 * 8, 512, kernel_init=init_lib.torch_default_linear(), device=device
        )

        # ---- decoder trunk from cat(fc2, z) as a 1x1 map ----
        self.deconv_8 = DeconvBlock(256 + zdim, dec[0], 8, 1, 0, 0, "kaiming", RELU, **dkw)
        self.deconv_32 = DeconvBlock(dec[0], dec[1], 3, 4, 0, 1, "kaiming", RELU, **dkw)
        self.deconv_64 = DeconvBlock(dec[1], dec[2], 3, 2, 1, 1, "kaiming", RELU, **dkw)
        self.deconv_128 = DeconvBlock(dec[2], dec[3], 3, 2, 1, 1, "kaiming", RELU, **dkw)

        # ---- scale 8: k=2 blocks with reflect padding (l, r, t, b) = (1, 0, 1, 0)
        dim8 = dec[0] + enc[4]
        for name in ("add_8", "enhance_8_0", "enhance_8_1"):
            rb(dim8, name, out_channels=dim8, kernel_size=2, padding=(1, 0, 1, 0))
        self.upsample_16 = DeconvBlock(dim8, enh[0], 3, 2, 1, 1, "kaiming", RELU, **dkw)

        # ---- scale 16 ----
        rb(enc[3], "add_16")
        dim16 = enh[0] + enc[3]
        for i in range(2):
            rb(dim16, f"enhance_16_{i}")
        self.upsample_32 = DeconvBlock(dim16, enh[1], 3, 2, 1, 1, "kaiming", RELU, **dkw)

        # ---- scale 32 ----
        dim32 = enc[2] + dec[1]
        rb(dim32, "add_32")
        dim32e = enh[1] + dim32
        for i in range(2):
            rb(dim32e, f"enhance_32_{i}")
        self.upsample_64 = DeconvBlock(dim32e, enh[2], 3, 2, 1, 1, "kaiming", RELU, **dkw)

        # ---- scale 64 ----
        dim64 = enc[1] + dec[2]
        rb(dim64, "add_64", kernel_size=5)
        dim64e = enh[2] + dim64
        for i in range(2):
            rb(dim64e, f"enhance_64_{i}")
        self.upsample_128 = DeconvBlock(dim64e, enh[3], 3, 2, 1, 1, "kaiming", RELU, **dkw)

        # ---- scale 128 with local injection (the 75-channel add_128) ----
        dim128 = dec[3] + enc[0] + 3
        rb(dim128, "add_128", kernel_size=7)
        dim128e = enh[3] + dim128 + local_feature_layer_dim + 3
        rb(dim128e, "enhance_128", kernel_size=5)

        # ---- head (D_and_G_model.py:274-279) ----
        self.conv5_conv = ConvBlock(dim128e, head[0], 5, 1, 2, "kaiming", LEAKY_RELU, **kw)
        rb(head[0], "conv5_res", kernel_size=3)
        self.conv6 = ConvBlock(head[0], head[1], 3, 1, 1, "kaiming", LEAKY_RELU, **kw)
        self.decoded_img128 = ConvBlock(
            head[1], 3, 3, 1, 1, None, None, use_batchnorm=False, device=device
        )

    def forward(
        self,
        i128: torch.Tensor,
        local_fake_image: torch.Tensor,
        local_feature: torch.Tensor,
        z: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        skips = []
        h = i128
        for name, _k, _s, _p, n_res in _ENCODER:
            h = getattr(self, f"{name}_conv")(h)
            for i in range(n_res):
                h = getattr(self, f"{name}_res{i}")(h)
            skips.append(h)
        conv0, conv1, conv2, conv3, conv4 = skips

        b = conv4.shape[0]
        fc1 = self.fc1(conv4.reshape(b, -1))
        fc2 = fc1.reshape(b, 256, 2).amax(dim=-1)  # MaxPool1d(2, 2)

        trunk_in = torch.cat([fc2, z.to(fc2.dtype)], dim=1)[:, :, None, None]
        deconv_8 = self.deconv_8(trunk_in)  # 8x8
        deconv_32 = self.deconv_32(deconv_8)  # 32x32
        deconv_64 = self.deconv_64(deconv_32)  # 64x64
        deconv_128 = self.deconv_128(deconv_64)  # 128x128

        h = self.add_8(torch.cat([deconv_8, conv4], dim=1))
        h = self.enhance_8_1(self.enhance_8_0(h))
        h = self.upsample_16(h)

        h = torch.cat([h, self.add_16(conv3)], dim=1)
        h = self.upsample_32(self.enhance_16_1(self.enhance_16_0(h)))

        h = torch.cat([h, self.add_32(torch.cat([deconv_32, conv2], dim=1))], dim=1)
        h = self.upsample_64(self.enhance_32_1(self.enhance_32_0(h)))

        h = torch.cat([h, self.add_64(torch.cat([deconv_64, conv1], dim=1))], dim=1)
        h = self.upsample_128(self.enhance_64_1(self.enhance_64_0(h)))

        a128 = self.add_128(torch.cat([deconv_128, conv0, i128.to(h.dtype)], dim=1))
        h = torch.cat(
            [h, a128, local_feature.to(h.dtype), local_fake_image.to(h.dtype)], dim=1
        )
        h = self.enhance_128(h)

        h = self.conv6(self.conv5_res(self.conv5_conv(h)))
        return self.decoded_img128(h), fc2
