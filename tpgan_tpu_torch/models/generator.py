"""Generator — the two-pathway TP-GAN generator: four LocalPathways, the
max-fuser, the GlobalPathway, and the identity classification head
(reference: D_and_G_model.py:331-407). The port of
``tpgan_tpu/models/generator.py``, on NCHW tensors.

All three fuses go through the kernel wrapper ``ops.kernels.fuse_parts``:
the hand-written CUDA kernel on the card, its plain version on the CPU.

Dropout (``FeaturePredict``, rate 0.3) draws its mask from an explicit
``torch.Generator`` or takes a precomputed keep-mask; with
``use_dropout=True`` and neither, it raises. BatchNorm (when configured)
follows the module's train/eval mode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from tpgan_tpu_torch.models.global_pathway import GlobalPathway
from tpgan_tpu_torch.models.local_pathway import LocalPathway
from tpgan_tpu_torch.ops import initializers as init_lib
from tpgan_tpu_torch.ops.blocks import LinearBlock
from tpgan_tpu_torch.ops.kernels import fuse_parts


class FeaturePredict(nn.Module):
    """Dropout(0.3) + Linear(256 -> num_classes) identity classifier over
    the bottleneck feature (reference: D_and_G_model.py:331-348)."""

    def __init__(
        self,
        num_classes: int,
        global_feature_layer_dim: int = 256,
        dropout: float = 0.3,
        device=None,
    ):
        super().__init__()
        self.dropout = dropout
        self.fc = LinearBlock(
            global_feature_layer_dim, num_classes,
            kernel_init=init_lib.torch_default_linear(), device=device,
        )

    def forward(
        self,
        x: torch.Tensor,
        use_dropout: bool = False,
        generator: Optional[torch.Generator] = None,
        keep_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if use_dropout:
            if keep_mask is None:
                if generator is None:
                    raise ValueError(
                        "use_dropout=True needs a torch.Generator or a keep_mask; "
                        "the port draws no randomness from torch's global RNG"
                    )
                keep_mask = dropout_keep_mask(x.shape, self.dropout, generator, x.device)
            x = apply_dropout(x, keep_mask, self.dropout)
        return self.fc(x)


def dropout_keep_mask(
    shape, rate: float, generator: torch.Generator, device=None
) -> torch.Tensor:
    """Boolean keep-mask, each element kept with probability 1 - rate."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def apply_dropout(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """JAX's ``nn.Dropout``: ``where(mask, x / keep, 0)``. The JAX divisor
    is the Python float ``keep`` taken in ``x``'s dtype, so it is rounded
    to that dtype here too (0.69921875 in bfloat16)."""
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    if keep_mask.shape != x.shape:
        raise ValueError(f"keep_mask {tuple(keep_mask.shape)} != input {tuple(x.shape)}")
    return torch.where(keep_mask.to(device=x.device, dtype=torch.bool), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))


class GeneratorOutput(NamedTuple):
    """The reference's 8-tuple return (D_and_G_model.py:407), named; NCHW."""

    img128_fake: torch.Tensor       # synthesized frontal face, (B, 3, 128, 128)
    encoder_predict: torch.Tensor   # identity logits from the bottleneck
    local_fake: torch.Tensor        # fused fake-patch mosaic (B, 3, 128, 128)
    left_eye_fake: torch.Tensor
    right_eye_fake: torch.Tensor
    nose_fake: torch.Tensor
    mouth_fake: torch.Tensor
    local_origin: torch.Tensor      # fused ground-truth-patch mosaic


class Generator(nn.Module):
    def __init__(
        self,
        zdim: int,
        num_classes: int,
        use_batchnorm: bool = True,
        use_residual_block: bool = True,
        fm_multiplier: float = 1.0,
        local_feature_layer_dim: int = 64,
        upsample_mode: str = "deconv",
        device=None,
    ):
        super().__init__()
        kw = dict(
            use_batchnorm=use_batchnorm,
            fm_multiplier=fm_multiplier,
            feature_layer_dim=local_feature_layer_dim,
            upsample_mode=upsample_mode,
            device=device,
        )
        self.local_left_eye = LocalPathway(**kw)
        self.local_right_eye = LocalPathway(**kw)
        self.local_nose = LocalPathway(**kw)
        self.local_mouth = LocalPathway(**kw)
        self.global_pathway = GlobalPathway(
            zdim=zdim,
            local_feature_layer_dim=local_feature_layer_dim,
            use_batchnorm=use_batchnorm,
            use_residual_block=use_residual_block,
            fm_multiplier=fm_multiplier,
            upsample_mode=upsample_mode,
            device=device,
        )
        self.feature_predict = FeaturePredict(num_classes, device=device)

    def forward(
        self,
        i128: torch.Tensor,
        left_eye: torch.Tensor,
        right_eye: torch.Tensor,
        nose: torch.Tensor,
        mouth: torch.Tensor,
        z: torch.Tensor,
        use_dropout: bool = False,
        dropout_generator: Optional[torch.Generator] = None,
        drop_mask: Optional[torch.Tensor] = None,
    ) -> GeneratorOutput:
        """``use_dropout=True`` needs ``dropout_generator`` or ``drop_mask``
        (a boolean keep-mask of shape (B, 256))."""
        # Four independent per-part U-Nets (D_and_G_model.py:363-366,390-393)
        le_img, le_feat = self.local_left_eye(left_eye)
        re_img, re_feat = self.local_right_eye(right_eye)
        no_img, no_feat = self.local_nose(nose)
        mo_img, mo_feat = self.local_mouth(mouth)

        # Max-fuse features, fake patches, and GT patches onto the canvas
        # (D_and_G_model.py:396-398)
        fused_feature = fuse_parts(le_feat, re_feat, no_feat, mo_feat)
        fused_fake = fuse_parts(le_img, re_img, no_img, mo_img)
        fused_origin = fuse_parts(
            left_eye.contiguous(), right_eye.contiguous(), nose.contiguous(),
            mouth.contiguous(),
        )

        img128_fake, encoder_feature = self.global_pathway(
            i128, fused_fake, fused_feature, z
        )
        encoder_predict = self.feature_predict(
            encoder_feature, use_dropout, dropout_generator, drop_mask
        )

        return GeneratorOutput(
            img128_fake=img128_fake,
            encoder_predict=encoder_predict,
            local_fake=fused_fake,
            left_eye_fake=le_img,
            right_eye_fake=re_img,
            nose_fake=no_img,
            mouth_fake=mo_img,
            local_origin=fused_origin,
        )
