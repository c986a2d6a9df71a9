"""The identity embedder — the port of
``tpgan_tpu/models/feature_extract.py`` (reference: FeatureExtract.py:5-41):
``FeatureExtractModel`` selects a ResNet18 or a MobileNetV2 backbone with
a ``num_of_output_classes`` classification head, and
:func:`make_identity_embed_fn` freezes one into the function the GAN step's
identity-preserving loss calls.

The reference's MobileNetV2 branch dereferences a nonexistent ``.FC``
(:34); as in the JAX package, :class:`MobileNetV2Classifier` is what that
branch intends: the standard MobileNetV2 image classifier (stem, the
inverted residuals, a 1x1 conv to 1280, global average pool) with a
Dropout(0.2) + Linear head.

Images are NCHW, as everywhere in the port's models. The embedder's convs
(the depthwise ones included), its max-pool and its pooling go to cuDNN
and torch, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch
import torch.nn as nn

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.models.mobilenet_v2 import INVERTED_RESIDUAL_SETTING, InvertedResidual
from tpgan_tpu_torch.models.resnet import ResNet18
from tpgan_tpu_torch.ops import initializers as init_lib
from tpgan_tpu_torch.ops.activations import RELU6, apply_activation
from tpgan_tpu_torch.ops.blocks import (
    BatchNorm2d,
    Conv2d,
    LinearBlock,
    cast_parameters_,
    conv_memory_format,
    dropout,
    reset_parameters,
)
from tpgan_tpu_torch.ops.kernels import to_memory_format
from tpgan_tpu_torch.utils.device import resolve_device

# the identity feature of the ResNet18 branch (FeatureExtractModel's default)
FEATURE_DIM = 256


class MobileNetV2Classifier(nn.Module):
    """MobileNetV2 backbone as an image classifier; returns
    ``(logits, pooled 1280-d features)``."""

    def __init__(self, num_of_output_classes: int = 1000, dropout_rate: float = 0.2,
                 device=None):
        super().__init__()
        he = init_lib.he_ssd_conv()
        self.dropout_rate = dropout_rate
        self.stem = Conv2d(3, 32, 3, 2, 1, use_bias=False, kernel_init=he, device=device)
        self.stem_bn = BatchNorm2d(32, device=device)
        self.blocks = []
        cin = 32
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            for rep in range(n):
                name = f"block{len(self.blocks)}"
                setattr(self, name, InvertedResidual(cin, c, s if rep == 0 else 1, t,
                                                     device=device))
                self.blocks.append(name)
                cin = c
        self.conv2 = Conv2d(320, 1280, 1, 1, 0, use_bias=False, kernel_init=he, device=device)
        self.conv2_bn = BatchNorm2d(1280, device=device)
        self.fc = LinearBlock(1280, num_of_output_classes, kernel_init=init_lib.normal(0.01),
                              device=device)

    def forward(
        self,
        x: torch.Tensor,
        use_dropout: bool = False,
        drop_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = apply_activation(self.stem_bn(self.stem(x)), RELU6)
        for name in self.blocks:
            h = getattr(self, name)(h)
        h = apply_activation(self.conv2_bn(self.conv2(h)), RELU6)
        pooled = h.mean(dim=(2, 3))
        h = dropout(pooled, self.dropout_rate, use_dropout, generator, drop_mask)
        return self.fc(h), pooled


class FeatureExtractModel(nn.Module):
    """``base``: :class:`ResNet18` (``"resnet"``, with an fc0 bottleneck of
    ``feature_layer_dim_before_fc``) or :class:`MobileNetV2Classifier`
    (``"mobilenetv2"``). ``forward(x, use_dropout, drop_mask, generator)``
    returns the backbone's ``(logits, features)``."""

    def __init__(
        self,
        base_model_name: str = "resnet",
        num_of_output_classes: int = 1000,
        feature_layer_dim_before_fc: Optional[int] = FEATURE_DIM,
        device=None,
    ):
        super().__init__()
        name = base_model_name.lower()
        if name == "resnet":
            self.base = ResNet18(num_of_output_classes=num_of_output_classes,
                                 feature_layer_dim_before_fc=feature_layer_dim_before_fc,
                                 device=device)
        elif name == "mobilenetv2":
            self.base = MobileNetV2Classifier(num_of_output_classes, device=device)
        else:
            raise ValueError("feature extraction supports only 'resnet' or 'mobilenetv2' "
                             "(reference: FeatureExtract.py:27)")

    def forward(self, x, use_dropout: bool = False, drop_mask=None, generator=None):
        return self.base(x, use_dropout, drop_mask, generator)


def build_feature_extract_model(
    cfg: Config, device: Optional[Union[str, torch.device]] = None, seed: int = 0
) -> FeatureExtractModel:
    """The configured embedder (``cfg.feature_extract_model``'s backbone
    and class count, fc0 256) with float32 weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in train mode, on ``device``
    (``cuda`` unless asked otherwise)."""
    device = resolve_device(device)
    fx = cfg.feature_extract_model
    model = FeatureExtractModel(fx.base_model_name, fx.num_of_output_classes, device=device)
    reset_parameters(model, torch.Generator(device=device).manual_seed(seed))
    return model


def cast_embedder(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the conv and linear weights of ``model`` to ``dtype`` in place,
    once (the opt-in bf16 embedder, ``tpgan_tpu/cli.py:208-240``: the
    checkpoint on disk stays f32). BatchNorm keeps float32 parameters and
    statistics and normalises in f32, as the JAX BatchNorm computes;
    JAX's load-time cast also rounds them to bf16, a difference within
    bf16's own rounding of the activations (``ops.blocks.cast_parameters_``:
    bf16 conv weights are stored channels-last)."""
    return cast_parameters_(model, dtype)


def make_identity_embed_fn(model: nn.Module) -> Callable[[torch.Tensor], torch.Tensor]:
    """Freeze ``model`` into the function the identity-preserving loss
    calls (weights: config.py:80): NCHW images -> the fc0 features
    (ResNet18) or the pooled features (MobileNetV2).

    The model is put in eval mode (BatchNorm normalises with its running
    statistics, dropout is off) and every parameter stops requiring a
    gradient, so a G phase through it takes the gradient with respect to
    the images only: no embedder weight gradient is computed and no
    ``.grad`` is set. Images are cast to the model's compute dtype (its
    first conv's: the compute dtype when one is set, else the weight's)
    and put in that dtype's conv layout (``ops.blocks.conv_memory_format``:
    contiguous NCHW for an f32 embedder fed a bf16 generator's
    channels-last images, one copy counted in
    ``ops.kernels.layout_counts()``); both are differentiable, so the loss
    still reaches the generator."""
    model.eval()
    model.requires_grad_(False)
    conv = next(m for m in model.modules() if isinstance(m, Conv2d))
    dtype = conv.compute_dtype or conv.weight.dtype
    layout = conv_memory_format(dtype)

    def embed(images: torch.Tensor) -> torch.Tensor:
        logits, feats = model(to_memory_format(images.to(dtype), layout))
        return feats if feats is not None else logits

    return embed
