"""Generator construction and the synthesis (serving) function — the
synthesis part of ``tpgan_tpu/train/gan_trainer.py`` (``build_models`` and
``make_synthesize_fn``). The WGAN-GP train step is a later slice.
"""

from __future__ import annotations

import copy
from typing import Callable, Mapping, Optional, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.ops.blocks import BatchNorm2d, reset_parameters
from tpgan_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ArrayLike = Union[torch.Tensor, np.ndarray]


def build_generator(
    cfg: Config, device: Optional[Union[str, torch.device]] = None, seed: int = 0
) -> Generator:
    """The configured Generator, in eval mode with float32 parameters on
    ``device`` (``cuda`` unless ``device="cpu"`` is given), its weights
    drawn from a ``torch.Generator`` seeded with ``seed``."""
    device = resolve_device(device)
    if cfg.G.pad_channel_multiple is not None:
        raise ValueError(
            "G.pad_channel_multiple is a TPU lane-alignment layout; the "
            "PyTorch port stores the reference-parity (unpadded) layout"
        )
    gen = Generator(
        zdim=cfg.G.zdim,
        num_classes=cfg.G.num_classes,
        use_batchnorm=cfg.G.use_batchnorm,
        use_residual_block=cfg.G.use_residual_block,
        fm_multiplier=cfg.G.fm_multiplier,
        local_feature_layer_dim=cfg.G.local_feature_layer_dim,
        upsample_mode=cfg.G.upsample_mode,
        device=device,
    )
    reset_parameters(gen, torch.Generator(device=device).manual_seed(seed))
    return gen.eval()


def _compute_copy(gen: Generator, dtype: torch.dtype) -> Generator:
    """A copy of ``gen`` whose conv and linear weights are in ``dtype``.
    BatchNorm stays float32: it normalises in f32 and casts back, as the
    JAX BatchNorm2d does."""
    out = copy.deepcopy(gen)
    for m in out.modules():
        if isinstance(m, BatchNorm2d):
            continue
        for p in m.parameters(recurse=False):
            p.data = p.data.to(dtype)
    return out


def make_synthesize_fn(
    cfg: Config, gen: Generator
) -> Callable[[Mapping[str, ArrayLike], ArrayLike], torch.Tensor]:
    """Inference: profile image + patches + noise -> frontalized face.

    ``synthesize(batch, z)`` takes the JAX function's NHWC batch dict
    (``img``, ``left_eye``, ``right_eye``, ``nose``, ``mouth``; tensors or
    numpy arrays) and ``z`` (B, zdim), and returns ``img128_fake`` as an
    NHWC (B, 128, 128, 3) tensor in ``cfg.compute_dtype`` on ``gen``'s
    device. Eval mode, no dropout, no autograd. When the compute dtype is
    not float32 the weights are cast once, into a copy made here: later
    changes to ``gen`` do not reach the returned function.
    """
    dtype = _DTYPES[cfg.compute_dtype]
    device = next(gen.parameters()).device
    model = gen if dtype == torch.float32 else _compute_copy(gen, dtype)
    model.eval()

    def nchw(x: ArrayLike) -> torch.Tensor:
        return torch.as_tensor(x, device=device).permute(0, 3, 1, 2).contiguous()

    @torch.inference_mode()
    def synthesize(batch: Mapping[str, ArrayLike], z: ArrayLike) -> torch.Tensor:
        out = model(
            nchw(batch["img"]), nchw(batch["left_eye"]), nchw(batch["right_eye"]),
            nchw(batch["nose"]), nchw(batch["mouth"]), torch.as_tensor(z, device=device),
            use_dropout=False,
        )
        return out.img128_fake.permute(0, 2, 3, 1).contiguous()

    return synthesize
