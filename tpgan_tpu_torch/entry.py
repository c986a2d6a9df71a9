"""Entry points of the port, built from the port alone (seeded random
weights, seeded synthetic batches):

* :func:`entry` — the counterpart of ``__graft_entry__.entry()``: the
  full-size (fm=1.0) generator synthesis forward at batch 8 in bfloat16;
* :func:`train_entry` — the full-size fused WGAN-GP train step at batch
  16 in bfloat16 (f32 master weights), through ``create_gan_state`` +
  ``make_gan_train_step`` as ``tpgan_tpu/train/loop.py`` builds it,
  optionally with the identity-preserving term through a seeded ResNet18
  embedder;
* :func:`pretrain_entry` — the landmark detector's f32 pretrain step
  (``train/pretrain.py``) at the config's defaults: the full MobileNetV2
  + SSD head, 256x256, batch 64."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch, synthetic_pretrain_batch
from tpgan_tpu_torch.models.feature_extract import (
    build_feature_extract_model,
    make_identity_embed_fn,
)
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    create_gan_state,
    make_gan_train_step,
    make_synthesize_fn,
)
from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step
from tpgan_tpu_torch.utils.device import resolve_device

BATCH = 8
TRAIN_BATCH = 16
PATCH_KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")


def entry(device: Optional[Union[str, torch.device]] = None):
    """Returns ``(fn, args)``: ``fn(*args)`` is the NHWC bf16
    ``img128_fake`` of a batch of 8, on ``cuda`` unless ``device`` says
    otherwise (raises when no GPU is present and none was asked for)."""
    device = resolve_device(device)
    cfg = make_config({"compute_dtype": "bfloat16"})
    gen = build_generator(cfg, device, seed=0)
    synthesize = make_synthesize_fn(cfg, gen)
    batch = {
        k: torch.as_tensor(v, device=device)
        for k, v in synthetic_gan_batch(BATCH, seed=0).items()
        if k in PATCH_KEYS
    }
    z = torch.as_tensor(
        np.random.RandomState(1).standard_normal((BATCH, cfg.G.zdim)).astype(np.float32),
        device=device,
    )
    return synthesize, (batch, z)


def train_entry(device: Optional[Union[str, torch.device]] = None, batch_size: int = TRAIN_BATCH,
                identity: bool = False):
    """Returns ``(step_fn, (state, batch, generator))``: each
    ``step_fn(state, batch, generator)`` takes one optimizer step of both
    models and returns ``(state, metrics)``. Full size, bf16 compute,
    seed 0, on ``cuda`` unless ``device`` says otherwise (raises when no
    GPU is present and none was asked for). ``identity``: the G loss's
    identity-preserving term on, through a frozen f32 ResNet18 embedder
    of the configured width (128x128 input, 347 classes, fc0 256) with
    weights from seed 0."""
    device = resolve_device(device)
    cfg = make_config({"compute_dtype": "bfloat16"})
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=device)
    embed = (make_identity_embed_fn(build_feature_extract_model(cfg, device, seed=0))
             if identity else None)
    step_fn = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, identity_embed=embed)
    batch = {
        k: torch.as_tensor(v, device=device)
        for k, v in synthetic_gan_batch(batch_size, seed=0, num_classes=cfg.G.num_classes).items()
    }
    generator = torch.Generator(device=device).manual_seed(0)
    return step_fn, (state, batch, generator)


def pretrain_entry(device: Optional[Union[str, torch.device]] = None,
                   head_mode: str = "absolute", batch_size: Optional[int] = None):
    """Returns ``(step_fn, (state, images, labels, generator))``: each
    ``step_fn(state, images, labels, generator)`` takes one SGD step of
    the landmark detector and returns ``(state, metrics)``. The full
    detector (MobileNetV2 has no width knob) with weights from seed 0, in
    ``head_mode``, f32, at ``pretrain.image_size`` 256 and
    ``pretrain.batch_size`` 64 (the config's defaults) unless
    ``batch_size`` says otherwise; the batch is ``synthetic_pretrain_batch``
    (seed 0) on the device. On ``cuda`` unless ``device`` says otherwise
    (raises when no GPU is present and none was asked for)."""
    device = resolve_device(device)
    cfg = make_config({"pretrain": {"head_mode": head_mode}})
    p = cfg.pretrain
    state, model, opt = create_pretrain_state(cfg, seed=0, device=device)
    step_fn = make_pretrain_step(cfg, model, opt, state.scheduler)
    batch = synthetic_pretrain_batch(batch_size or p.batch_size, p.image_size, seed=0)
    images = torch.as_tensor(batch["image"], device=device)
    labels = torch.as_tensor(batch["label"], device=device)
    generator = torch.Generator(device=device).manual_seed(0)
    return step_fn, (state, images, labels, generator)
