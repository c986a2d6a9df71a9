"""Entry points of the port, built from the port alone (seeded random
weights, seeded synthetic batches):

* :func:`entry` — the counterpart of ``__graft_entry__.entry()``: the
  full-size (fm=1.0) generator synthesis forward at batch 8 in bfloat16;
* :func:`int8_entry` — its int8 counterpart: the same generator
  calibrated on the example batch and served by
  ``gan_trainer.make_int8_synthesize_fn``;
* :func:`train_entry` — the full-size fused WGAN-GP train step at batch
  16 in bfloat16 (f32 master weights), through ``create_gan_state`` +
  ``make_gan_train_step`` as ``tpgan_tpu/train/loop.py`` builds it,
  optionally with the identity-preserving term through a seeded ResNet18
  embedder;
* :func:`pretrain_entry` — the landmark detector's f32 pretrain step
  (``train/pretrain.py``) at the config's defaults: the full MobileNetV2
  + SSD head, 256x256, batch 64;
* :func:`frontalize_entry` — full-stack frontalization
  (``frontalize.make_frontalize_fn``), raw uint8 frames to frontal faces:
  the full detector at 256 in f32 and the full-size generator in bf16,
  a batch of 8 frames of 480x640."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch, synthetic_pretrain_batch
from tpgan_tpu_torch.data.synthetic_faces import render_face
from tpgan_tpu_torch.frontalize import make_frontalize_fn
from tpgan_tpu_torch.models.feature_extract import (
    build_feature_extract_model,
    make_identity_embed_fn,
)
from tpgan_tpu_torch.ops.quant import calibrate_synthesis
from tpgan_tpu_torch.train.gan_trainer import (
    build_generator,
    create_gan_state,
    make_gan_train_step,
    make_int8_synthesize_fn,
    make_synthesize_fn,
)
from tpgan_tpu_torch.train.pretrain import build_detector, create_pretrain_state, make_pretrain_step
from tpgan_tpu_torch.utils.device import resolve_device

BATCH = 8
TRAIN_BATCH = 16
PATCH_KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")
FRONTALIZE_BATCH = 8
FRAME_HW = (480, 640)  # Multi-PIE's capture size
DETECTOR_SIZE = 256


def entry(device: Optional[Union[str, torch.device]] = None):
    """Returns ``(fn, args)``: ``fn(*args)`` is the NHWC bf16
    ``img128_fake`` of a batch of 8, on ``cuda`` unless ``device`` says
    otherwise (raises when no GPU is present and none was asked for)."""
    device = resolve_device(device)
    cfg = make_config({"compute_dtype": "bfloat16"})
    gen = build_generator(cfg, device, seed=0)
    return make_synthesize_fn(cfg, gen), _example(cfg, device)


def _example(cfg, device, batch_size: int = BATCH):
    """The entry points' synthesis batch (seed 0) and z (seed 1) on ``device``."""
    batch = {
        k: torch.as_tensor(v, device=device)
        for k, v in synthetic_gan_batch(batch_size, seed=0).items()
        if k in PATCH_KEYS
    }
    z = torch.as_tensor(
        np.random.RandomState(1).standard_normal((batch_size, cfg.G.zdim)).astype(np.float32),
        device=device,
    )
    return batch, z


def int8_entry(device: Optional[Union[str, torch.device]] = None, batch_size: int = BATCH):
    """Returns ``(fn, args)``: ``fn(*args)`` is the NHWC bf16
    ``img128_fake`` of the int8 synthesis of a batch of ``batch_size``
    (8): :func:`entry`'s full-size generator (seed 0, bf16 compute),
    calibrated on that example batch (``ops.quant.calibrate_synthesis``,
    z from its seeded ``torch.Generator``), every conv int8 x int8 ->
    int32 with float32 rescale. On ``cuda`` unless ``device`` says
    otherwise (raises when no GPU is present and none was asked for)."""
    device = resolve_device(device)
    cfg = make_config({"compute_dtype": "bfloat16"})
    gen = build_generator(cfg, device, seed=0)
    batch, z = _example(cfg, device, batch_size)
    scales = calibrate_synthesis(cfg, gen, [batch])
    return make_int8_synthesize_fn(cfg, gen, scales), (batch, z)


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


def frames(batch: int, seed: int = 0, hw=FRAME_HW) -> np.ndarray:
    """``batch`` uint8 RGB frames (B, H, W, 3) from ``seed``: a noisy
    grey background with one rendered face each (``render_face``: a
    seeded subject, yaw within 45 degrees, 160-280 px) at a seeded place
    in the frame."""
    rng = np.random.RandomState(seed)
    h, w = hw
    out = np.clip(rng.normal(110.0, 25.0, (batch, h, w, 3)), 0, 255).astype(np.uint8)
    for i in range(batch):
        size = int(rng.randint(160, min(280, h, w) + 1))
        face, _lm5 = render_face(int(rng.randint(0, 1000)), float(rng.uniform(-45, 45)), size)
        top, left = rng.randint(0, h - size + 1), rng.randint(0, w - size + 1)
        out[i, top:top + size, left:left + size] = face
    return out


def frontalize_entry(device: Optional[Union[str, torch.device]] = None,
                     batch_size: int = FRONTALIZE_BATCH):
    """Returns ``(fn, (images, z))``: ``fn(images, z)`` is ``(fake, lm5,
    scores)``, full-stack frontalization of ``batch_size`` (8) uint8
    frames of 480x640 (:func:`frames`, seed 0) with z from seed 1: the
    MobileNetV2 + SSD detector (``absolute`` head; it has no width knob)
    at 256 in f32 eval mode, the generator at the config's defaults (fm
    1.0, ``deconv``) in bf16, both with weights from seed 0, through
    ``make_frontalize_fn`` with its defaults (upscaling letterbox, no TTA,
    no refine, no nose prior: the CLI's). On ``cuda`` unless ``device``
    says otherwise (raises when no GPU is present and none was asked
    for)."""
    device = resolve_device(device)
    cfg = make_config({"compute_dtype": "bfloat16"})
    detector = build_detector(cfg, device, seed=0)
    gen = build_generator(cfg, device, seed=0)
    fn = make_frontalize_fn(cfg, detector, gen, detector_size=DETECTOR_SIZE)
    images = torch.as_tensor(frames(batch_size, seed=0), device=device)
    z = torch.as_tensor(np.random.RandomState(1).standard_normal(
        (batch_size, cfg.G.zdim)).astype(np.float32), device=device)
    return fn, (images, z)
