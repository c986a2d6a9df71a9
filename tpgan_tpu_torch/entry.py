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
  a batch of 8 frames of 480x640;
* :func:`dryrun_multichip` — the counterpart of
  ``__graft_entry__.dryrun_multichip``: one train step over n spawned
  ranks on a (data, model) mesh (a model axis of 2 when n is even)
  against the same step in one process at the global batch, and the
  full-size synthesis under data and tensor parallelism against one
  process's."""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import MeshConfig, make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch, synthetic_pretrain_batch
from tpgan_tpu_torch.data.synthetic_faces import render_face
from tpgan_tpu_torch.frontalize import make_frontalize_fn
from tpgan_tpu_torch.models.feature_extract import (
    build_feature_extract_model,
    make_identity_embed_fn,
)
from tpgan_tpu_torch.ops.quant import calibrate_synthesis
from tpgan_tpu_torch.parallel import (
    infer_param_shardings,
    make_mesh,
    per_device_bytes,
    place,
    shard_gan_state,
)
from tpgan_tpu_torch.parallel.distributed import spawn
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


DRYRUN_OVERRIDES = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
                    "D": {"fm_multiplier": 0.25}, "compute_dtype": "float32"}
DRYRUN_ROWS = 2  # per device, as JAX's dryrun_multichip's batch of 2 n
DRYRUN_MIN_SHARD_DIM = 64  # the narrow step's rule, __graft_entry__.py:100


def dryrun_mesh_shape(n: int):
    """(data, model) of JAX's dryrun over n devices: a model axis of 2 when
    n is even (``__graft_entry__.py:74``)."""
    model = 2 if n % 2 == 0 and n >= 2 else 1
    return n // model, model


def _params_opt(state):
    return (list(state.gen.parameters()), list(state.disc.parameters()), state.g_opt,
            state.d_opt)


def _dryrun_step(device, n: int, mesh=None):
    """JAX's dryrun step: fm 0.25, f32, seed 0, the synthetic batch of 2 n
    (seed 0) and a step generator seeded 1; on a ``mesh``, this rank's
    rows and its slices of the weights JAX's rule shards at
    ``min_shard_dim`` 64. Returns (the metrics as floats, the bytes of
    the parameters and both Adam states this rank holds after the step)."""
    cfg = make_config(DRYRUN_OVERRIDES)
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=device)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    batch = synthetic_gan_batch(DRYRUN_ROWS * n, seed=0)
    if mesh is not None:
        place(state, shard_gan_state(mesh, state, min_shard_dim=DRYRUN_MIN_SHARD_DIM))
        batch = {k: v[mesh.rows(len(v))] for k, v in batch.items()}
    _, metrics = step(state, batch, torch.Generator(device=device).manual_seed(1))
    return {k: float(v) for k, v in metrics.items()}, per_device_bytes(_params_opt(state))


def _dryrun_synthesis(device, n: int, mesh=None) -> np.ndarray:
    """The full-size (fm 1.0) f32 synthesis of the synthetic batch of
    ``n`` (seed 0) with z = 0, generator seed 2; on a ``mesh``, this
    rank's rows, its generator placed by JAX's default rule."""
    cfg = make_config({"compute_dtype": "float32"})
    gen = build_generator(cfg, device, seed=2)
    rows = slice(None)
    if mesh is not None:
        place(gen, infer_param_shardings(mesh, gen))
        rows = mesh.rows(n)
    synthesize = make_synthesize_fn(cfg, gen)
    batch = {k: v[rows] for k, v in synthetic_gan_batch(n, seed=0).items() if k in PATCH_KEYS}
    z = np.zeros((len(batch["img"]), cfg.G.zdim), np.float32)
    return synthesize(batch, z).float().cpu().numpy()


@contextlib.contextmanager
def _f32_exact():
    """float32 convolutions and products in float32 (no TF32 on the card),
    as the JAX dryrun's CPU run computes them; restored on leaving."""
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _dryrun_rank(rank: int, n: int, device: str):
    """One rank of :func:`dryrun_multichip`: (metrics, its params + Adam
    bytes, its data index, its synthesis rows)."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(2)
    data, model = dryrun_mesh_shape(n)
    mesh = make_mesh(MeshConfig(data=data, model=model))
    with _f32_exact():
        metrics, nbytes = _dryrun_step(torch.device(device), n, mesh)
        return metrics, nbytes, mesh.rank, _dryrun_synthesis(torch.device(device), n, mesh)


def dryrun_multichip(n_devices: int, backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None) -> dict:
    """JAX's ``dryrun_multichip`` over ``n_devices`` spawned ranks: a
    (data, model) mesh with a model axis of 2 when n is even, one train
    step (fm 0.25, f32, a batch of 2 n, the weights JAX's rule shards at
    ``min_shard_dim`` 64 split over the model axis), then the same step in
    this process at the global batch from the same weights and draws,
    every metric asserted equal within JAX's ``1e-3 + 1e-3 |ref|``
    (``__graft_entry__.py:143``); then the full-size (fm 1.0) f32
    synthesis of n images under data and tensor parallelism (JAX's default
    rule) against this process's, within JAX's 5e-4; float32 throughout
    (no TF32). ``backend``: ``nccl`` on the card (one card per rank: more
    ranks than cards raise) and ``gloo`` on the CPU unless named; gloo on
    the card runs every rank on the cards in turn. On ``cuda`` unless
    ``device`` says otherwise. Returns the mesh, the metrics of both
    sides, the synthesis gap, and the parameters + Adam states in MiB per
    rank (by rank) against one process's."""
    device = resolve_device(device)
    backend = backend or ("gloo" if device.type == "cpu" else "nccl")
    data, model = dryrun_mesh_shape(n_devices)
    ranks = spawn(_dryrun_rank, n_devices, backend=backend, device=str(device),
                  args=(n_devices, str(device)))
    metrics = ranks[0][0]
    for other, *_rest in ranks[1:]:
        if other != metrics:
            raise AssertionError(f"ranks disagree on the global metrics: {metrics} vs {other}")
    with _f32_exact():
        ref, total = _dryrun_step(device, n_devices)
        single = _dryrun_synthesis(device, n_devices)
    for k, b in ref.items():
        a = metrics[k]
        if not (np.isfinite(a) and abs(a - b) <= 1e-3 + 1e-3 * abs(b)):
            raise AssertionError(f"mesh-vs-single metric mismatch for {k}: {a} vs {b}")
    per = n_devices // data  # each rank's rows: those of its data index
    delta = max(float(np.max(np.abs(rows - single[d * per:(d + 1) * per])))
                for _m, _b, d, rows in ranks)
    if delta > 5e-4:
        raise AssertionError(f"full-size dp+tp synthesis mismatch: {delta}")
    return {"mesh": {"data": data, "model": model}, "backend": backend, "metrics": metrics,
            "single": ref, "synthesis_max_abs_delta": delta,
            "params_opt_mib": [b / 2**20 for _m, b, _d, _r in ranks],
            "unsharded_params_opt_mib": total / 2**20}
