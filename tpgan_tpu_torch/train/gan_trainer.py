"""Model construction, the fused WGAN-GP train step and the synthesis
(serving) function — the port of ``tpgan_tpu/train/gan_trainer.py``.

The train step follows the JAX step (``gan_trainer.py:332-371``) one
phase at a time:

* D phase: a train-mode generator forward under ``torch.no_grad()`` (the
  counterpart of ``stop_gradient``), the critic on real images, on the
  fakes and on the GP interpolate, loss ``w_loss + 10 * gp``, one D
  optimizer step. Only the real-image pass advances the critic's
  BatchNorm statistics (``ops.blocks.frozen_batch_stats``).
* G phase, against the *updated* critic: the frontal ground-truth patches
  fused through ``ops.kernels.fuse_parts``, a second train-mode generator
  forward, the critic in train mode without advancing its statistics and
  without taking gradients, the composite loss, one G optimizer step.
* EMA of the generator weights, ``e * 0.99 + p * 0.01`` in f32, after the
  G update.

Gradients are taken with ``torch.autograd.grad`` with respect to one
model's parameters at a time, so the critic never accumulates gradients
from the G phase. All randomness of a step comes from one explicit
``torch.Generator``, in a fixed order: ``z ~ N(0, 1)`` (B, zdim), the GP
``eps ~ U[0, 1)`` (B, 1, 1, 1), then the D-phase and the G-phase dropout
keep-masks (B, 256). The step mutates the modules, the optimizers and
the state in place and returns the state.

Left out of this slice, raising ``NotImplementedError``: gradient
accumulation (``train.grad_accum_steps > 1``), rematerialisation
(``train.remat``) and ``make_multi_step`` (ROADMAP A4).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.losses.composite import generator_loss_components, total_generator_loss
from tpgan_tpu_torch.losses.gan import discriminator_loss, gradient_penalty
from tpgan_tpu_torch.models.discriminator import Discriminator
from tpgan_tpu_torch.models.generator import Generator, dropout_keep_mask
from tpgan_tpu_torch.ops.blocks import (
    BatchNorm2d,
    frozen_batch_stats,
    reset_parameters,
    set_compute_dtype,
)
from tpgan_tpu_torch.ops.kernels import fuse_parts
from tpgan_tpu_torch.train.optim import adam_wgan
from tpgan_tpu_torch.utils.device import resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ArrayLike = Union[torch.Tensor, np.ndarray]
Batch = Mapping[str, ArrayLike]
IdentityEmbedFn = Callable[[torch.Tensor], torch.Tensor]
PATCH_KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")
FRONTAL_PATCH_KEYS = ("left_eye_frontal", "right_eye_frontal", "nose_frontal", "mouth_frontal")
NOISE_KEYS = ("z", "gp_eps", "drop_mask_d", "drop_mask_g")


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


def build_models(
    cfg: Config, device: Optional[Union[str, torch.device]] = None, seed: int = 0
) -> Tuple[Generator, Discriminator]:
    """(Generator, Discriminator) for training: float32 parameters (the
    optimizer's masters) computing in ``cfg.compute_dtype``, as the JAX
    ``build_models`` does. The generator's weights come from ``seed`` (the
    same as :func:`build_generator`'s), the critic's from ``seed + 1``."""
    device = resolve_device(device)
    dtype = _DTYPES[cfg.compute_dtype]
    gen = build_generator(cfg, device, seed)
    disc = Discriminator(
        use_batchnorm=cfg.D.use_batchnorm, fm_multiplier=cfg.D.fm_multiplier, device=device
    )
    reset_parameters(disc, torch.Generator(device=device).manual_seed(seed + 1))
    return set_compute_dtype(gen, dtype), set_compute_dtype(disc, dtype)


def _running_stats(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {
        f"{name}.{buf}": getattr(m, buf)
        for name, m in module.named_modules()
        if isinstance(m, BatchNorm2d)
        for buf in ("running_mean", "running_var")
    }


@dataclasses.dataclass
class GANTrainState:
    """Step count, both models (their parameters and BatchNorm running
    statistics), both optimizers, and the generator's EMA weights (an
    empty dict when ``train.ema_decay`` is 0)."""

    step: int
    gen: Generator
    disc: Discriminator
    g_opt: torch.optim.Optimizer
    d_opt: torch.optim.Optimizer
    g_ema_params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @property
    def g_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.gen.named_parameters())

    @property
    def d_params(self) -> Dict[str, torch.Tensor]:
        return dict(self.disc.named_parameters())

    @property
    def g_batch_stats(self) -> Dict[str, torch.Tensor]:
        return _running_stats(self.gen)

    @property
    def d_batch_stats(self) -> Dict[str, torch.Tensor]:
        return _running_stats(self.disc)


def eval_g_params(state: GANTrainState, select: str = "auto") -> Dict[str, torch.Tensor]:
    """The generator weights inference and evaluation should use:
    ``auto`` the EMA copy when one is tracked, else the live weights;
    ``ema`` / ``live`` force one side (``ema`` raises when none is
    tracked)."""
    if select == "live":
        return state.g_params
    if select == "ema":
        if not state.g_ema_params:
            raise ValueError("the state tracks no EMA weights (train.ema_decay=0)")
        return state.g_ema_params
    if select != "auto":
        raise ValueError(f"select must be auto|ema|live, got {select!r}")
    return state.g_ema_params if state.g_ema_params else state.g_params


def example_batch(
    batch_size: int = 1, dtype: torch.dtype = torch.float32, device=None
) -> Dict[str, torch.Tensor]:
    """A zeros batch with the TrainDataset contract (NHWC images and
    patches, int32 labels), as the JAX ``example_batch``."""
    shapes = {
        "img": (128, 128), "img64": (64, 64), "img32": (32, 32),
        "img_frontal": (128, 128), "img64_frontal": (64, 64), "img32_frontal": (32, 32),
        "left_eye": (40, 40), "right_eye": (40, 40), "nose": (32, 40), "mouth": (32, 48),
        "left_eye_frontal": (40, 40), "right_eye_frontal": (40, 40),
        "nose_frontal": (32, 40), "mouth_frontal": (32, 48),
    }
    batch = {k: torch.zeros((batch_size, h, w, 3), dtype=dtype, device=device)
             for k, (h, w) in shapes.items()}
    batch["label"] = torch.zeros((batch_size,), dtype=torch.int32, device=device)
    return batch


def create_gan_state(
    cfg: Config, seed: int = 0, device: Optional[Union[str, torch.device]] = None
) -> Tuple[GANTrainState, Generator, Discriminator, torch.optim.Optimizer, torch.optim.Optimizer]:
    """(state, gen, disc, g_opt, d_opt) — the JAX ``create_gan_state``'s
    five, with seeded weights on ``device`` (``cuda`` unless asked
    otherwise) and ``adam_wgan`` for both models."""
    gen, disc = build_models(cfg, device, seed)
    t = cfg.train
    g_opt = adam_wgan(gen.parameters(), t.learning_rate, t.beta1, t.beta2)
    d_opt = adam_wgan(disc.parameters(), t.learning_rate, t.beta1, t.beta2)
    ema = (
        {n: p.detach().clone() for n, p in gen.named_parameters()}
        if float(t.ema_decay or 0.0) > 0 else {}
    )
    state = GANTrainState(step=0, gen=gen, disc=disc, g_opt=g_opt, d_opt=d_opt, g_ema_params=ema)
    return state, gen, disc, g_opt, d_opt


def decode_u8_batch(batch: Batch) -> Dict[str, Any]:
    """uint8 -> [-1, 1] as (2v - 255) / 255 in f32 (endpoint-exact: 0 ->
    -1, 255 -> 1); other leaves pass through unchanged."""

    def dec(x):
        if isinstance(x, np.ndarray) and x.dtype == np.uint8:
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor) and x.dtype == torch.uint8:
            return (2.0 * x.float() - 255.0) / 255.0
        return x

    return {k: dec(v) for k, v in batch.items()}


def _to_device_nchw(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in decode_u8_batch(batch).items():
        t = torch.as_tensor(v, device=device)
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet (ROADMAP A4: the step's remaining options)"
    )


def make_gan_train_step(
    cfg: Config,
    gen: Generator,
    disc: Discriminator,
    g_opt: torch.optim.Optimizer,
    d_opt: torch.optim.Optimizer,
    identity_embed: Optional[IdentityEmbedFn] = None,
):
    """The fused D+G train step ``train_step(state, batch, generator,
    noise=None) -> (state, metrics)``.

    ``batch``: the JAX step's NHWC dict (tensors or numpy arrays, float or
    uint8). ``generator``: a ``torch.Generator`` on the models' device, the
    step's only source of randomness. ``noise``: optional overrides of the
    draws, any of ``z``, ``gp_eps``, ``drop_mask_d``, ``drop_mask_g``
    (tests inject the JAX step's values). ``metrics``: JAX's keys, as 0-d
    device tensors (no host sync in the step)."""
    if int(cfg.train.grad_accum_steps or 1) > 1:
        raise _not_ported("train.grad_accum_steps > 1 (gradient accumulation)")
    if cfg.train.remat:
        raise _not_ported("train.remat (rematerialisation)")
    loss_cfg = cfg.loss
    zdim = cfg.G.zdim
    ema_decay = float(cfg.train.ema_decay or 0.0)
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())
    rate = gen.feature_predict.dropout
    feature_dim = gen.feature_predict.fc.weight.shape[1]

    def draws(b: int, device, generator, noise):
        noise = dict(noise or {})
        unknown = set(noise) - set(NOISE_KEYS)
        if unknown:
            raise ValueError(f"unknown noise keys {sorted(unknown)}; expected {NOISE_KEYS}")
        makers = {
            "z": lambda: torch.randn((b, zdim), generator=generator, device=device),
            "gp_eps": lambda: torch.rand((b, 1, 1, 1), generator=generator, device=device),
            "drop_mask_d": lambda: dropout_keep_mask((b, feature_dim), rate, generator, device),
            "drop_mask_g": lambda: dropout_keep_mask((b, feature_dim), rate, generator, device),
        }
        return [
            torch.as_tensor(noise[k], device=device) if k in noise else makers[k]()
            for k in NOISE_KEYS
        ]

    def g_forward(batch, z, mask):
        return gen(*(batch[k] for k in PATCH_KEYS), z, use_dropout=True, drop_mask=mask)

    def set_grads(params, loss):
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g

    def prepare(batch: Batch, generator: torch.Generator, noise=None):
        """(device NCHW batch, [z, gp_eps, drop_mask_d, drop_mask_g]); both
        models in train mode."""
        device = g_params[0].device
        batch = _to_device_nchw(batch, device)
        gen.train()
        disc.train()
        return batch, draws(batch["img"].shape[0], device, generator, noise)

    def d_phase(batch, z, gp_eps, mask_d) -> Dict[str, torch.Tensor]:
        """The critic's WGAN-GP loss; its gradients go to D's ``.grad``."""
        real = batch["img_frontal"]
        with torch.no_grad():
            fake = g_forward(batch, z, mask_d).img128_fake
        real_scores = disc(real)  # the only pass that advances D's BN stats
        with frozen_batch_stats(disc):
            fake_scores = disc(fake)
            gp = gradient_penalty(disc, real, fake, gp_eps.to(real.dtype))
        w_loss = discriminator_loss(real_scores, fake_scores)
        d_loss = w_loss + loss_cfg.weight_gradient_penalty * gp
        set_grads(d_params, d_loss)
        return {"d_loss": d_loss, "d_wasserstein": w_loss, "d_gradient_penalty": gp,
                "d_real_mean": real_scores.mean(), "d_fake_mean": fake_scores.mean()}

    def g_phase(batch, z, mask_g) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(G loss, its components) against the critic as it stands; the
        gradients go to G's ``.grad``."""
        with torch.no_grad():
            fused_frontal = fuse_parts(*(batch[k] for k in FRONTAL_PATCH_KEYS))
        out = g_forward(batch, z, mask_g)
        with frozen_batch_stats(disc):
            fake_scores_g = disc(out.img128_fake)
        comps = generator_loss_components(
            fake128=out.img128_fake,
            fake_scores=fake_scores_g,
            encoder_predict=out.encoder_predict,
            fused_local_fake=out.local_fake,
            fused_local_frontal=fused_frontal,
            gt128=batch["img_frontal"],
            gt64=batch["img64_frontal"],
            gt32=batch["img32_frontal"],
            labels=batch["label"],
            cfg=loss_cfg,
            identity_embed=identity_embed,
        )
        g_loss = total_generator_loss(comps, loss_cfg)
        set_grads(g_params, g_loss)
        return g_loss, comps

    def train_step(
        state: GANTrainState,
        batch: Batch,
        generator: torch.Generator,
        noise: Optional[Mapping[str, ArrayLike]] = None,
    ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        batch, (z, gp_eps, mask_d, mask_g) = prepare(batch, generator, noise)
        d_metrics = d_phase(batch, z, gp_eps, mask_d)  # critic update (WGAN-GP)
        d_opt.step()
        g_loss, comps = g_phase(batch, z, mask_g)  # generator update
        g_opt.step()

        if ema_decay > 0.0 and state.g_ema_params:
            ema = [state.g_ema_params[n] for n, _ in gen.named_parameters()]
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, g_params, alpha=1.0 - ema_decay)
        state.step += 1

        metrics = {"d_loss": d_metrics.pop("d_loss"), "g_loss": g_loss, **d_metrics}
        metrics.update({f"g_{k}": v for k, v in comps.items()})
        return state, {k: v.detach() for k, v in metrics.items()}

    # the step's parts, for running one phase alone (the first-step bisect,
    # tpgan_tpu_torch/examples/first_step_bisect.py)
    train_step.prepare, train_step.d_phase, train_step.g_phase = prepare, d_phase, g_phase
    return train_step


def make_multi_step(train_step, num_steps: int):
    """K steps per host dispatch (``lax.scan`` in JAX); on the card this
    becomes a CUDA-graph replay of the step, not yet ported."""
    raise _not_ported("make_multi_step (K steps per dispatch, a CUDA graph on the card)")


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
