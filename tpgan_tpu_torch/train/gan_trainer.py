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
from the G phase; they are set as ``.grad`` (copied into fixed buffers
once the optimizers are capturable, for a CUDA graph). All
randomness of a step comes from one explicit ``torch.Generator``, in a
fixed order: ``z ~ N(0, 1)``, the GP ``eps ~ U[0, 1)``, then the D-phase
and the G-phase dropout keep-masks (256 features per image). The step
mutates the modules, the optimizers and the state in place and returns
the state.

The step's options, as in the JAX step (``gan_trainer.py:232-260,
372-484``): ``train.grad_accum_steps`` splits the batch into sequential
microbatches whose gradients are summed and averaged before each
update; ``train.remat`` recomputes the generator's and/or the critic's
activations in the backward pass (``torch.utils.checkpoint``).
:func:`make_multi_step` runs K steps per host call, as a CUDA graph on
the card, and :func:`make_graphed_synthesize_fn` the synthesis forward.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.losses.composite import generator_loss_components, total_generator_loss
from tpgan_tpu_torch.losses.gan import discriminator_loss, gradient_penalty
from tpgan_tpu_torch.models.discriminator import Discriminator
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.ops.blocks import (
    DTYPES,
    BatchNorm2d,
    compute_copy,
    dropout_keep_mask,
    frozen_batch_stats,
    reset_parameters,
    set_compute_dtype,
    sync_batch_stats,
)
from tpgan_tpu_torch.ops.kernels import fuse_parts
from tpgan_tpu_torch.ops.quant import SYNTHESIS_KEYS, make_int8_model
from tpgan_tpu_torch.parallel.collectives import all_reduce_metrics
from tpgan_tpu_torch.parallel.mesh import data_group
from tpgan_tpu_torch.parallel.sharding import mean_gradients_, metrics_group
from tpgan_tpu_torch.train.optim import adam_wgan, make_capturable
from tpgan_tpu_torch.utils import graphs, trace
from tpgan_tpu_torch.utils.device import resolve_device

ArrayLike = Union[torch.Tensor, np.ndarray]
Batch = Mapping[str, ArrayLike]
IdentityEmbedFn = Callable[[torch.Tensor], torch.Tensor]
PATCH_KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")
FRONTAL_PATCH_KEYS = ("left_eye_frontal", "right_eye_frontal", "nose_frontal", "mouth_frontal")
NOISE_KEYS = ("z", "gp_eps", "drop_mask_d", "drop_mask_g")
REMAT_SCOPES = ("generator", "critic", "both")
# Eager calls on a side stream before a CUDA-graph capture: the first
# builds what is made on first use, the second runs with all of it in place.
GRAPH_WARMUP_CALLS = 2


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
    dtype = DTYPES[cfg.compute_dtype]
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
    """uint8 -> [-1, 1] as (2v - 255) / 255 in f32, correctly rounded on
    every device (endpoint-exact: 0 -> -1, 255 -> 1); other leaves pass
    through unchanged."""

    def dec(x):
        if isinstance(x, np.ndarray) and x.dtype == np.uint8:
            x = torch.from_numpy(x)
        if isinstance(x, torch.Tensor) and x.dtype == torch.uint8:
            # the divisor is a tensor on x's device: CUDA divides by a CPU
            # scalar as a product with its reciprocal, which is one ulp
            # off (2v - 255) / 255 for some v
            return (2.0 * x.float() - 255.0) / torch.full((), 255.0, device=x.device)
        return x

    return {k: dec(v) for k, v in batch.items()}


def _to_device(x: ArrayLike, device: torch.device) -> torch.Tensor:
    """The host-to-device copy of one batch leaf."""
    return torch.as_tensor(x, device=device)


def _to_device_nchw(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """Each leaf to ``device`` as it is, then uint8 decoded there: a uint8
    batch crosses to the card as uint8, a quarter of its f32 bytes, as
    the JAX step decodes inside the jitted step."""
    moved = {k: _to_device(v, device) for k, v in batch.items()}
    out = {}
    for k, t in decode_u8_batch(moved).items():
        out[k] = t.permute(0, 3, 1, 2).contiguous() if t.dim() == 4 else t
    return out


class _FrozenForRecompute:
    """``frozen_batch_stats(module)`` as a context that can be entered
    again, once per recompute (a double backward recomputes twice)."""

    def __init__(self, module: torch.nn.Module):
        self.module = module
        self._open: List[Any] = []

    def __enter__(self) -> None:
        frozen = frozen_batch_stats(self.module)
        frozen.__enter__()
        self._open.append(frozen)

    def __exit__(self, *exc) -> None:
        self._open.pop().__exit__(*exc)


def _remat(module: torch.nn.Module, fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` (a forward of ``module``) under ``torch.utils.checkpoint``:
    its activations are recomputed in the backward pass instead of kept.
    The recompute advances no BatchNorm running statistics (the port's
    BatchNorm advances them inside ``forward``; JAX's functional remat
    never advances them twice) and draws no random numbers (the step's
    draws are explicit tensors), so it keeps no RNG state."""

    def contexts():
        return contextlib.nullcontext(), _FrozenForRecompute(module)

    def run(*args, **kwargs):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                          context_fn=contexts, **kwargs)

    return run


def make_gan_train_step(
    cfg: Config,
    gen: Generator,
    disc: Discriminator,
    g_opt: torch.optim.Optimizer,
    d_opt: torch.optim.Optimizer,
    identity_embed: Optional[IdentityEmbedFn] = None,
    mesh=None,
):
    """The fused D+G train step ``train_step(state, batch, generator,
    noise=None) -> (state, metrics)``.

    ``batch``: the JAX step's NHWC dict (tensors or numpy arrays, float or
    uint8). ``generator``: a ``torch.Generator`` on the models' device, the
    step's only source of randomness. ``noise``: optional overrides of the
    draws, any of ``z``, ``gp_eps``, ``drop_mask_d``, ``drop_mask_g``
    (tests inject the JAX step's values); with gradient accumulation each
    takes a leading ``(accum, ...)`` axis, one entry per microbatch.
    ``metrics``: JAX's keys, as 0-d device tensors (no host sync in the
    step); with accumulation, the mean over the microbatches.

    ``train.grad_accum_steps`` = n > 1 (JAX ``accum_train_step``): the
    batch splits into n sequential microbatches, each with its own z, GP
    eps and dropout masks; the critic's gradients are summed in f32 over
    them and divided by n, then one D update; the generator's, against the
    updated critic, likewise, then one G update. G's BatchNorm statistics
    advance through both loops in turn, D's through the D loop. Raises
    ``ValueError`` when n does not divide the batch.

    ``train.remat`` (``remat_scope`` generator, critic or both): the
    train-mode generator forward of the G phase and/or every critic apply
    (the GP's double backward included) recompute their activations in the
    backward pass. Gradients and statistics are those of the plain step.
    At this granularity (the whole forward in one checkpoint, as JAX's
    ``jax.checkpoint(g_forward)``) it saves no memory at batch 16: on the
    H100 80GB HBM3 at 700 W the full-size bf16 step peaks at 5.65-5.66
    GiB with ``both`` against 5.63-5.64 GiB without (``chip_smoke.py``
    phase 12, ``PERF.md`` §6). A remat per block is ROADMAP A16.

    ``mesh`` (``parallel.make_mesh``): the step of JAX's ``data``-sharded
    step, one per rank. ``batch`` is then this rank's rows of the global
    batch (``mesh.rows``); every rank draws the global z, GP eps and
    dropout masks from its generator (the same seed on every rank) and
    keeps its rows, and ``noise`` holds global arrays, so N ranks compute
    the step of one process at the global batch. Each phase's gradient
    mean and the metrics are all-reduced (the metrics are global means),
    and with more than one rank every train-mode BatchNorm takes the
    global batch's statistics (``ops.blocks.sync_batch_stats``). With
    accumulation, microbatch i is every rank's i-th local microbatch (the
    global batch's rows in another order than JAX's contiguous split,
    which GSPMD reshuffles across the ranks). On a mesh with a model axis
    the ranks of a model group see the same rows and draws and hold
    slices of the weights ``place(state, shard_gan_state(mesh, state))``
    sharded: the sharded layers gather or sum over the model group
    (``parallel.tensor_parallel``), each rank's Adam and EMA update act on
    its slices, the noise rows and the synced BatchNorm are the data
    group's, a sharded weight's gradient is averaged over its data group,
    and the replicated leaves' gradients and the metrics over the whole
    mesh (``parallel.sharding.mean_gradients_``: the model ranks' replicas
    stay equal where the card's kernels differ in the last bit).
    """
    loss_cfg = cfg.loss
    zdim = cfg.G.zdim
    ema_decay = float(cfg.train.ema_decay or 0.0)
    accum = max(int(cfg.train.grad_accum_steps or 1), 1)
    remat_scope = str(cfg.train.remat_scope or "generator")
    if cfg.train.remat and remat_scope not in REMAT_SCOPES:
        raise ValueError(
            f"train.remat_scope={remat_scope!r}: expected 'generator' | 'critic' | 'both'"
        )
    remat_gen = bool(cfg.train.remat) and remat_scope in ("generator", "both")
    remat_critic = bool(cfg.train.remat) and remat_scope in ("critic", "both")
    g_params = list(gen.parameters())
    d_params = list(disc.parameters())
    rate = gen.feature_predict.dropout
    feature_dim = gen.feature_predict.fc.in_features
    critic = _remat(disc, disc) if remat_critic else disc
    _group, rank, ranks = data_group(mesh)
    metric_group = metrics_group(mesh)
    sync_batch_stats(gen, mesh)
    sync_batch_stats(disc, mesh)

    def draws(b: int, device, generator, noise):
        """[z, gp_eps, drop_mask_d, drop_mask_g], each (accum, b / accum, ...):
        on a mesh, this rank's rows of the global draws."""
        noise = dict(noise or {})
        unknown = set(noise) - set(NOISE_KEYS)
        if unknown:
            raise ValueError(f"unknown noise keys {sorted(unknown)}; expected {NOISE_KEYS}")
        m = b * ranks // accum
        makers = {
            "z": lambda: torch.randn((accum, m, zdim), generator=generator, device=device),
            "gp_eps": lambda: torch.rand((accum, m, 1, 1, 1), generator=generator, device=device),
            "drop_mask_d": lambda: dropout_keep_mask((accum, m, feature_dim), rate, generator, device),
            "drop_mask_g": lambda: dropout_keep_mask((accum, m, feature_dim), rate, generator, device),
        }
        out = []
        for k in NOISE_KEYS:
            if k not in noise:
                out.append(makers[k]())
                continue
            given = torch.as_tensor(noise[k], device=device)
            out.append(given.unsqueeze(0) if accum == 1 else given)
        if ranks > 1:
            local = m // ranks
            out = [d[:, rank * local:(rank + 1) * local] for d in out]
        return out

    def g_forward(batch, z, mask):
        return gen(*(batch[k] for k in PATCH_KEYS), z, use_dropout=True, drop_mask=mask)

    g_forward_grad = _remat(gen, g_forward) if remat_gen else g_forward

    def set_grads(params, opt, loss, accumulate: bool = False):
        """The gradients of ``loss`` into the parameters' ``.grad``: added
        to it with ``accumulate``; else assigned, or, when ``opt`` is
        capturable (``optim.make_capturable``: a CUDA graph replays the
        addresses it captured), copied into fixed buffers made once. A
        parameter the loss does not reach gets 0."""
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        if accumulate:
            used = [(p.grad, g) for p, g in zip(params, grads) if g is not None]
            torch._foreach_add_([b for b, _ in used], [g for _, g in used])
            return
        if not opt.param_groups[0].get("capturable", False):
            for p, g in zip(params, grads):
                p.grad = torch.zeros_like(p) if g is None else g
            return
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        used = [(p.grad, g) for p, g in zip(params, grads) if g is not None]
        torch._foreach_copy_([b for b, _ in used], [g for _, g in used])
        unused = [p.grad for p, g in zip(params, grads) if g is None]
        if unused:
            torch._foreach_zero_(unused)

    def prepare(batch: Batch, generator: torch.Generator, noise=None):
        """(device NCHW batch, [z, gp_eps, drop_mask_d, drop_mask_g]); both
        models in train mode. The draws are (B, ...) in the plain step and
        (accum, B / accum, ...) with accumulation."""
        device = g_params[0].device
        batch = _to_device_nchw(batch, device)
        b = batch["img"].shape[0]
        if b % accum:
            raise ValueError(f"train.grad_accum_steps={accum} must divide the batch size {b}")
        gen.train()
        disc.train()
        noise_draws = draws(b, device, generator, noise)
        return batch, [d[0] for d in noise_draws] if accum == 1 else noise_draws

    def d_phase(batch, z, gp_eps, mask_d, accumulate: bool = False) -> Dict[str, torch.Tensor]:
        """The critic's WGAN-GP loss on one (micro)batch; its gradients go
        to D's ``.grad`` (added to it with ``accumulate``)."""
        real = batch["img_frontal"]
        with torch.no_grad():
            fake = g_forward(batch, z, mask_d).img128_fake
        real_scores = critic(real)  # the only pass that advances D's BN stats
        with frozen_batch_stats(disc):
            fake_scores = critic(fake)
            gp = gradient_penalty(critic, real, fake, gp_eps.to(real.dtype))
        w_loss = discriminator_loss(real_scores, fake_scores)
        d_loss = w_loss + loss_cfg.weight_gradient_penalty * gp
        set_grads(d_params, d_opt, d_loss, accumulate)
        return {"d_loss": d_loss, "d_wasserstein": w_loss, "d_gradient_penalty": gp,
                "d_real_mean": real_scores.mean(), "d_fake_mean": fake_scores.mean()}

    def g_phase(batch, z, mask_g, accumulate: bool = False
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(G loss, its components) on one (micro)batch against the critic
        as it stands; the gradients go to G's ``.grad`` (added to it with
        ``accumulate``)."""
        with torch.no_grad():
            fused_frontal = fuse_parts(*(batch[k] for k in FRONTAL_PATCH_KEYS))
        out = g_forward_grad(batch, z, mask_g)
        with frozen_batch_stats(disc):
            fake_scores_g = critic(out.img128_fake)
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
        set_grads(g_params, g_opt, g_loss, accumulate)
        return g_loss, comps

    def average_grads(module) -> None:
        """The mean over the microbatches and, on a mesh, over the ranks
        (``parallel.sharding.mean_gradients_``: a sharded weight's over
        its data group, a replicated leaf's over the whole mesh)."""
        if accum > 1:
            torch._foreach_div_([p.grad for p in module.parameters()], float(accum))
        mean_gradients_(module, mesh)

    def mean(values: List[torch.Tensor]) -> torch.Tensor:
        return values[0] if len(values) == 1 else torch.stack(values).mean(0)

    def train_step(
        state: GANTrainState,
        batch: Batch,
        generator: torch.Generator,
        noise: Optional[Mapping[str, ArrayLike]] = None,
    ) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        batch, (z, gp_eps, mask_d, mask_g) = prepare(batch, generator, noise)
        if accum == 1:
            micro = [batch]
            z, gp_eps, mask_d, mask_g = ([t] for t in (z, gp_eps, mask_d, mask_g))
        else:
            m = batch["img"].shape[0] // accum
            micro = [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(accum)]

        # critic update (WGAN-GP), over the microbatches in turn
        d_runs = [d_phase(mb, z[i], gp_eps[i], mask_d[i], accumulate=i > 0)
                  for i, mb in enumerate(micro)]
        average_grads(disc)
        d_opt.step()
        # generator update, against the updated critic
        g_runs = [g_phase(mb, z[i], mask_g[i], accumulate=i > 0) for i, mb in enumerate(micro)]
        average_grads(gen)
        g_opt.step()

        if ema_decay > 0.0 and state.g_ema_params:
            ema = [state.g_ema_params[n] for n, _ in gen.named_parameters()]
            with torch.no_grad():
                torch._foreach_mul_(ema, ema_decay)
                torch._foreach_add_(ema, g_params, alpha=1.0 - ema_decay)
        state.step += 1

        d_metrics = {k: mean([r[k] for r in d_runs]) for k in d_runs[0]}
        metrics = {"d_loss": d_metrics.pop("d_loss"), "g_loss": mean([r[0] for r in g_runs]),
                   **d_metrics}
        metrics.update({f"g_{k}": mean([r[1][k] for r in g_runs]) for k in g_runs[0][1]})
        if metric_group is not None:  # the global means
            return state, all_reduce_metrics(metrics, metric_group)
        return state, {k: v.detach() for k, v in metrics.items()}

    # the step's parts, for running one phase alone (the first-step bisect,
    # tpgan_tpu_torch/examples/first_step_bisect.py)
    train_step.prepare, train_step.d_phase, train_step.g_phase = prepare, d_phase, g_phase
    train_step.mesh = mesh
    return train_step


def _stack(history: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([m[k] for m in history]) for k in history[0]}


def _written_tensors(state: GANTrainState) -> List[torch.Tensor]:
    """Every tensor a train step writes: both models' parameters, their
    ``.grad`` buffers and BatchNorm buffers, the EMA weights and both
    optimizers' state."""
    params = [*state.gen.parameters(), *state.disc.parameters()]
    out = [*params, *(p.grad for p in params if p.grad is not None),
           *state.gen.buffers(), *state.disc.buffers(), *state.g_ema_params.values()]
    for opt in (state.g_opt, state.d_opt):
        for per_param in opt.state.values():
            out.extend(v for v in per_param.values() if torch.is_tensor(v))
    return out


def make_multi_step(train_step, num_steps: int):
    """K = ``num_steps`` train steps per host call — JAX's ``lax.scan``
    over the step (``gan_trainer.py:487-510``).

    ``multi_step(state, super_batch, generator) -> (state, metrics)``:
    ``super_batch`` holds the step's batch keys with a leading (K, ...)
    axis; ``metrics`` are the step's, stacked over the K steps. The step
    count advances by K.

    On the card the step is a CUDA graph, captured at the first call and
    replayed K times per call, each batch first copied into the graph's
    input buffers. The capture makes both optimizers capturable
    (``optim.make_capturable``), for good: an eager step held against the
    replays is built the same way. Before the capture, warm-up steps run
    on a side stream and are then undone: the state's tensors, the
    generator's state and the step count are put back as they were. The
    graph keeps the state's tensors and ``generator``: a later call must
    pass the same state and generator and batches of the same shapes, and
    a state whose tensors were replaced since (an optimizer's
    ``load_state_dict``, for one) makes it raise, as does a failed
    capture; nothing falls back to eager steps. Replays add nothing to
    ``ops.kernels.launch_counts``; ``multi_step.launches()`` is the
    capture's record of one replay. On the card a call is the span
    ``graph.dispatch`` (``utils.trace``). On the CPU it runs K eager steps
    (the plain form).

    A step over a mesh (``make_gan_train_step(mesh=...)``) captures its
    NCCL all-reduces in the graph. Over gloo it raises: gloo's
    collectives go through the host, where a CUDA graph cannot hold them,
    and K eager steps in their place would be another program than the
    one asked for."""
    if num_steps < 1:
        raise ValueError(f"make_multi_step needs num_steps >= 1, got {num_steps}")
    mesh = getattr(train_step, "mesh", None)
    if mesh is not None and mesh.backend == "gloo":
        raise RuntimeError(
            "make_multi_step captures its K steps as one CUDA graph, which cannot hold gloo's "
            "host-staged collectives: use an NCCL group, or one step per dispatch")
    captured: Dict[str, Any] = {}

    def split(super_batch: Batch) -> List[Dict[str, torch.Tensor]]:
        batch = {k: torch.as_tensor(v) for k, v in super_batch.items()}
        lead = {v.shape[0] for v in batch.values()}
        if lead != {num_steps}:
            raise ValueError(f"the super-batch's leading axes {sorted(lead)} != num_steps "
                             f"{num_steps}")
        return [{k: v[i] for k, v in batch.items()} for i in range(num_steps)]

    def capture(state, first: Dict[str, torch.Tensor], generator):
        device = next(state.gen.parameters()).device
        make_capturable(state.g_opt)
        make_capturable(state.d_opt)
        inputs = {k: v.to(device, copy=True) for k, v in first.items()}
        # detached copies: a clone that autograd records would keep each
        # parameter's AccumulateGrad node alive on this stream through the
        # capture, which the capture cannot take
        with torch.no_grad():
            saved = [(t, t.clone()) for t in _written_tensors(state)]
        rng, step = generator.get_state(), state.step

        def reset():
            kept = {id(t): copy for t, copy in saved}
            with torch.no_grad():
                for t in _written_tensors(state):
                    if id(t) in kept:
                        t.copy_(kept[id(t)])
                    else:  # made by the warm-up: Adam's moments and count, .grad
                        t.zero_()
            generator.set_state(rng)
            state.step = step

        graph, (_state, metrics), launches = graphs.capture(
            lambda: train_step(state, inputs, generator), GRAPH_WARMUP_CALLS, reset, (generator,))
        state.step = step
        captured.update(graph=graph, metrics=metrics, launches=launches, inputs=inputs,
                        state=state, generator=generator,
                        ptrs=[t.data_ptr() for t in _written_tensors(state)])

    def multi_step(state: GANTrainState, super_batch: Batch, generator: torch.Generator):
        if next(state.gen.parameters()).device.type != "cuda":
            history = []
            for batch in split(super_batch):
                state, metrics = train_step(state, batch, generator)
                history.append(metrics)
            return state, _stack(history)
        with trace.span("graph.dispatch"):
            return run_graph(state, split(super_batch), generator)

    def run_graph(state: GANTrainState, batches: List[Dict[str, torch.Tensor]],
                  generator: torch.Generator):
        if not captured:
            capture(state, batches[0], generator)
        c = captured
        if state is not c["state"] or generator is not c["generator"]:
            raise ValueError("a captured multi-step replays the state and generator it was "
                             "captured with; build a new one for another")
        if [t.data_ptr() for t in _written_tensors(state)] != c["ptrs"]:
            raise RuntimeError("the state's tensors were replaced since the capture (a restore "
                               "or a new optimizer state); build a new multi-step")
        shapes = {k: (v.shape, v.dtype) for k, v in c["inputs"].items()}
        if {k: (v.shape, v.dtype) for k, v in batches[0].items()} != shapes:
            raise ValueError(f"batch shapes differ from the captured ones {shapes}")
        history = []
        for batch in batches:
            for k, buf in c["inputs"].items():
                buf.copy_(batch[k], non_blocking=True)
            c["graph"].replay()
            history.append({k: v.clone() for k, v in c["metrics"].items()})
        state.step += num_steps
        return state, _stack(history)

    # the graph's launches per replay (``ops.kernels.CapturedLaunches``),
    # once captured
    multi_step.launches = lambda: captured["launches"].per_replay if captured else None
    return multi_step

def make_synthesize_fn(
    cfg: Config, gen: Generator
) -> Callable[[Mapping[str, ArrayLike], ArrayLike], torch.Tensor]:
    """Inference: profile image + patches + noise -> frontalized face.

    ``synthesize(batch, z)`` takes the JAX function's NHWC batch dict
    (``img``, ``left_eye``, ``right_eye``, ``nose``, ``mouth``; tensors or
    numpy arrays) and ``z`` (B, zdim), and returns ``img128_fake`` as an
    NHWC (B, 128, 128, 3) tensor in ``cfg.compute_dtype`` on ``gen``'s
    device (``synthesize.device``). Eval mode, no dropout, no autograd.
    When the compute dtype is not float32 the weights are cast once, into
    a copy made here: later changes to ``gen`` do not reach the returned
    function.
    """
    dtype = DTYPES[cfg.compute_dtype]
    return synthesize_fn_of(gen if dtype == torch.float32 else compute_copy(gen, dtype))


def synthesize_fn_of(model: Generator) -> Callable[[Mapping[str, ArrayLike], ArrayLike],
                                                   torch.Tensor]:
    """:func:`make_synthesize_fn`'s function over ``model`` as it is (put
    in eval mode here): its weights' dtype is the compute dtype. The int8
    synthesis (:func:`make_int8_synthesize_fn`) passes its quantized
    copy. ``synthesize.model`` is ``model``."""
    device = next(model.parameters()).device
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

    synthesize.device = device  # where it runs: make_synthesis_pipeline's inputs go there
    synthesize.model = model
    return synthesize


def make_graphed_synthesize_fn(
    cfg: Config, gen: Generator
) -> Callable[[Mapping[str, ArrayLike], ArrayLike], torch.Tensor]:
    """:func:`make_synthesize_fn`'s function with the same contract, each
    forward one CUDA-graph replay on the card: the graph is captured at the
    first call of each batch shape (after warm-up calls on a side stream),
    and every call copies its inputs into that graph's buffers, replays it
    and returns a copy of its output. A failed capture raises; nothing
    falls back to eager calls. On the CPU it is the eager function (the
    plain form). The counterpart of the JAX bench's jitted ``lax.scan``
    of synthesis forwards (``bench.py:85-164``)."""
    return graph_synthesize_fn(make_synthesize_fn(cfg, gen))


def graph_synthesize_fn(synthesize: Callable[[Mapping[str, ArrayLike], ArrayLike], torch.Tensor]
                        ) -> Callable[[Mapping[str, ArrayLike], ArrayLike], torch.Tensor]:
    """A synthesis function (:func:`synthesize_fn_of`'s contract) as CUDA-graph
    replays, one graph per batch shape (:func:`make_graphed_synthesize_fn`);
    the function itself on the CPU."""
    if synthesize.device.type != "cuda":
        return synthesize
    replay = graphs.graphed_per_shape(
        lambda *args: synthesize(dict(zip(SYNTHESIS_KEYS, args[:-1])), args[-1]),
        synthesize.device, GRAPH_WARMUP_CALLS)

    def graphed(batch: Mapping[str, ArrayLike], z: ArrayLike) -> torch.Tensor:
        return replay(*(batch[k] for k in SYNTHESIS_KEYS), z)

    # {batch size: the launches of one replay}, for each captured shape
    graphed.launches = lambda: {key[0][0][0]: launches
                                for key, launches in replay.launches().items()}
    graphed.device, graphed.model = synthesize.device, synthesize.model
    return graphed


def make_int8_synthesize_fn(cfg: Config, gen: Generator, quant_scales: Mapping[str, Any],
                            rescale_dtype: Optional[torch.dtype] = None,
                            min_channels: Optional[int] = None
                            ) -> Callable[[Mapping[str, ArrayLike], ArrayLike], torch.Tensor]:
    """The int8 twin of :func:`make_synthesize_fn` (``tpgan_tpu/ops/quant.py``'s
    ``make_int8_synthesize_fn``), with its contract: ``synthesize(batch,
    z)`` returns the NHWC ``img128_fake`` in ``cfg.compute_dtype`` on
    ``gen``'s device, every quantized conv int8 x int8 -> int32 with the
    calibrated ``quant_scales`` (``ops.quant.calibrate_synthesis``'s, or
    JAX's through ``convert.jax_quant_scales_to_port``). The weights are
    quantized once, here, into a copy (``ops.quant.make_int8_model``).
    ``rescale_dtype`` / ``min_channels``: see ``ops.quant.quant_config``.
    The three fuses run the port's kernel on the card. A generator with
    BatchNorm raises."""
    return synthesize_fn_of(make_int8_model(cfg, gen, quant_scales, rescale_dtype, min_channels))


def make_graphed_int8_synthesize_fn(cfg: Config, gen: Generator, quant_scales: Mapping[str, Any],
                                    rescale_dtype: Optional[torch.dtype] = None,
                                    min_channels: Optional[int] = None
                                    ) -> Callable[[Mapping[str, ArrayLike], ArrayLike],
                                                  torch.Tensor]:
    """:func:`make_int8_synthesize_fn`'s function as one CUDA-graph replay
    per forward (:func:`graph_synthesize_fn`); the eager function on the
    CPU."""
    return graph_synthesize_fn(
        make_int8_synthesize_fn(cfg, gen, quant_scales, rescale_dtype, min_channels))
