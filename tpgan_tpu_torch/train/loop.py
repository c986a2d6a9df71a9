"""The GAN training loop — the port of ``tpgan_tpu/train/loop.py``
on one device: the fused WGAN-GP step (K steps per host call as a CUDA
graph on the card), metrics with images/s, NaN checks, sample grids, a
``torch.profiler`` trace over a step window, and checkpoints with resume.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.train.checkpoint import (
    finalize_checkpoints,
    latest_step,
    restore_gan_checkpoint,
    save_checkpoint,
)
from tpgan_tpu_torch.train.gan_trainer import (
    GANTrainState,
    IdentityEmbedFn,
    create_gan_state,
    make_gan_train_step,
    make_multi_step,
)
from tpgan_tpu_torch.train.metrics import MetricWriter, NaNMonitor, Throughput
from tpgan_tpu_torch.utils.device import resolve_device

PROFILE_TRACE = "trace.json"


def _stack(batches: List[Mapping]) -> dict:
    """K batches -> one super-batch with a leading (K, ...) axis."""
    out = {}
    for k in batches[0]:
        vals = [b[k] for b in batches]
        out[k] = (torch.stack([torch.as_tensor(v) for v in vals])
                  if isinstance(vals[0], torch.Tensor) else np.stack(vals))
    return out


def run_gan_training(
    cfg: Config,
    batches: Iterable,
    *,
    steps: int,
    identity_embed: Optional[IdentityEmbedFn] = None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    writer: Optional[MetricWriter] = None,
    log_every: int = 10,
    mesh=None,
    profile_dir: Optional[str] = None,
    profile_steps: tuple = (10, 15),
    steps_per_dispatch: int = 1,
    sample_fn=None,
    sample_every: Optional[int] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> GANTrainState:
    """Run train steps over ``batches`` (an iterable of batch dicts with
    the TrainDataset contract) until the GLOBAL step count reaches
    ``steps``, and return the final state (on the device).

    As in the JAX loop: ``steps`` is a global budget, so after a restore
    of step N the loop runs ``steps - N`` more and checkpoints continue the
    numbering; ``resume`` restores the newest checkpoint of
    ``checkpoint_dir`` when it has one, else ``train.resume_model`` names
    a checkpoint directory to start from. The step's ``torch.Generator``
    is seeded from ``train.seed`` at every start, as the JAX loop seeds
    its PRNG key.

    ``steps_per_dispatch`` = K > 1 stacks K batches and runs K steps per
    host call (``make_multi_step``: a CUDA graph on the card); metrics
    report the last step of each call. Every ``log_every`` steps the
    ``writer`` gets that step's metrics plus ``imgs_per_sec`` (after a
    NaN check, which raises ``FloatingPointError``); ``sample_fn(step,
    state)`` runs every ``sample_every`` steps; an asynchronous checkpoint
    is written every ``train.checkpoint_every_steps`` and a blocking one
    at the end. ``profile_dir``: a ``torch.profiler`` trace
    (``<profile_dir>/trace.json``) from step ``profile_steps[0]`` to
    ``profile_steps[1]`` of this run.

    ``device``: ``cuda`` unless asked otherwise. ``mesh`` is the JAX
    loop's data-parallel mesh; the port runs on one device until DDP is
    ported (ROADMAP A12), and raises when one is given."""
    if mesh is not None:
        raise NotImplementedError(
            "run_gan_training runs on one device; data parallelism over a mesh waits for "
            "the port of parallel/ (ROADMAP A12)")
    device = resolve_device(device)
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, cfg.train.seed, device)
    if resume and checkpoint_dir and latest_step(checkpoint_dir) is not None:
        state = restore_gan_checkpoint(checkpoint_dir, state)
    elif cfg.train.resume_model:
        state = restore_gan_checkpoint(cfg.train.resume_model, state)
    start_step = int(state.step)
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)

    base_step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, identity_embed)
    k = max(int(steps_per_dispatch), 1)
    step_fn = make_multi_step(base_step, k) if k > 1 else base_step

    monitor = NaNMonitor()
    throughput = Throughput()
    throughput.start()
    profiler = None
    i = start_step
    batch_iter = iter(batches)
    for batch in batch_iter:
        if i >= steps:
            break
        if profile_dir is not None and profiler is None and i - start_step >= profile_steps[0] \
                and i - start_step < profile_steps[1]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        images = int(np.shape(batch["img"])[0]) * k
        if k > 1:
            stack = [batch]
            for _ in range(k - 1):
                nxt = next(batch_iter, None)
                if nxt is None:
                    break
                stack.append(nxt)
            if len(stack) < k:
                break  # not enough batches for a full dispatch
            batch = _stack(stack)
        state, metrics = step_fn(state, batch, generator)
        if k > 1:
            metrics = {name: m[-1] for name, m in metrics.items()}
        throughput.count(images)
        i += k
        if profiler is not None and i - start_step >= profile_steps[1]:
            _stop_profile(profiler, profile_dir, device)
            profiler = None
        if writer is not None and i % log_every == 0:
            monitor.check(i, metrics)
            host = dict(metrics)
            host["imgs_per_sec"] = throughput.rate(metrics["g_loss"])
            writer.write(i, host)
            throughput.start()
        if sample_fn is not None and sample_every and i % sample_every == 0:
            sample_fn(i, state)
        if (checkpoint_dir and cfg.train.checkpoint_every_steps
                and i % cfg.train.checkpoint_every_steps == 0):
            # copied to the host now, written in the background; ``i`` is
            # the global step, so saves after a resume continue the numbering
            save_checkpoint(checkpoint_dir, i, state, block=False)
    if profiler is not None:
        _stop_profile(profiler, profile_dir, device)

    if checkpoint_dir:
        finalize_checkpoints(checkpoint_dir)
        if latest_step(checkpoint_dir) != int(state.step):
            save_checkpoint(checkpoint_dir, int(state.step), state)
    return state


def _stop_profile(profiler, profile_dir: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, PROFILE_TRACE))
