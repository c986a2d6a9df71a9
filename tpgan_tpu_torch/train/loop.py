"""The GAN training loop — the port of ``tpgan_tpu/train/loop.py``: the
fused WGAN-GP step (K steps per host call as a CUDA graph on the card),
data- and tensor-parallel over the ranks of a (data, model) mesh, metrics
with images/s, NaN checks, sample grids, a ``torch.profiler`` trace over a
step window, and checkpoints with resume.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.parallel import batch_shardings, make_mesh, place, shard_gan_state
from tpgan_tpu_torch.parallel.distributed import is_main_process, maybe_initialize
from tpgan_tpu_torch.parallel.tensor_parallel import unsharded_copy
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

    ``device``: ``cuda`` (the rank's own card) unless asked otherwise.

    ``mesh`` (``parallel.make_mesh``): data and tensor parallelism over
    its ranks, one process each, as JAX's loop shards over its mesh; when
    it is None and ``parallel.distributed.maybe_initialize()`` finds a
    process group, the mesh is built from ``cfg.mesh``, as JAX's loop
    always builds one. ``train.batch_size`` is the global batch.
    ``batches`` yields global batches, of which each rank keeps its data
    index's rows (sliced where they lie, before the copy to its device),
    or each rank's own rows (a sharded iterator:
    ``data.pipeline.batch_iterator(shard=mesh.data_shard)``). Every rank
    builds, or restores, the whole state and then takes rank 0's values
    and, on a model axis of more than one rank, its slice of each leaf
    JAX's rule shards (``place(state, shard_gan_state(mesh, state))``, as
    JAX's ``loop.py:79``); the step all-reduces its gradients and metrics
    over the data group (``make_gan_train_step(mesh=)``), so every rank's
    NaN check sees the global metrics and raises with the others. Rank 0
    alone writes metrics, samples (from a whole copy of the generator that
    every rank of a model axis helps gather), traces and checkpoints
    (gathered whole); every rank waits at a barrier after each checkpoint
    until it is on disk. ``imgs_per_sec`` counts the global batch."""
    if mesh is None and maybe_initialize():
        mesh = make_mesh(cfg.mesh)
    main = mesh is None or is_main_process()
    device = resolve_device(device)
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, cfg.train.seed, device)
    if resume and checkpoint_dir and latest_step(checkpoint_dir) is not None:
        state = restore_gan_checkpoint(checkpoint_dir, state)
    elif cfg.train.resume_model:
        state = restore_gan_checkpoint(cfg.train.resume_model, state)
    start_step = int(state.step)
    # the same on every rank (a rank that read the directory after rank 0's
    # next write would skip the barrier that write's readers wait at)
    saved_step = latest_step(checkpoint_dir) if checkpoint_dir else None
    generator = torch.Generator(device=device).manual_seed(cfg.train.seed)
    global_batch = int(cfg.train.batch_size)
    shard = None
    if mesh is not None:
        place(state, shard_gan_state(mesh, state))
        mesh.rows(global_batch)  # raises when the data axis does not divide the batch

        def shard(batch):
            if int(np.shape(batch["img"])[0]) != global_batch:
                return batch  # already this rank's rows
            return place(batch, batch_shardings(mesh, batch, cfg.mesh.data_axis))

    base_step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, identity_embed, mesh=mesh)
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
        if profile_dir is not None and main and profiler is None \
                and profile_steps[0] <= i - start_step < profile_steps[1]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()
        if shard is not None:
            batch = shard(batch)
        images = int(np.shape(batch["img"])[0]) * (mesh.size if mesh is not None else 1) * k
        if k > 1:
            stack = [batch]
            for _ in range(k - 1):
                nxt = next(batch_iter, None)
                if nxt is None:
                    break
                stack.append(nxt if shard is None else shard(nxt))
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
        if (writer is not None or mesh is not None) and i % log_every == 0:
            monitor.check(i, metrics)  # global metrics: every rank raises together
            if writer is not None and main:
                host = dict(metrics)
                host["imgs_per_sec"] = throughput.rate(metrics["g_loss"])
                writer.write(i, host)
                throughput.start()
        if sample_fn is not None and sample_every and i % sample_every == 0:
            if mesh is not None and mesh.model_size > 1:  # every rank gathers
                whole_gen = unsharded_copy(state.gen)
                if main:
                    sample_fn(i, dataclasses.replace(state, gen=whole_gen))
                del whole_gen
            elif main:
                sample_fn(i, state)
        if (checkpoint_dir and cfg.train.checkpoint_every_steps
                and i % cfg.train.checkpoint_every_steps == 0):
            # copied to the host now, written in the background (on a mesh,
            # by rank 0 before a barrier); ``i`` is the global step, so saves
            # after a resume continue the numbering
            save_checkpoint(checkpoint_dir, i, state, block=False, mesh=mesh)
            saved_step = i
    if profiler is not None:
        _stop_profile(profiler, profile_dir, device)

    if checkpoint_dir:
        finalize_checkpoints(checkpoint_dir)
        if saved_step != int(state.step):
            save_checkpoint(checkpoint_dir, int(state.step), state, mesh=mesh)
    return state


def _stop_profile(profiler, profile_dir: str, device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(profile_dir, PROFILE_TRACE))
