"""Landmark-detector pretraining — the port of ``tpgan_tpu/train/pretrain.py``
(reference: Pretrain.py:76-310).

* One train step: forward (train-mode BatchNorm) + the multi-task loss
  + backward + the SGD update (momentum, nesterov, weight decay) and,
  when ``pretrain.use_learning_rate_scheduler``, MultiStepLR over
  optimizer steps (``train.optim.multistep_lr``). A uint8 batch crosses
  to the device as uint8 and is decoded there, correctly rounded.
* The decoder and the banded accuracy (Pretrain.py:17-64) run on the
  device as fixed-shape masked ops; metrics are 0-d device tensors.
* All randomness of a step is the background subsample's uniforms,
  drawn from an explicit ``torch.Generator`` (or injected: ``u=``).
* :func:`run_pretrain`: epochs x steps, validation every
  ``log_step_of_batchs`` steps, per-epoch checkpoints, the best model by
  validation accuracy under ``best/`` with its bar in ``best_acc.json``,
  and a resume that restores the weights, the optimizer, the schedule
  and the bar; data-parallel over the ranks of a ``mesh``.

Checkpoints are ``train.checkpoint``'s one format (``<dir>/<step>/
state.pt``); the detector's architecture knobs and the serving nose prior
go in ``detector_meta.json`` beside them, the JAX package's sidecar.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.losses.decoder import decode_for_head_mode
from tpgan_tpu_torch.losses.multitask import multitask_landmark_loss
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2, anchor_centres
from tpgan_tpu_torch.models.registry import get_model
from tpgan_tpu_torch.ops.blocks import reset_parameters, sync_batch_stats
from tpgan_tpu_torch.parallel import infer_param_shardings, place
from tpgan_tpu_torch.parallel.collectives import all_reduce_metrics, all_reduce_sum
from tpgan_tpu_torch.parallel.mesh import data_group
from tpgan_tpu_torch.parallel.sharding import mean_gradients_, metrics_group
from tpgan_tpu_torch.parallel.distributed import barrier, is_main_process
from tpgan_tpu_torch.train.optim import get_optimizer, multistep_lr
from tpgan_tpu_torch.utils import trace
from tpgan_tpu_torch.utils.device import resolve_device

# threshold-weighted accuracy bands (reference: Pretrain.py:29-32)
ACC_THRESHOLDS = (5.0, 10.0, 18.0, 30.0, 45.0)
ACC_WEIGHTS = (1.0, 0.9, 0.65, 0.35, 0.1)
PART_NAMES = ("left_eye", "right_eye", "nose", "mouth")
META_FILE = "detector_meta.json"
BEST_FILE = "best_acc.json"


@dataclasses.dataclass
class PretrainState:
    """Step count, the detector (parameters and BatchNorm statistics),
    its optimizer and, when the schedule is on, its MultiStepLR."""

    step: int
    model: MobileNetV2
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.MultiStepLR] = None


def _part_distances(points, valid, labels):
    """(distance (B, 4), valid (B, 4)) of the top-1 decode of each part
    (background dropped) to its label."""
    pred = points[:, :4, 0, :]
    gt = labels.reshape(-1, 4, 2).to(pred.dtype)
    d = torch.sqrt(torch.sum(torch.square(pred - gt), dim=-1) + 1e-20)
    return d, valid[:, :4, 0]


def landmark_accuracy(points: torch.Tensor, valid: torch.Tensor, labels: torch.Tensor,
                      thresholds_scale: float = 1.0) -> torch.Tensor:
    """Euclid-distance banded accuracy (reference: Pretrain.py:17-64):
    each part's top-1 decode scores the weight of the band its distance
    to the label falls in, (0, 5] -> 1.0 ... (30, 45] -> 0.1, beyond 45
    and undetected parts 0; the mean over parts and images. Distances are
    in the label frame; ``thresholds_scale`` scales every band."""
    d, ok = _part_distances(points, valid, labels)
    acc = torch.zeros_like(d)
    prev = 0.0
    for thr, w in zip(ACC_THRESHOLDS, ACC_WEIGHTS):
        thr = thr * thresholds_scale
        acc = acc + torch.where((d > prev) & (d <= thr), w, 0.0)
        prev = thr
    return torch.mean(torch.where(ok, acc, 0.0))


def fit_nose_prior(labels: np.ndarray, noise_sigma: float = 6.0) -> np.ndarray:
    """The linear nose shape prior ``nose = [le, re, mouth, 1] @ W`` fit
    on training annotations by ridge regression at lambda = N *
    noise_sigma^2 (no penalty on the bias): the JAX package's
    errors-in-variables correction for the detector's own eye / mouth
    noise (``tpgan_tpu/train/pretrain.py:94-127``). ``labels``: (N, 8) or
    (N, 4, 2). Returns W (7, 2) float32."""
    pts = np.asarray(labels, np.float64).reshape(-1, 4, 2)
    x = np.concatenate([pts[:, 0], pts[:, 1], pts[:, 3], np.ones((len(pts), 1))], axis=1)
    y = pts[:, 2]
    reg = np.eye(7) * (len(pts) * float(noise_sigma) ** 2)
    reg[6, 6] = 0.0  # the bias is noise-free
    return (np.linalg.pinv(x.T @ x + reg) @ (x.T @ y)).astype(np.float32)


def write_detector_meta(checkpoint_dir: str, cfg: Config,
                        nose_prior: Optional[np.ndarray] = None) -> None:
    """Record the knobs a detector checkpoint depends on (``head_mode``,
    ``model_name``) and the serving nose prior in
    ``<checkpoint_dir>/detector_meta.json``, the JAX package's sidecar."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    meta = {"head_mode": cfg.pretrain.head_mode, "model_name": cfg.pretrain.model_name}
    if nose_prior is not None:
        meta["nose_prior"] = np.asarray(nose_prior, np.float32).tolist()
    with open(os.path.join(checkpoint_dir, META_FILE), "w") as f:
        json.dump(meta, f)


def _read_meta(checkpoint_dir: str) -> Optional[dict]:
    """The sidecar at the checkpoint root, or one level up (a ``best/``)."""
    for d in (checkpoint_dir, os.path.dirname(checkpoint_dir.rstrip("/"))):
        path = os.path.join(d, META_FILE)
        if os.path.exists(path):
            with open(path) as f:
                return json.load(f)
    return None


def load_nose_prior(checkpoint_dir: str) -> Optional[np.ndarray]:
    """The (7, 2) nose prior from the checkpoint's sidecar, or None."""
    meta = _read_meta(checkpoint_dir)
    if meta is None or "nose_prior" not in meta:
        return None
    return np.asarray(meta["nose_prior"], np.float32)


def apply_detector_meta(cfg: Config, checkpoint_dir: str) -> Config:
    """``cfg`` with ``pretrain.head_mode`` / ``model_name`` taken from the
    checkpoint's sidecar, when it has one."""
    meta = _read_meta(checkpoint_dir)
    if meta is None:
        return cfg
    return dataclasses.replace(cfg, pretrain=dataclasses.replace(
        cfg.pretrain,
        head_mode=meta.get("head_mode", cfg.pretrain.head_mode),
        model_name=meta.get("model_name", cfg.pretrain.model_name)))


def build_detector(cfg: Config, device: Optional[Union[str, torch.device]] = None,
                   seed: int = 0) -> MobileNetV2:
    """The configured detector (``pretrain.model_name`` through the
    registry, ``pretrain.head_mode``) with float32 weights drawn from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (``cuda``
    unless asked otherwise)."""
    device = resolve_device(device)
    model = get_model(cfg.pretrain.model_name, head_mode=cfg.pretrain.head_mode, device=device)
    reset_parameters(model, torch.Generator(device=device).manual_seed(seed))
    return model


def create_pretrain_state(
    cfg: Config, seed: int = 0, device: Optional[Union[str, torch.device]] = None,
    steps_per_epoch: int = 1,
) -> Tuple[PretrainState, MobileNetV2, torch.optim.Optimizer]:
    """(state, model, optimizer): :func:`build_detector` and
    ``get_optimizer(pretrain.optimizer, ..., optimizer_param)``, with the
    epoch milestones as a MultiStepLR over optimizer steps when
    ``pretrain.use_learning_rate_scheduler`` (the JAX package builds the
    schedule only then; the reference steps it regardless,
    Pretrain.py:301 vs :126)."""
    model = build_detector(cfg, device, seed)
    opt = get_optimizer(cfg.pretrain.optimizer, model.parameters(), cfg.optimizer_param)
    p = cfg.pretrain
    sched = (multistep_lr(opt, p.learning_rate_scheduler_milestone,
                          p.learning_rate_scheduler_gamma, steps_per_epoch)
             if p.use_learning_rate_scheduler else None)
    return PretrainState(0, model, opt, sched), model, opt


def decode_images(images, device: torch.device) -> torch.Tensor:
    """NHWC images (numpy or tensor) -> NCHW f32 on ``device``. uint8
    crosses as uint8 and is decoded there as v / 255, the divisor a 0-d
    tensor on the device: correctly rounded on the card too (CUDA divides
    by a CPU scalar as a product with its reciprocal)."""
    x = torch.as_tensor(images, device=device)
    if x.dtype == torch.uint8:
        x = x.float() / torch.full((), 255.0, device=device)
    return x.float().permute(0, 3, 1, 2).contiguous()


def _loss_kwargs(cfg: Config, size_hw, device) -> dict:
    lc = cfg.pretrain.loss
    return dict(
        image_size=tuple(size_hw), alpha=lc.alpha, beta=lc.beta,
        ratio_non_background=lc.ratio_non_background,
        distance_threshold_ratio=lc.distance_threshold_ratio,
        # anchor-offset heads assign positives from the static anchor grid
        assign_points=(anchor_centres(size_hw, device)
                       if cfg.pretrain.head_mode == "anchor_offset" else None),
    )


def make_pretrain_step(cfg: Config, model: MobileNetV2, optimizer: torch.optim.Optimizer,
                       scheduler: Optional[torch.optim.lr_scheduler.MultiStepLR] = None,
                       mesh=None):
    """``step(state, images, labels, generator=None, *, u=None,
    return_aux=False) -> (state, metrics)``: one update on an NHWC batch
    (uint8 or f32 in [0, 1]) with (B, 8) labels. The image size comes
    from the batch, so one step serves every bucket. ``u``: the (B, N)
    uniforms of the background draw, else drawn from ``generator``.
    Metrics (0-d device tensors): ``loss``, ``accuracy`` (of the head
    mode's decode of this forward), ``location_loss``,
    ``classification_loss``, ``num_positives``. ``return_aux=True`` adds
    a third result: the loss's assignment (``assigned``, ``keep_bg``) and
    the forward's ``loc`` / ``cls``.

    ``mesh`` (``parallel.make_mesh``): one step of JAX's ``data``-sharded
    step per rank. The batch is this rank's rows of the global batch;
    the uniforms are drawn (or given) for the global batch and each rank
    keeps its rows; BatchNorm takes the global batch's statistics
    (``ops.blocks.sync_batch_stats``), the gradient mean and the metrics
    are all-reduced (each loss term is a mean over images, so the mean of
    the ranks' means is the global one). A model axis needs the model
    placed first (``place(state, infer_param_shardings(mesh, state))``):
    its sharded layers gather or sum over the model group, SGD acts on
    each rank's slices, and the gradients are averaged as
    ``parallel.sharding.mean_gradients_`` says.

    A step is five spans in turn (``utils.trace``): ``pretrain.forward``
    (decode and model), ``pretrain.loss``, ``pretrain.backward`` (with the
    gradients' mean over a mesh), ``pretrain.optimizer`` (with the
    schedule) and ``pretrain.metrics`` (decode, accuracy, their
    all-reduce)."""
    device = next(model.parameters()).device
    decode = decode_for_head_mode(cfg.pretrain.head_mode)
    _group, rank, ranks = data_group(mesh)
    metric_group = metrics_group(mesh)
    sync_batch_stats(model, mesh)

    def step(state: PretrainState, images, labels, generator: Optional[torch.Generator] = None,
             *, u: Optional[torch.Tensor] = None, return_aux: bool = False):
        with trace.span("pretrain.forward"):
            x = decode_images(images, device)
            y = torch.as_tensor(labels, device=device).float()
            model.train()
            loc, cls = model(x)
        with trace.span("pretrain.loss"):
            if u is not None:
                u = torch.as_tensor(u, device=device)
            if ranks > 1:  # this rank's rows of the global draw
                b = x.shape[0]
                if u is None:
                    u = torch.rand((b * ranks, loc.shape[1]), generator=generator, device=device)
                u = u[rank * b:(rank + 1) * b]
            loss, aux = multitask_landmark_loss(loc, cls, y, u, generator=generator,
                                                **_loss_kwargs(cfg, x.shape[2:], device))
        with trace.span("pretrain.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            mean_gradients_(model, mesh)
        with trace.span("pretrain.optimizer"):
            optimizer.step()
            if scheduler is not None:
                scheduler.step()
            state.step += 1
        with trace.span("pretrain.metrics"):
            with torch.no_grad():
                loc, cls = loc.detach(), cls.detach()
                decoded = decode(loc, cls)
                acc = landmark_accuracy(decoded.points, decoded.valid, y)
            metrics = {"loss": loss.detach(), "accuracy": acc,
                       **{k: aux[k].detach() for k in
                          ("location_loss", "classification_loss", "num_positives")}}
            if metric_group is not None:  # the global means
                metrics = all_reduce_metrics(metrics, metric_group)
        if return_aux:
            return state, metrics, {"assigned": aux["assigned"], "keep_bg": aux["keep_bg"],
                                    "loc": loc, "cls": cls}
        return state, metrics

    return step


def make_eval_step(cfg: Config, model: MobileNetV2, mesh=None):
    """``eval_step(state, images, labels, generator=None, *, u=None) ->
    metrics``: the eval-mode forward (running BatchNorm statistics, no
    gradient), the loss (``val_loss``), the decode's banded accuracy
    (``val_accuracy``), and per part the mean pixel error of the valid
    decodes and their 5-px hit rate (``val_err_px_<part>``,
    ``val_within_5px_<part>``) with their means over parts
    (``tpgan_tpu/train/pretrain.py:305-324``).

    ``mesh``: the batch is the global one (host or device); each rank
    takes its rows ``[r * v // N, (r + 1) * v // N)`` (a last batch need
    not divide) and the uniforms' rows of the global draw, and the metrics
    come from the sums over the ranks: the global batch's."""
    device = next(model.parameters()).device
    decode = decode_for_head_mode(cfg.pretrain.head_mode)
    group, rank, ranks = data_group(mesh)

    def forward(images, labels, u, generator):
        """(loss, accuracy, part distances, valid decodes) of a batch."""
        x = decode_images(images, device)
        y = torch.as_tensor(labels, device=device).float()
        was_training = model.training
        model.eval()
        try:
            loc, cls = model(x)
        finally:
            model.train(was_training)
        total, _ = multitask_landmark_loss(loc, cls, y, u, generator=generator,
                                           **_loss_kwargs(cfg, x.shape[2:], device))
        decoded = decode(loc, cls)
        acc = landmark_accuracy(decoded.points, decoded.valid, y)
        return (total, acc, *_part_distances(decoded.points, decoded.valid, y))

    def global_sums(images, labels, u, generator):
        """[loss sum, accuracy sum, images, per part: error sum, hits
        within 5 px, valid decodes] over every rank's rows."""
        v = int(np.shape(images)[0])
        rows = slice(rank * v // ranks, (rank + 1) * v // ranks)
        if u is None:  # the global draw, the same on every rank
            n = anchor_centres(tuple(np.shape(images)[1:3])).shape[0]
            u = torch.rand((v, n), generator=generator, device=device)
        sums = torch.zeros(15, device=device)
        b = rows.stop - rows.start
        if b:
            total, acc, d, ok = forward(images[rows], labels[rows], u[rows], generator)
            sums = torch.cat([torch.stack([total * b, acc * b, torch.full_like(total, b)]),
                              torch.where(ok, d, 0.0).sum(dim=0),
                              (ok & (d <= 5.0)).sum(dim=0), ok.sum(dim=0)]).float()
        return all_reduce_sum(sums, group)

    @torch.no_grad()
    def eval_step(state: PretrainState, images, labels,
                  generator: Optional[torch.Generator] = None, *,
                  u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        if u is not None:
            u = torch.as_tensor(u, device=device)
        if ranks > 1:
            sums = global_sums(images, labels, u, generator)
            total, acc = sums[0] / sums[2], sums[1] / sums[2]
            err_sum, in5_sum, n_ok = sums[3:7], sums[7:11], torch.clamp_min(sums[11:15], 1)
        else:
            total, acc, d, ok = forward(images, labels, u, generator)
            n_ok = torch.clamp_min(ok.sum(dim=0), 1)
            err_sum, in5_sum = torch.where(ok, d, 0.0).sum(dim=0), (ok & (d <= 5.0)).sum(dim=0)
        part_err = err_sum / n_ok
        part_in5 = in5_sum / n_ok
        metrics = {"val_loss": total, "val_accuracy": acc,
                   "val_within_5px": part_in5.mean(), "val_err_px": part_err.mean()}
        for i, name in enumerate(PART_NAMES):
            metrics[f"val_err_px_{name}"] = part_err[i]
            metrics[f"val_within_5px_{name}"] = part_in5[i]
        return metrics

    return eval_step


def run_pretrain(
    cfg: Config,
    train_batches: Iterator[Tuple[object, object]],
    *,
    val_batches_fn: Optional[Callable[[], Iterator[Tuple[object, object]]]] = None,
    steps_per_epoch: int,
    writer=None,
    checkpoint_dir: Optional[str] = None,
    seed: int = 0,
    mesh=None,
    resume: bool = False,
    nose_prior: Optional[np.ndarray] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> PretrainState:
    """The pretrain driver: ``pretrain.num_epochs`` epochs of
    ``steps_per_epoch`` steps over ``train_batches`` ((images, labels)
    pairs, NHWC, host or device), validation over ``val_batches_fn()``
    every ``pretrain.log_step_of_batchs`` steps (the reference's cadence,
    Pretrain.py:198), metrics to ``writer`` every 10 steps and after each
    validation, a checkpoint at the end of every epoch that took a step,
    and the best validation accuracy's model under ``<checkpoint_dir>/
    best`` with its bar in ``best_acc.json``. ``resume=True`` restores
    the newest per-epoch checkpoint (weights, BatchNorm statistics,
    optimizer, schedule, step) and the bar, and continues the epoch
    schedule from there. Weights and the step's ``torch.Generator`` come
    from ``seed``. ``device``: ``cuda`` unless asked otherwise.

    ``mesh`` (``parallel.make_mesh``): data-parallel over its data axis,
    as JAX's run with a mesh shards the batch over ``data``, and
    tensor-parallel over its model axis, the detector's weights (the
    depthwise convs column-parallel among them) and SGD's momentum placed
    by ``infer_param_shardings(mesh, state)`` as JAX's ``pretrain.py:372``
    places them.
    ``pretrain.batch_size`` and the batches are global: each rank keeps
    its rows of a train batch (sliced where it lies, before the copy to
    its device; a batch of the local size is taken as this rank's rows
    already) and of a validation batch, and the validation metrics are
    the global batch's. Every rank restores a resumed run and takes rank
    0's state (each rank its slice of the sharded leaves); rank 0 alone
    writes the sidecar, ``best/``,
    ``best_acc.json`` and the per-epoch checkpoints, and every rank waits
    at a barrier after each write and reads the bar."""
    from tpgan_tpu_torch.train.checkpoint import latest_step, restore_checkpoint, save_checkpoint

    device = resolve_device(device)
    main = mesh is None or is_main_process()
    state, model, opt = create_pretrain_state(cfg, seed, device, steps_per_epoch)
    if checkpoint_dir and main:
        write_detector_meta(checkpoint_dir, cfg, nose_prior=nose_prior)
    if mesh is not None:
        barrier(mesh.world)
    if resume and checkpoint_dir:
        restore_checkpoint(checkpoint_dir, state)
        print(f"[pretrain] resumed from step {state.step} "
              f"(epoch {state.step // max(steps_per_epoch, 1)})")
    if mesh is not None:  # JAX's pretrain.py:372
        place(state, infer_param_shardings(mesh, state))
    train_step = make_pretrain_step(cfg, model, opt, state.scheduler, mesh=mesh)
    eval_step = make_eval_step(cfg, model, mesh=mesh)
    generator = torch.Generator(device=device).manual_seed(seed)

    def local_rows(images, labels):
        if mesh is None or int(np.shape(images)[0]) * mesh.size == cfg.pretrain.batch_size:
            return images, labels
        rows = mesh.rows(int(np.shape(images)[0]))
        return images[rows], labels[rows]

    # the bar persists beside best/, so a resumed run does not overwrite a
    # better checkpoint with its first, possibly worse, validation
    best_acc = -1.0
    best_meta = os.path.join(checkpoint_dir, BEST_FILE) if checkpoint_dir else None
    if resume and best_meta and os.path.exists(best_meta):
        with open(best_meta) as f:
            best_acc = float(json.load(f)["best_acc"])
        print(f"[pretrain] best-model bar restored: val_accuracy {best_acc:.4f}")

    step = state.step
    # on every rank the same: a rank that read the directory after rank 0's
    # next write would skip the barrier that write's readers wait at
    saved_step = latest_step(checkpoint_dir) if checkpoint_dir else None
    for _epoch in range(step // max(steps_per_epoch, 1), cfg.pretrain.num_epochs):
        for _ in range(steps_per_epoch):
            try:
                images, labels = next(train_batches)
            except StopIteration:
                break
            state, metrics = train_step(state, *local_rows(images, labels), generator)
            step = state.step
            if writer is not None and main and step % 10 == 0:
                writer.write(step, metrics)
            if val_batches_fn is not None and step % cfg.pretrain.log_step_of_batchs == 0:
                sums: Dict[str, list] = {}
                for v_img, v_lbl in val_batches_fn():
                    for k, v in eval_step(state, v_img, v_lbl, generator).items():
                        sums.setdefault(k, []).append(float(v))
                if sums:
                    val_acc = float(np.mean(sums["val_accuracy"]))
                    if writer is not None and main:
                        writer.write(step, {k: float(np.mean(v)) for k, v in sums.items()})
                    if checkpoint_dir and val_acc > best_acc:
                        best_acc = val_acc
                        save_checkpoint(os.path.join(checkpoint_dir, "best"), step, state,
                                        mesh=mesh)
                        if main:
                            with open(best_meta, "w") as f:
                                json.dump({"best_acc": best_acc, "step": step}, f)
        if checkpoint_dir and saved_step != step:
            save_checkpoint(checkpoint_dir, step, state, mesh=mesh)
            saved_step = step
    return state
