"""Identity-embedder training — the port of
``tpgan_tpu/train/feature_extract.py`` and of ``cmd_train_embedder``'s
held-out split (``tpgan_tpu/cli.py:374-408``).

A classification loop: ``FeatureExtractModel`` forward (train-mode
BatchNorm, dropout) -> softmax cross-entropy in f32 over subject
identities -> one update of the configured optimizer
(``cfg.pretrain.optimizer`` with ``cfg.optimizer_param``). The trained
embedder's features feed the GAN's identity-preserving loss
(``models.feature_extract.make_identity_embed_fn``). Validation holds out
whole subjects: Rank-1 and same-identity cosine similarity on identities
the classifier never saw. The checkpoint is the model's variables alone
(``train.checkpoint.save_model_variables``).

All randomness of a step comes from one explicit ``torch.Generator``:
the augmentation's draws first (:func:`draw_augment`), then the dropout
keep-mask (MobileNetV2's head; ResNet18's dropout rate is 0). Tests
inject JAX's draws (``draws=``, ``drop_mask=``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.data.multipie import IdentityImageDataset, camera_token
from tpgan_tpu_torch.evaluate import l2_normalize, rank1_correct
from tpgan_tpu_torch.models.feature_extract import (
    FeatureExtractModel,
    build_feature_extract_model,
)
from tpgan_tpu_torch.train.checkpoint import save_model_variables
from tpgan_tpu_torch.train.optim import get_optimizer
from tpgan_tpu_torch.utils.device import resolve_device

AUGMENT_PAD = 4
GALLERY_CAMERA = "051"  # the frontal camera: each held-out subject's gallery image


@dataclasses.dataclass
class FeatureExtractState:
    """Step count, the embedder (its parameters and BatchNorm running
    statistics) and its optimizer."""

    step: int
    model: FeatureExtractModel
    optimizer: torch.optim.Optimizer


def create_feature_extract_state(
    cfg: Config, seed: int = 0, device: Optional[Union[str, torch.device]] = None
) -> Tuple[FeatureExtractState, FeatureExtractModel, torch.optim.Optimizer]:
    """(state, model, optimizer): the configured embedder with weights
    from ``seed`` on ``device`` (``cuda`` unless asked otherwise) and
    ``get_optimizer(cfg.pretrain.optimizer, ..., cfg.optimizer_param)``."""
    model = build_feature_extract_model(cfg, device, seed)
    opt = get_optimizer(cfg.pretrain.optimizer, model.parameters(), cfg.optimizer_param)
    return FeatureExtractState(0, model, opt), model, opt


def draw_augment(batch_size: int, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """The augmentation's draws, JAX's ranges (``augment_batch``): ``flip``
    with p 0.5, ``offsets`` (B, 2) of the crop in the reflect-padded image,
    integers in [0, 8], ``brightness`` in [-0.1, 0.1), ``contrast`` in
    [0.9, 1.1), on the generator's device."""
    kw = dict(generator=generator, device=generator.device)
    return {
        "flip": torch.rand((batch_size,), **kw) < 0.5,
        "offsets": torch.randint(0, 2 * AUGMENT_PAD + 1, (batch_size, 2), **kw),
        "brightness": -0.1 + 0.2 * torch.rand((batch_size,), **kw),
        "contrast": 0.9 + 0.2 * torch.rand((batch_size,), **kw),
    }


def augment_batch(images: torch.Tensor, draws: Mapping[str, object]) -> torch.Tensor:
    """Light identity-preserving augmentation of an NCHW batch with given
    draws (:func:`draw_augment`'s keys): a horizontal flip, a +-4 px shift
    (a crop of the reflect-padded image at ``offsets`` = (row, column)),
    then ``(x - mean) * contrast + mean + brightness`` with each image's
    mean over all its pixels and channels."""
    b, _c, h, w = images.shape
    dev = images.device
    d = {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}
    x = torch.where(d["flip"].reshape(b, 1, 1, 1).bool(), images.flip(3), images)
    x = F.pad(x, (AUGMENT_PAD,) * 4, mode="reflect")
    off = d["offsets"].long()
    rows = off[:, 0, None] + torch.arange(h, device=dev)
    cols = off[:, 1, None] + torch.arange(w, device=dev)
    x = x[torch.arange(b, device=dev)[:, None, None], :, rows[:, :, None], cols[:, None, :]]
    x = x.permute(0, 3, 1, 2)  # the advanced indices lead: (B, H, W, C) -> NCHW
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    contrast = d["contrast"].reshape(b, 1, 1, 1).to(x.dtype)
    brightness = d["brightness"].reshape(b, 1, 1, 1).to(x.dtype)
    return (x - mean) * contrast + mean + brightness


def _nchw(images, device) -> torch.Tensor:
    return torch.as_tensor(images, device=device).float().permute(0, 3, 1, 2)


def make_feature_extract_step(model: FeatureExtractModel, optimizer: torch.optim.Optimizer,
                              use_augment: bool = True):
    """``step(state, images, labels, generator, draws=None, drop_mask=None)
    -> (state, {"loss", "accuracy"})``: one update on an NHWC batch with
    integer labels. Augmentation (``draws``, else drawn from
    ``generator``), train-mode BatchNorm (its statistics advance),
    dropout (``drop_mask``, else drawn), softmax cross-entropy on f32
    logits, accuracy by argmax. Metrics are 0-d device tensors."""
    device = next(model.parameters()).device

    def step(state: FeatureExtractState, images, labels, generator: torch.Generator,
             draws: Optional[Mapping[str, object]] = None,
             drop_mask: Optional[torch.Tensor] = None):
        x = _nchw(images, device)
        y = torch.as_tensor(labels, device=device).long()
        if use_augment:
            x = augment_batch(x, draw_augment(x.shape[0], generator) if draws is None else draws)
        model.train()
        logits, _feats = model(x, use_dropout=True, drop_mask=drop_mask, generator=generator)
        loss = F.cross_entropy(logits.float(), y)
        accuracy = (logits.argmax(dim=-1) == y).float().mean()
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        state.step += 1
        return state, {"loss": loss.detach(), "accuracy": accuracy}

    return step


def evaluate_embedder_identity(
    model: FeatureExtractModel,
    probe_images: np.ndarray,
    probe_labels: np.ndarray,
    gallery_images: np.ndarray,
    gallery_labels: np.ndarray,
    chunk: int = 64,
) -> Dict[str, float]:
    """Held-out-subject validation through the embedding (eval mode, no
    dropout): ``val_rank1``, Rank-1 identification of the probes against
    the gallery; ``val_identity_sim``, the mean cosine between each probe
    and its own subject's gallery image; ``val_probes``. NHWC images. The
    model's train/eval mode is put back afterwards."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()

    def embed_all(images):
        with torch.no_grad():
            return torch.cat([model(_nchw(images[i:i + chunk], device))[1].float()
                              for i in range(0, len(images), chunk)])

    try:
        pe, ge = embed_all(probe_images), embed_all(gallery_images)
    finally:
        model.train(was_training)
    # Rank-1 and the similarities on the embeddings' device; only scalars come back
    p_lbl = torch.as_tensor(np.asarray(probe_labels), device=device)
    g_lbl = torch.as_tensor(np.asarray(gallery_labels), device=device)
    correct = rank1_correct(pe, p_lbl, ge, g_lbl)
    # each probe against its own subject's gallery image (the last one, should a label repeat)
    same = p_lbl[:, None] == g_lbl[None, :]
    own = same.shape[1] - 1 - torch.argmax(same.flip(1).int(), dim=1)
    sims = (l2_normalize(pe) * l2_normalize(ge)[own]).sum(dim=-1)[same.any(dim=1)]
    return {
        "val_rank1": float(correct.float().mean()),
        "val_identity_sim": float(sims.mean()) if sims.numel() else float("nan"),
        "val_probes": int(len(probe_labels)),
    }


def run_feature_extract_training(
    cfg: Config,
    batches: Iterator[Tuple[np.ndarray, np.ndarray]],
    *,
    steps: int,
    writer=None,
    checkpoint_dir: Optional[str] = None,
    seed: int = 0,
    use_augment: bool = True,
    val_data: Optional[Mapping[str, np.ndarray]] = None,
    val_every: int = 500,
    device: Optional[Union[str, torch.device]] = None,
) -> FeatureExtractState:
    """Train the embedder for ``steps`` steps over ``batches`` ((images
    NHWC, labels) pairs) and return the state (on the device).

    Weights and the step's ``torch.Generator`` come from ``seed``. The
    ``writer`` (``write(step, metrics)``) gets the step's metrics every 10
    steps and the validation metrics (:func:`evaluate_embedder_identity`
    on ``val_data``'s ``probe_images`` / ``probe_labels`` /
    ``gallery_images`` / ``gallery_labels``) every ``val_every`` steps and
    at the end, as step ``steps``. With ``checkpoint_dir``, the model's
    variables are saved at the final step. ``device``: ``cuda`` unless
    asked otherwise."""
    device = resolve_device(device)
    state, model, opt = create_feature_extract_state(cfg, seed, device)
    step_fn = make_feature_extract_step(model, opt, use_augment)
    generator = torch.Generator(device=device).manual_seed(seed)

    def run_val(step):
        metrics = evaluate_embedder_identity(
            model, val_data["probe_images"], val_data["probe_labels"],
            val_data["gallery_images"], val_data["gallery_labels"])
        if writer is not None:
            writer.write(step, metrics)
        return metrics

    for i in range(steps):
        try:
            images, labels = next(batches)
        except StopIteration:
            break
        state, metrics = step_fn(state, images, labels, generator)
        if writer is not None and (i + 1) % 10 == 0:
            writer.write(i + 1, metrics)
        if val_data is not None and (i + 1) % val_every == 0:
            run_val(i + 1)
    if val_data is not None:
        print(f"[embedder] held-out-subject validation: {run_val(steps)}")
    if checkpoint_dir:
        save_model_variables(checkpoint_dir, state.step, model)
    return state


def _subject(path: str) -> int:
    return int(os.path.basename(path).split("_")[0])


def held_out_subject_split(img_list: Sequence[str], n: int
                           ) -> Tuple[List[str], Dict[str, object]]:
    """``cmd_train_embedder``'s split (``tpgan_tpu/cli.py:374-408``): the
    last ``n`` >= 1 subjects (by number) are held out whole. Returns the
    training list and the held-out subjects' ``gallery_paths`` (each
    one's first image from camera 051, by subject), ``gallery_labels``,
    ``probe_paths`` (their other images, in list order) and
    ``probe_labels`` (:func:`load_val_data` reads the images)."""
    if n < 1:
        raise ValueError(f"held_out_subject_split holds out n >= 1 subjects, got {n}")
    held = set(sorted({_subject(p) for p in img_list})[-n:])
    train = [p for p in img_list if _subject(p) not in held]
    gallery: Dict[int, str] = {}
    probes: List[str] = []
    for p in img_list:
        if _subject(p) not in held:
            continue
        if camera_token(p) == GALLERY_CAMERA:
            gallery.setdefault(_subject(p), p)
        else:
            probes.append(p)
    labels = sorted(gallery)
    return train, {
        "gallery_paths": [gallery[s] for s in labels],
        "gallery_labels": np.asarray(labels, np.int32),
        "probe_paths": probes,
        "probe_labels": np.asarray([_subject(p) for p in probes], np.int32),
    }


def load_val_data(split: Mapping[str, object]) -> Dict[str, np.ndarray]:
    """:func:`held_out_subject_split`'s paths read into the ``val_data``
    that :func:`run_feature_extract_training` takes (images in [-1, 1],
    NHWC)."""

    def load(paths):
        ds = IdentityImageDataset(paths)
        return np.stack([ds[i][0] for i in range(len(ds))])

    return {"gallery_images": load(split["gallery_paths"]),
            "gallery_labels": split["gallery_labels"],
            "probe_images": load(split["probe_paths"]),
            "probe_labels": split["probe_labels"]}
