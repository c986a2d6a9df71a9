"""Sample grids during GAN training — the port of
``tpgan_tpu/train/sampling.py``: rows of profile input, synthesized
frontal face and ground-truth frontal face, written as PNGs by
``data/imageio.py`` (no imaging package)."""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np
import torch

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.data.imageio import write_png
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.train.gan_trainer import make_synthesize_fn


def _to_u8(x: np.ndarray) -> np.ndarray:
    return ((np.clip(x, -1.0, 1.0) + 1.0) * 127.5).astype(np.uint8)


def save_image_grid(rows: Sequence, path: str, pad: int = 2) -> None:
    """rows: (N, H, W, 3) float arrays or tensors in [-1, 1]; writes a
    grid PNG with one input per column and one array per row."""
    u8_rows = []
    for arr in rows:
        arr = arr.detach().float().cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
        n, h, w, c = arr.shape
        canvas = np.zeros((h + pad, n * (w + pad) - pad, c), np.uint8)
        for i in range(n):
            canvas[:h, i * (w + pad): i * (w + pad) + w] = _to_u8(arr[i])
        u8_rows.append(canvas)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, np.concatenate(u8_rows, axis=0))


def make_sample_fn(
    cfg: Config,
    gen: Generator,
    dataset,
    out_dir: str,
    num_samples: int = 8,
    seed: int = 0,
):
    """A ``sample_fn(step, state)`` for ``run_gan_training``: synthesizes a
    fixed probe batch (the first ``num_samples`` items of ``dataset``,
    noise from ``seed``) with the state's live generator weights and
    writes ``<out_dir>/samples_<step>.png`` with the rows [profile, fake,
    frontal]. The weights are the state's at each call (``state.gen``),
    as the JAX hook reads ``state.g_params``; ``gen`` stays in the
    signature for the JAX one's sake."""
    n = min(num_samples, len(dataset))
    items = [dataset[i] for i in range(n)]
    batch: Dict[str, np.ndarray] = {k: np.stack([np.asarray(it[k]) for it in items])
                                    for k in items[0]}
    # raw-uint8 datasets: decoded once on the host, a small fixed batch
    batch = {k: ((2.0 * v.astype(np.float32) - 255.0) / 255.0 if v.dtype == np.uint8 else v)
             for k, v in batch.items()}
    z = torch.randn((n, cfg.G.zdim), generator=torch.Generator().manual_seed(seed))

    def sample_fn(step: int, state) -> None:
        # built at each call: in bf16 the function holds a cast copy of
        # the weights as they are now
        fake = make_synthesize_fn(cfg, state.gen)(batch, z)
        save_image_grid([batch["img"], fake, batch["img_frontal"]],
                        os.path.join(out_dir, f"samples_{step:06d}.png"))

    return sample_fn
