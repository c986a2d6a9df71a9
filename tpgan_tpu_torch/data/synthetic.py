"""Synthetic data generators — the port's numpy copy of
``tpgan_tpu/data/synthetic.py::synthetic_gan_batch`` (fixed-seed random
tensors with the batch contract of the real datasets). Same seed, same
arrays as the JAX package's copy."""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_gan_batch(
    batch_size: int, seed: int = 0, num_classes: int = 347
) -> Dict[str, np.ndarray]:
    """A TrainDataset-shaped NHWC batch (DataAndDataset.py:200-227 contract)."""
    rng = np.random.RandomState(seed)

    def img(h, w):
        return rng.uniform(-1, 1, (batch_size, h, w, 3)).astype(np.float32)

    batch = {
        "img": img(128, 128),
        "img64": img(64, 64),
        "img32": img(32, 32),
        "img_frontal": img(128, 128),
        "img64_frontal": img(64, 64),
        "img32_frontal": img(32, 32),
        "left_eye": img(40, 40),
        "right_eye": img(40, 40),
        "nose": img(32, 40),
        "mouth": img(32, 48),
        "left_eye_frontal": img(40, 40),
        "right_eye_frontal": img(40, 40),
        "nose_frontal": img(32, 40),
        "mouth_frontal": img(32, 48),
        "label": rng.randint(0, num_classes, (batch_size,)).astype(np.int32),
    }
    return batch
