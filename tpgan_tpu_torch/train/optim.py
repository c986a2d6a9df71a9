"""Optimizers of the GAN step — the port of ``adam_wgan``
(``tpgan_tpu/train/optim.py:61-65``). The detector's ``get_optimizer``
comes with the detector slice."""

from __future__ import annotations

from typing import Iterable

import torch


def adam_wgan(
    params: Iterable[torch.nn.Parameter],
    learning_rate: float,
    beta1: float = 0.5,
    beta2: float = 0.9,
) -> torch.optim.Adam:
    """Adam with the standard WGAN-GP betas. ``torch.optim.Adam`` with
    eps 1e-8 has the update form of ``optax.adam``:
    p -= lr * m_hat / (sqrt(v_hat) + eps), bias-corrected moments, no
    weight decay (tests/test_torch_train_step.py holds the two together)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(beta1, beta2), eps=1e-8)
