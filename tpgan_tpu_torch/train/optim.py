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
    weight decay (tests/test_torch_train_step.py holds the two together).
    A CUDA graph of the step needs it capturable (:func:`make_capturable`)."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(beta1, beta2), eps=1e-8)


def make_capturable(opt: torch.optim.Optimizer) -> None:
    """Switch ``opt`` to ``capturable=True`` in place, so that a CUDA graph
    can capture its step: the step counts move to the parameters' device
    (no host sync in the update). The train step then copies each gradient
    into a fixed ``.grad`` buffer (``gan_trainer.make_gan_train_step``).
    ``gan_trainer.make_multi_step`` calls it before its capture; an eager
    step to hold against the graph's replays is built the same way, since
    the capturable update differs from the default one in the last bits
    (its bias correction is computed on the device in f32).

    It costs an eager step: on the H100 80GB HBM3 at 700 W the capturable
    update of both optimizers launches 790 kernels against 61 and keeps
    the device busy 5.89 ms against 3.92 per full-size bf16 step
    (``chip_smoke.py`` phase 11), so only the graphed path turns it on."""
    for group in opt.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            state = opt.state.get(p, {})
            if "step" in state and state["step"].device != p.device:
                state["step"] = state["step"].to(p.device, torch.float32)
