"""WGAN-GP adversarial losses — the port of ``tpgan_tpu/losses/gan.py``.

The critic maps are NCHW (B, 1, 4, 4) here (NHWC (B, 4, 4, 1) in JAX);
every loss is a mean, so the layout changes nothing. The means keep the
scores' dtype (bf16 in training), as ``jnp.mean`` does.
"""

from __future__ import annotations

from typing import Callable

import torch


def discriminator_loss(real_scores: torch.Tensor, fake_scores: torch.Tensor) -> torch.Tensor:
    """Wasserstein critic loss E[D(fake)] - E[D(real)] (minimised), over
    all local patches."""
    return fake_scores.mean() - real_scores.mean()


def generator_adversarial_loss(fake_scores: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)]."""
    return -fake_scores.mean()


def gradient_penalty(
    critic: Callable[[torch.Tensor], torch.Tensor],
    real: torch.Tensor,
    fake: torch.Tensor,
    eps: torch.Tensor,
) -> torch.Tensor:
    """WGAN-GP: E[(||grad_x D(x_hat)||_2 - 1)^2] with
    x_hat = eps * real + (1 - eps) * fake, ``eps`` of shape (B, 1, 1, 1)
    in ``real``'s dtype (JAX draws it from the step's GP rng; here the
    caller passes it). The gradient is taken with ``create_graph=True`` so
    the penalty is differentiable in the critic's parameters; the norm is
    taken in f32 with 1e-12 inside the square root."""
    x_hat = (eps * real + (1.0 - eps) * fake).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(critic(x_hat).sum(), x_hat, create_graph=True)
    norms = torch.sqrt(grads.float().square().sum(dim=(1, 2, 3)) + 1e-12)
    return (norms - 1.0).square().mean()
