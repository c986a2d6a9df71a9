"""Optimizers — the port of ``tpgan_tpu/train/optim.py``: the optimizer
factory (reference: UtilityMethods.py:14-41), the MultiStepLR schedule
(reference: Pretrain.py:126-130) and the GAN step's ``adam_wgan``.

Each optimizer takes optax's update form. torch's ``weight_decay`` is L2
folded into the gradient before the momentum or adaptive step, which is
``optax.add_decayed_weights`` placed ahead of the transform, as the JAX
factory chains it. SGD, Adam and Adadelta are torch's own, whose defaults
(momentum trace, nesterov form, betas, eps, rho) equal optax's. optax's
RMSprop and Adagrad put ``eps`` inside the square root (``rsqrt(nu +
eps)``) where torch's add it after, and start Adagrad's accumulator at
0.1 (torch: 0); :class:`OptaxRMSprop` and :class:`OptaxAdagrad` carry
optax's forms.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch

from tpgan_tpu_torch.config import OptimizerConfig


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay, eps, momentum=...)``:
    nu = (1 - decay) g^2 + decay nu; u = g rsqrt(nu + eps); with momentum,
    t = u + momentum t and the update is -lr t, else -lr u."""

    def __init__(self, params, lr: float, decay: float = 0.9, eps: float = 1e-8,
                 momentum: Optional[float] = None, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            decay, momentum = group["decay"], group["momentum"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=group["weight_decay"]) if group["weight_decay"] else p.grad
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                    if momentum:
                        state["trace"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(decay).add_(g * g, alpha=1.0 - decay)
                u = g * torch.rsqrt(nu + group["eps"])
                if momentum:
                    u = state["trace"].mul_(momentum).add_(u)
                p.sub_(u, alpha=group["lr"])


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr, initial_accumulator_value=0.1, eps=1e-7)``:
    s = g^2 + s, from 0.1; the update is -lr g rsqrt(s + eps) where
    s > 0, else 0."""

    def __init__(self, params, lr: float, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad.add(p, alpha=group["weight_decay"]) if group["weight_decay"] else p.grad
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(p, group["initial_accumulator_value"])
                s = state["sum"]
                s.add_(g * g)
                inv = torch.where(s > 0, torch.rsqrt(s + group["eps"]), torch.zeros_like(s))
                p.sub_(inv * g, alpha=group["lr"])


def get_optimizer(
    name: str,
    params: Iterable[torch.nn.Parameter],
    cfg: Optional[OptimizerConfig] = None,
    learning_rate: Optional[float] = None,
) -> torch.optim.Optimizer:
    """The optimizer ``name`` over ``params`` with the reference's
    hyperparameter wiring (reference: UtilityMethods.py:30-39; params
    config.py:31-35): sgd (momentum, nesterov), adam, rmsprop (momentum),
    adagrad, adadelta, each with ``cfg.weight_decay``. Unknown names fall
    back to SGD, as the reference does (:39). A schedule is a separate
    object here (:func:`multistep_lr`)."""
    cfg = cfg or OptimizerConfig()
    lr = cfg.learning_rate if learning_rate is None else float(learning_rate)
    wd = float(cfg.weight_decay or 0.0)
    name = (name or "sgd").lower()
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=wd)
    if name == "rmsprop":
        return OptaxRMSprop(params, lr, momentum=cfg.momentum, weight_decay=wd)
    if name == "adagrad":
        return OptaxAdagrad(params, lr, weight_decay=wd)
    if name == "adadelta":
        return torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6, weight_decay=wd)
    # 'sgd' and the reference's silent fallback
    return torch.optim.SGD(params, lr=lr, momentum=cfg.momentum, nesterov=bool(cfg.nesterov),
                           weight_decay=wd)


def multistep_lr(
    optimizer: torch.optim.Optimizer,
    milestones: Sequence[int],
    gamma: float,
    steps_per_epoch: int,
) -> torch.optim.lr_scheduler.MultiStepLR:
    """torch MultiStepLR over optimizer steps: the learning rate is
    multiplied by ``gamma`` at each epoch milestone times
    ``steps_per_epoch`` (reference: Pretrain.py:126-130; milestones
    config.py:17-18). Call its ``step()`` after each optimizer step; the
    update after k steps then uses optax's ``piecewise_constant_schedule``
    value at count k. Repeated milestones count once, as in the JAX
    schedule's dict."""
    steps = sorted({int(m) * steps_per_epoch for m in milestones})
    return torch.optim.lr_scheduler.MultiStepLR(optimizer, steps, gamma)


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
