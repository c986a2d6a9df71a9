"""Activation specs — the port of ``tpgan_tpu/ops/activations.py``.

Activations are hashable ``(name, param)`` tuples, the same specs the JAX
package uses, read by the blocks for both the forward and the Kaiming
init slope (reference: ModificationLayer.py:44-49).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

# (name, param). param is the negative slope for leaky_relu, unused otherwise.
Activation = Optional[Tuple[str, float]]

RELU: Activation = ("relu", 0.0)
# torch nn.LeakyReLU() defaults to negative_slope=0.01; the reference uses
# both LeakyReLU(1e-2) and LeakyReLU() — identical slopes.
LEAKY_RELU: Activation = ("leaky_relu", 0.01)
RELU6: Activation = ("relu6", 0.0)
SIGMOID: Activation = ("sigmoid", 0.0)
TANH: Activation = ("tanh", 0.0)


def leaky_relu(slope: float) -> Activation:
    return ("leaky_relu", float(slope))


def apply_activation(x: torch.Tensor, act: Activation) -> torch.Tensor:
    """``act`` applied to ``x``. One documented difference in the
    gradient: at exactly x == 0, ``F.leaky_relu``'s backward gives the
    slope where ``jax.nn.leaky_relu`` (``where(x >= 0, ...)``) gives 1.
    The port keeps the single fused torch op: a pre-activation that is
    exactly 0 needs a biased conv sum to cancel to the last bit, and the
    train-step parity test (tests/test_torch_train_step.py) meets none."""
    if act is None:
        return x
    name, p = act
    if name == "relu":
        return F.relu(x)
    if name == "leaky_relu":
        return F.leaky_relu(x, negative_slope=p)
    if name == "relu6":
        return torch.clamp(x, 0.0, 6.0)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "tanh":
        return torch.tanh(x)
    raise ValueError(f"unknown activation {name!r}")


def negative_slope(act: Activation) -> float:
    """Slope fed to Kaiming init — the activation's negative slope when it
    has one, else 0 (reference: ModificationLayer.py:45-49)."""
    if act is not None and act[0] == "leaky_relu":
        return act[1]
    return 0.0


def is_saturating(act: Activation) -> bool:
    """Sigmoid/Tanh get activation-before-BatchNorm ordering in the
    reference's block packaging (reference: ModificationLayer.py:141-151)."""
    return act is not None and act[0] in ("sigmoid", "tanh")
