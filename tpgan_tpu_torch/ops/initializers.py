"""Weight initializers with PyTorch's fan rules — the port of
``tpgan_tpu/ops/initializers.py``, acting in place on torch-layout tensors
and drawing from an explicit ``torch.Generator``.

The reference initialises conv/deconv weights with ``kaiming_normal`` /
``xavier_normal`` (reference: ModificationLayer.py:26-52) and leaves
layers built with ``init=None`` on torch's default Conv2d / Linear init
(kaiming-uniform with a=sqrt(5)). The fans, as the JAX package computes
them:

* Conv2d weight (out, in, kh, kw): fan_in = in*kh*kw, fan_out = out*kh*kw;
  a grouped conv's weight (out, in/groups, kh, kw) gives in/groups*kh*kw,
  as JAX's (kh, kw, in/groups, out) does.
* ConvTranspose2d weight (in, out, kh, kw): torch reads ``weight.size(1)``,
  so fan_in = out*kh*kw (the *output* channels); fan_out = in*kh*kw.
* Linear weight (out, in): fan_in = in, fan_out = out.
* Bias: U(-1/sqrt(fan_in), +1/sqrt(fan_in)); the transposed-conv bias uses
  fan_in = out*kh*kw (``tpgan_tpu/ops/blocks.py:400``).

Each factory returns ``init(tensor, generator=None)``. The same seed gives
other numbers than ``jax.random``: parity tests carry weights across with
:mod:`tpgan_tpu_torch.convert` instead of re-drawing them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

Initializer = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _leaky_gain(a: float) -> float:
    return math.sqrt(2.0 / (1.0 + a * a))


def _normal(std: float) -> Initializer:
    def init(t, generator=None):
        with torch.no_grad():
            return t.normal_(0.0, std, generator=generator)

    return init


def _uniform(bound: float) -> Initializer:
    def init(t, generator=None):
        with torch.no_grad():
            return t.uniform_(-bound, bound, generator=generator)

    return init


def _fans_conv(shape) -> tuple[int, int]:
    cout, cin, kh, kw = shape
    return cin * kh * kw, cout * kh * kw


def _fans_deconv(shape) -> tuple[int, int]:
    cin, cout, kh, kw = shape
    return cout * kh * kw, cin * kh * kw


def _shape_init(make: Callable[[tuple], Initializer]) -> Initializer:
    def init(t, generator=None):
        return make(tuple(t.shape))(t, generator)

    return init


def kaiming_normal_conv(a: float = 0.0) -> Initializer:
    """He-normal, fan_in mode, leaky slope ``a`` — for OIHW conv weights."""
    return _shape_init(lambda s: _normal(_leaky_gain(a) / math.sqrt(_fans_conv(s)[0])))


def kaiming_normal_deconv(a: float = 0.0) -> Initializer:
    """He-normal for IOHW transposed-conv weights (fan_in = out*kh*kw)."""
    return _shape_init(
        lambda s: _normal(_leaky_gain(a) / math.sqrt(_fans_deconv(s)[0]))
    )


def xavier_normal_conv() -> Initializer:
    return _shape_init(lambda s: _normal(math.sqrt(2.0 / sum(_fans_conv(s)))))


def xavier_normal_deconv() -> Initializer:
    return _shape_init(lambda s: _normal(math.sqrt(2.0 / sum(_fans_deconv(s)))))


def torch_default_conv() -> Initializer:
    """torch Conv2d default: kaiming_uniform(a=sqrt(5)) => U(+-1/sqrt(fan_in))."""
    return _shape_init(lambda s: _uniform(1.0 / math.sqrt(_fans_conv(s)[0])))


def torch_default_deconv() -> Initializer:
    return _shape_init(lambda s: _uniform(1.0 / math.sqrt(_fans_deconv(s)[0])))


def uniform_bias(fan_in: int) -> Initializer:
    return _uniform(1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def kaiming_normal_linear(a: float = 0.0) -> Initializer:
    """He-normal for (out, in) linear weights, fan_in = in."""
    return _shape_init(lambda s: _normal(_leaky_gain(a) / math.sqrt(s[1])))


def xavier_normal_linear() -> Initializer:
    return _shape_init(lambda s: _normal(math.sqrt(2.0 / (s[0] + s[1]))))


def torch_default_linear() -> Initializer:
    return _shape_init(lambda s: _uniform(1.0 / math.sqrt(s[1])))


def normal(std: float) -> Initializer:
    """N(0, std^2), whatever the shape (the classifier head's N(0, 0.01))."""
    return _normal(std)


def he_ssd_conv() -> Initializer:
    """MobileNetV2's explicit He re-init of an OIHW conv weight:
    N(0, sqrt(2 / (kh * kw * out))) (reference: MobileNetV2.py:225-233);
    a depthwise weight (C, 1, kh, kw) has out = C."""
    return _shape_init(lambda s: _normal(math.sqrt(2.0 / (s[2] * s[3] * s[0]))))


def conv_kernel_init(init_name, activation_slope: float) -> Initializer:
    """Dispatch matching the reference's ``weight_initialization``
    (reference: ModificationLayer.py:26-52): 'kaiming' uses the activation's
    negative slope; None falls back to torch's default layer init."""
    if init_name is None:
        return torch_default_conv()
    if init_name == "kaiming":
        return kaiming_normal_conv(activation_slope)
    if init_name == "xavier":
        return xavier_normal_conv()
    raise ValueError(f"unknown init {init_name!r}")


def deconv_kernel_init(init_name, activation_slope: float) -> Initializer:
    if init_name is None:
        return torch_default_deconv()
    if init_name == "kaiming":
        return kaiming_normal_deconv(activation_slope)
    if init_name == "xavier":
        return xavier_normal_deconv()
    raise ValueError(f"unknown init {init_name!r}")
