"""The plain reference's layer calls, over a dict of weights by name.

A :class:`Net` runs in one of two modes:

* spec mode (``weights=None``): each layer call records the name, shape
  and initial scale of its parameters in ``spec`` and computes on the
  ``meta`` device, so one forward at batch 1 lists every parameter of a
  model without allocating it;
* compute mode: each call reads its parameters from ``weights``.

Either way every conv, transposed conv and linear call appends a
:class:`Call` to ``calls`` with the products it needs, counted from its
shapes (``bench_h100/counts`` turns them into FLOPs).

``rounding`` (compute mode): a function applied to each conv and linear
layer's input and weight before the product, with a straight-through
gradient; where it has a ``grad`` attribute, that function is applied
in the same way to the gradient reaching the layer's output, the operand
of the backward products. The lower-precision control of ``correct``
passes one (fp8 or bf16 rounding); the reference itself passes none and
computes in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

SQRT2 = math.sqrt(2.0)
PLAIN = 1.0 / math.sqrt(3.0)  # the variance of torch's default uniform init
BN_EPS = 1e-5


@dataclasses.dataclass
class Call:
    kind: str  # conv | deconv | linear
    name: str
    products: int  # multiply-adds the call needs, per batch
    input_grad: bool  # whether its input requires a gradient


@dataclasses.dataclass
class Leaf:
    shape: Tuple[int, ...]
    std: Optional[float]  # normal(0, std) when set
    const: Optional[float]  # a constant fill when set
    dtype: torch.dtype = torch.float32


def pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def conv_taps(n_in: int, n_out: int, k: int, s: int, p: int) -> int:
    """(output, tap) pairs of a conv along one axis whose input lies
    inside the image (zero padding needs no product)."""
    return sum(1 for o in range(n_out) for t in range(k) if 0 <= o * s - p + t < n_in)


def deconv_taps(n_in: int, n_out: int, k: int, s: int, p: int) -> int:
    """(input, tap) pairs of a transposed conv along one axis whose output
    lies inside the image: the products it needs, whichever way it is
    computed (input-dilated or by phases)."""
    return sum(1 for i in range(n_in) for t in range(k) if 0 <= i * s - p + t < n_out)


def round_ste(t: torch.Tensor, rounding: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    return t + (rounding(t.detach()) - t.detach())


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient (with a
    straight-through gradient of its own, for double backward)."""

    @staticmethod
    def forward(ctx, t, rounding):
        ctx.rounding = rounding
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return round_ste(g, ctx.rounding), None


class Net:
    def __init__(self, weights: Optional[Dict[str, torch.Tensor]] = None,
                 rounding: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.weights = weights
        self.rounding = rounding
        self.spec: Dict[str, Leaf] = {}
        self.calls: List[Call] = []

    @property
    def spec_mode(self) -> bool:
        return self.weights is None

    def param(self, name: str, shape: Sequence[int], std: Optional[float] = None,
              const: Optional[float] = None, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        shape = tuple(int(s) for s in shape)
        if self.spec_mode:
            self.spec[name] = Leaf(shape, std, const, dtype)
            t = torch.zeros(shape, device="meta", dtype=dtype)
            return t.requires_grad_(dtype.is_floating_point and const is None)
        t = self.weights[name]
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: weights hold {tuple(t.shape)}, the reference needs {shape}")
        return t

    def _r(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.rounding is None else round_ste(t, self.rounding)

    def _g(self, y: torch.Tensor) -> torch.Tensor:
        grad = getattr(self.rounding, "grad", None)
        return y if grad is None or not y.requires_grad else _RoundGrad.apply(y, grad)

    def conv(self, x: torch.Tensor, name: str, cout: int, k, stride=1, padding=0,
             bias: bool = True, gain: float = SQRT2, groups: int = 1,
             std: Optional[float] = None) -> torch.Tensor:
        """``padding``: an int or (ph, pw) of zeros, or (left, right, top,
        bottom) of reflection. The weight is drawn with ``gain`` over the
        square root of its mean fan-in, or with ``std`` when given (the
        bias is then 0)."""
        kh, kw = pair(k)
        sh, sw = pair(stride)
        cin = x.shape[1]
        if isinstance(padding, (tuple, list)) and len(padding) == 4:
            x = F.pad(x, tuple(padding), mode="reflect")
            ph = pw = 0
        else:
            ph, pw = pair(padding)
        n, _, hin, win = x.shape
        hout, wout = (hin + 2 * ph - kh) // sh + 1, (win + 2 * pw - kw) // sw + 1
        taps = conv_taps(hin, hout, kh, sh, ph) * conv_taps(win, wout, kw, sw, pw)
        products = n * cout * (cin // groups) * taps
        fan_in = max(products / (n * cout * hout * wout), 1.0)
        w = self.param(f"{name}.weight", (cout, cin // groups, kh, kw),
                       std=gain / math.sqrt(fan_in) if std is None else std)
        b = None
        if bias:
            b = (self.param(f"{name}.bias", (cout,), std=PLAIN / math.sqrt(fan_in)) if std is None
                 else self.param(f"{name}.bias", (cout,), const=0.0))
        self.calls.append(Call("conv", name, products, bool(x.requires_grad)))
        return self._g(F.conv2d(self._r(x), self._r(w), b, (sh, sw), (ph, pw), groups=groups))

    def deconv(self, x: torch.Tensor, name: str, cout: int, k, stride=1, padding=0,
               output_padding=0, bias: bool = True, gain: float = SQRT2) -> torch.Tensor:
        kh, kw = pair(k)
        sh, sw = pair(stride)
        ph, pw = pair(padding)
        oh, ow = pair(output_padding)
        n, cin, hin, win = x.shape
        hout = (hin - 1) * sh - 2 * ph + kh + oh
        wout = (win - 1) * sw - 2 * pw + kw + ow
        taps = deconv_taps(hin, hout, kh, sh, ph) * deconv_taps(win, wout, kw, sw, pw)
        products = n * cin * cout * taps
        fan_in = max(products / (n * cout * hout * wout), 1.0)
        w = self.param(f"{name}.weight", (cin, cout, kh, kw), std=gain / math.sqrt(fan_in))
        b = self.param(f"{name}.bias", (cout,), std=PLAIN / math.sqrt(fan_in)) if bias else None
        self.calls.append(Call("deconv", name, products, bool(x.requires_grad)))
        return self._g(F.conv_transpose2d(self._r(x), self._r(w), b, (sh, sw), (ph, pw),
                                          (oh, ow)))

    def linear(self, x: torch.Tensor, name: str, cout: int, bias: bool = True,
               gain: float = PLAIN) -> torch.Tensor:
        n, cin = x.shape
        w = self.param(f"{name}.weight", (cout, cin), std=gain / math.sqrt(cin))
        b = self.param(f"{name}.bias", (cout,), std=PLAIN / math.sqrt(cin)) if bias else None
        self.calls.append(Call("linear", name, n * cin * cout, bool(x.requires_grad)))
        return self._g(F.linear(self._r(x), self._r(w), b))

    def bn_leaves(self, name: str, c: int) -> Tuple[torch.Tensor, ...]:
        """BatchNorm's weight (1), bias (0) and running statistics (0, 1)."""
        return (self.param(f"{name}.weight", (c,), const=1.0),
                self.param(f"{name}.bias", (c,), const=0.0),
                self.param(f"{name}.running_mean", (c,), const=0.0),
                self.param(f"{name}.running_var", (c,), const=1.0),
                self.param(f"{name}.num_batches_tracked", (), const=0, dtype=torch.int64))

    def batchnorm(self, x: torch.Tensor, name: str, train: bool) -> torch.Tensor:
        """BatchNorm2d (eps 1e-5): batch statistics with the biased variance
        in train mode, the running ones in eval mode. Running statistics
        are not advanced (nothing the reference compares reads them)."""
        w, b, rm, rv, _n = self.bn_leaves(name, x.shape[1])
        if train:
            var, mean = torch.var_mean(x, dim=(0, 2, 3), unbiased=False)
        else:
            mean, var = rm, rv
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * w.view(shape) \
            + b.view(shape)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


def relu6(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 6.0)
