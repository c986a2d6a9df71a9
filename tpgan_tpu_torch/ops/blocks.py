"""Core building blocks — the port of ``tpgan_tpu/ops/blocks.py`` (itself
a re-design of the reference layer factory, ModificationLayer.py:5-301).

Semantics kept from the JAX blocks (each held against them in
tests/test_torch_blocks.py):

* ``bias = not use_batchnorm`` (ModificationLayer.py:98,187,221).
* Norm/activation ordering: saturating activations (sigmoid/tanh) come
  *before* BatchNorm, everything else after (ModificationLayer.py:141-151).
* 4-element padding means reflection padding (left, right, top, bottom)
  with the conv itself unpadded (ModificationLayer.py:83-96).
* ResidualBlock: default out = in // stride, default padding (k-1)//2,
  output = act(main(x) + scaling_factor * shortcut(x)); an identity
  shortcut with in != out or stride != 1 is rejected, as in the JAX block.

PyTorch layout: NCHW activations, OIHW conv weights, IOHW transposed-conv
weights, (out, in) linear weights, and BatchNorm buffers named
``running_mean`` / ``running_var`` — so reference-layout state_dicts load.
Parameter names follow the JAX tree (``conv``, ``deconv``, ``bn``,
``conv0``...), which keeps :mod:`tpgan_tpu_torch.convert` a mechanical walk.

Compute dtype: each conv, transposed conv and linear layer casts its
input *and* its weight (and bias) to ``compute_dtype`` inside
``forward``, as every JAX layer casts to its module ``dtype``
(``tpgan_tpu/ops/blocks.py:131,162,178``). Parameters stay float32, so
autograd hands the optimizer float32 gradients of float32 masters. The
attribute is ``None`` by default, meaning the weight's own dtype: the
serving path (``train.gan_trainer.make_synthesize_fn``) casts a copy of
the weights once instead. :func:`set_compute_dtype` sets it on a whole
model. The bias is added by the conv itself (one rounding), where the
JAX conv adds it after rounding the product to the compute dtype; in
float32 the two agree to the last bits.

BatchNorm always normalises in float32 and casts back. In train mode it
normalises with the biased batch variance and advances the running
statistics with momentum 0.1 and the unbiased variance
(``tpgan_tpu/ops/blocks.py:437-451``); inside
:func:`frozen_batch_stats` a train-mode forward normalises the same way
but leaves the running statistics untouched — the critic's fake, GP and
G-phase passes (``tpgan_tpu/train/gan_trainer.py:273-282,311``).

Left out of this port, on purpose:

* ``accum_f32`` (JAX's f32-emitting MXU conv) — torch/cuDNN accumulate
  in f32 and round once on output either way; the option is omitted.
* ``pad_in_multiple`` (TPU lane alignment) — it changes the stored kernel
  shapes, so ``build_generator`` rejects ``G.pad_channel_multiple``.
* The int8 post-training-quantization hooks (``ops/quant.py``) — a later
  slice of the port.
* ``pre_activation``: no layer of the port uses it. ``Conv2d`` takes
  ``bias_init`` (the detector's SSD head and extra layers start their
  biases at zero); the other layers keep torch's uniform bias.
  ``Conv2d(groups=...)`` is
  here (the embedders' depthwise convs, ``groups == in_channels``) and,
  as JAX hands its grouped convs to XLA, goes to cuDNN through
  ``F.conv2d(groups=...)``; its fan-in is ``in_channels / groups``.
* The subpixel phase decomposition: ``"subpixel"`` maps onto the same
  ``conv_transpose2d`` as ``"deconv"`` (same math, same parameters).
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgan_tpu_torch.ops import initializers as init_lib
from tpgan_tpu_torch.ops.activations import (
    Activation,
    apply_activation,
    is_saturating,
    negative_slope,
)
from tpgan_tpu_torch.ops.resize import resize

Padding = Union[int, Tuple[int, int], Tuple[int, int, int, int]]


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


def _canon_padding(padding: Padding):
    """Reference-style padding -> (reflect_lrtb | None, (pad_h, pad_w))."""
    if isinstance(padding, int):
        return None, (padding, padding)
    padding = tuple(padding)
    if len(padding) == 2:  # torch (padH, padW)
        return None, padding
    if len(padding) == 4:  # reference list => ReflectionPad2d(l,r,t,b)
        return padding, (0, 0)
    raise ValueError(f"padding must have 1, 2 or 4 elements, got {padding}")


def reflect_pad(x: torch.Tensor, lrtb: Sequence[int]) -> torch.Tensor:
    """ReflectionPad2d, torch's (left, right, top, bottom) order, NCHW."""
    return F.pad(x, tuple(lrtb), mode="reflect")


def _cast(layer: nn.Module, x: torch.Tensor):
    """(input, weight, bias) in the layer's compute dtype (the weight's
    dtype when none is set)."""
    dtype = layer.compute_dtype
    if dtype is None or dtype == layer.weight.dtype:  # the serving copy: no cast
        return x.to(layer.weight.dtype), layer.weight, layer.bias
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return x.to(dtype), layer.weight.to(dtype), bias


class Conv2d(nn.Module):
    """Conv with torch-default init and reference padding forms; OIHW,
    (out, in / groups, kh, kw) when grouped."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]],
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Padding = 0,
        use_bias: bool = True,
        kernel_init=None,
        groups: int = 1,
        device=None,
        bias_init=None,
    ):
        super().__init__()
        kh, kw = _pair(kernel_size)
        if in_channels % groups or out_channels % groups:
            raise ValueError(f"groups={groups} must divide in_channels={in_channels} and "
                             f"out_channels={out_channels}")
        self.stride = _pair(stride)
        self.groups = groups
        self.reflect, self.padding = _canon_padding(padding)
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels // groups, kh, kw, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty(out_channels, device=device)) if use_bias else None
        )
        self._kernel_init = kernel_init or init_lib.torch_default_conv()
        self._bias_init = bias_init or init_lib.uniform_bias(kh * kw * in_channels // groups)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self._kernel_init(self.weight, generator)
        if self.bias is not None:
            self._bias_init(self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self, x)
        if self.reflect is not None:
            x = reflect_pad(x, self.reflect)
        return F.conv2d(x, w, b, self.stride, self.padding, groups=self.groups)


class ConvTranspose2d(nn.Module):
    """torch ConvTranspose2d(k, s, p, output_padding); weight IOHW
    (in, out, kh, kw), the layout the JAX kernel (kh, kw, in, out) maps to
    without a flip (reference usage: D_and_G_model.py:218-220 —
    deconv_8's k8-from-1x1 and deconv_32's stride 4)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]],
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Union[int, Tuple[int, int]] = 0,
        output_padding: Union[int, Tuple[int, int]] = 0,
        use_bias: bool = True,
        kernel_init=None,
        device=None,
    ):
        super().__init__()
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.weight = nn.Parameter(
            torch.empty(in_channels, out_channels, kh, kw, device=device)
        )
        self.bias = (
            nn.Parameter(torch.empty(out_channels, device=device)) if use_bias else None
        )
        self._kernel_init = kernel_init or init_lib.torch_default_deconv()
        # torch ConvTranspose2d bias bound uses fan_in = out*kh*kw
        self._bias_init = init_lib.uniform_bias(kh * kw * out_channels)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self._kernel_init(self.weight, generator)
        if self.bias is not None:
            self._bias_init(self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _cast(self, x)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding)


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm2d (eps 1e-5, momentum 0.1) that normalises in f32
    and casts back to the input dtype, as the JAX BatchNorm2d does
    (``tpgan_tpu/ops/blocks.py:435-457``). Eval mode normalises with the
    running statistics. Train mode normalises with the batch statistics
    (biased variance) and advances the running ones (momentum 0.1,
    unbiased variance) unless ``advance_stats`` is False, which
    :func:`frozen_batch_stats` sets."""

    advance_stats: bool = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training and not self.advance_stats:
            # the advancing pass's op on copies of the statistics: it saves
            # the same tensors for backward, which torch.utils.checkpoint
            # asks of a recompute (train/gan_trainer.py's remat)
            y = F.batch_norm(x32, self.running_mean.clone(), self.running_var.clone(),
                             self.weight, self.bias, True, self.momentum, self.eps)
        else:
            y = super().forward(x32)
        return y.to(x.dtype)


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module) -> Iterator[None]:
    """Within the block, train-mode forwards of ``module`` normalise with
    their own batch statistics but advance no running statistics (the
    JAX step discards those passes' ``batch_stats`` mutations). Blocks
    nest: leaving one restores what was set before it (a rematerialised
    pass recomputes inside it, ``train/gan_trainer.py``)."""
    bns = [m for m in module.modules() if isinstance(m, BatchNorm2d)]
    before = [bn.advance_stats for bn in bns]
    for bn in bns:
        bn.advance_stats = False
    try:
        yield
    finally:
        for bn, advance in zip(bns, before):
            bn.advance_stats = advance


def _norm_act(bn: Optional[BatchNorm2d], h: torch.Tensor, act: Activation) -> torch.Tensor:
    if bn is None:
        return apply_activation(h, act)
    if is_saturating(act):
        return bn(apply_activation(h, act))
    return apply_activation(bn(h), act)


class ConvBlock(nn.Module):
    """conv + optional BatchNorm + activation, with the reference's
    ordering rules (reference: ModificationLayer.py:54-156)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]],
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Padding = 0,
        weight_init: Optional[str] = "kaiming",
        activation: Activation = ("relu", 0.0),
        use_batchnorm: bool = False,
        device=None,
    ):
        super().__init__()
        self.activation = activation
        self.conv = Conv2d(
            in_channels, out_channels, kernel_size, stride, padding,
            use_bias=not use_batchnorm,
            kernel_init=init_lib.conv_kernel_init(weight_init, negative_slope(activation)),
            device=device,
        )
        self.bn = BatchNorm2d(out_channels, device=device) if use_batchnorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_act(self.bn, self.conv(x), self.activation)


class DeconvBlock(nn.Module):
    """Upsampler + optional BatchNorm + activation
    (reference: ModificationLayer.py:158-202).

    ``mode``: ``"deconv"`` (reference parity) and ``"subpixel"`` are the same
    transposed conv with the same parameters (``deconv``); ``"resize_conv"``
    is a nearest repeat to the transposed conv's output size (a nearest
    resize, ``ops.resize``, where a ratio is not an integer) followed by a
    3x3 stride-1 conv (parameters ``conv``) — the JAX block's
    checkerboard-artifact fix."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: Union[int, Tuple[int, int]],
        stride: Union[int, Tuple[int, int]] = 1,
        padding: Union[int, Tuple[int, int]] = 0,
        output_padding: Union[int, Tuple[int, int]] = 0,
        weight_init: Optional[str] = "kaiming",
        activation: Activation = ("relu", 0.0),
        use_batchnorm: bool = False,
        mode: str = "deconv",
        device=None,
    ):
        super().__init__()
        self.activation = activation
        self.mode = mode
        slope = negative_slope(activation)
        if mode == "resize_conv":
            # torch ConvTranspose2d output length = (n-1)*s - 2p + k + op
            self._geom = tuple(
                zip(_pair(kernel_size), _pair(stride), _pair(padding), _pair(output_padding))
            )
            self.conv = Conv2d(
                in_channels, out_channels, 3, 1, 1,
                use_bias=not use_batchnorm,
                kernel_init=init_lib.conv_kernel_init(weight_init, slope),
                device=device,
            )
        elif mode in ("deconv", "subpixel"):
            self.deconv = ConvTranspose2d(
                in_channels, out_channels, kernel_size, stride, padding,
                output_padding,
                use_bias=not use_batchnorm,
                kernel_init=init_lib.deconv_kernel_init(weight_init, slope),
                device=device,
            )
        else:
            raise ValueError(f"unknown DeconvBlock mode {mode!r}")
        self.bn = BatchNorm2d(out_channels, device=device) if use_batchnorm else None

    def _upsample(self, h: torch.Tensor) -> torch.Tensor:
        if self.mode != "resize_conv":
            return self.deconv(h)
        out_hw = [(n - 1) * s - 2 * p + k + op
                  for n, (k, s, p, op) in zip(h.shape[2:], self._geom)]
        if all(out % n == 0 for n, out in zip(h.shape[2:], out_hw)):
            for dim, (n, out) in enumerate(zip(h.shape[2:], out_hw), start=2):
                h = h.repeat_interleave(out // n, dim=dim)
        else:  # a fractional ratio: JAX's nearest resize (tpgan_tpu/ops/blocks.py:587-590)
            h = resize(h, (*h.shape[:2], *out_hw), "nearest")
        return self.conv(h)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm_act(self.bn, self._upsample(x), self.activation)


class LinearBlock(nn.Module):
    """Linear + optional BatchNorm + activation
    (reference: ModificationLayer.py:204-231). Weight stored (out, in)."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(
        self,
        in_features: int,
        out_features: int,
        activation: Activation = None,
        use_batchnorm: bool = False,
        kernel_init=None,
        device=None,
    ):
        super().__init__()
        self.activation = activation
        self.weight = nn.Parameter(torch.empty(out_features, in_features, device=device))
        self.bias = (
            None if use_batchnorm
            else nn.Parameter(torch.empty(out_features, device=device))
        )
        self.bn = BatchNorm2d(out_features, device=device) if use_batchnorm else None
        self._kernel_init = kernel_init or init_lib.torch_default_linear()
        self._bias_init = init_lib.uniform_bias(in_features)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        self._kernel_init(self.weight, generator)
        if self.bias is not None:
            self._bias_init(self.bias, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(*_cast(self, x))
        if self.bn is not None:
            y = self.bn(y[:, :, None, None])[:, :, 0, 0]
        return apply_activation(y, self.activation)


class ResidualBlock(nn.Module):
    """Two-conv (or three-conv bottleneck) residual block
    (reference: ModificationLayer.py:233-301).

    out = act( main(x) + scaling_factor * shortcut(x) )

    The shortcut is a 1x1 projection conv only when ``use_projection`` is
    passed; an identity shortcut needs in == out and stride == 1.
    """

    def __init__(
        self,
        in_channels: int,
        out_channels: Optional[int] = None,
        kernel_size: int = 3,
        stride: int = 1,
        padding: Optional[Padding] = None,
        weight_init: Optional[str] = "kaiming",
        activation: Activation = ("relu", 0.0),
        is_bottleneck: bool = False,
        use_projection: bool = False,
        scaling_factor: float = 1.0,
        use_batchnorm: bool = False,
        device=None,
    ):
        super().__init__()
        out_ch = in_channels // stride if out_channels is None else out_channels
        pad = (kernel_size - 1) // 2 if padding is None else padding
        if not use_projection and (out_ch != in_channels or stride != 1):
            raise ValueError(
                "identity shortcut needs in==out and stride==1 "
                f"(got in={in_channels}, out={out_ch}, stride={stride}); "
                "pass use_projection=True — the reference would fail at "
                "runtime here too (ModificationLayer.py:281-283)"
            )
        self.activation = activation
        self.scaling_factor = scaling_factor
        common = dict(use_batchnorm=use_batchnorm, device=device)
        if is_bottleneck:
            self.conv0 = ConvBlock(
                in_channels, in_channels // 2, 1, 1, 0, weight_init, activation, **common
            )
            self.conv1 = ConvBlock(
                in_channels // 2, out_ch // 2, kernel_size, stride,
                (kernel_size - 1) // 2, weight_init, activation, **common,
            )
            self.conv2 = ConvBlock(out_ch // 2, out_ch, 1, 1, 0, None, None, **common)
        else:
            self.conv0 = ConvBlock(
                in_channels, in_channels, kernel_size, 1, pad, weight_init,
                activation, **common,
            )
            self.conv1 = ConvBlock(
                in_channels, out_ch, kernel_size, 1, pad, None, None, **common
            )
            self.conv2 = None
        self.shortcut = (
            ConvBlock(in_channels, out_ch, 1, stride, 0, weight_init, None, device=device)
            if use_projection else None
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.conv0(x))
        if self.conv2 is not None:
            h = self.conv2(h)
        sc = x if self.shortcut is None else self.shortcut(x)
        return apply_activation(
            torch.add(h, sc.to(h.dtype), alpha=self.scaling_factor), self.activation
        )


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]) -> nn.Module:
    """Set the compute dtype of every conv, transposed conv and linear
    layer under ``module`` (``None``: the weight's dtype). Parameters
    keep their dtype; BatchNorm stays float32."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, LinearBlock)):
            m.compute_dtype = dtype
    return module


def reset_parameters(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Re-draw every conv, transposed-conv and linear weight under
    ``module`` from ``generator``, in registration order."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, LinearBlock)):
            m.reset_parameters(generator)


def dropout(
    x: torch.Tensor,
    rate: float,
    use_dropout: bool,
    generator: Optional[torch.Generator] = None,
    keep_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """JAX's ``nn.Dropout(rate, deterministic=not use_dropout)``: ``x``
    itself when off or at rate 0, else :func:`apply_dropout` with
    ``keep_mask``, drawn from ``generator`` when none is given."""
    if not use_dropout or rate == 0.0:
        return x
    if keep_mask is None:
        if generator is None:
            raise ValueError(
                "use_dropout=True needs a torch.Generator or a keep_mask; "
                "the port draws no randomness from torch's global RNG"
            )
        keep_mask = dropout_keep_mask(x.shape, rate, generator, x.device)
    return apply_dropout(x, keep_mask, rate)


def dropout_keep_mask(
    shape, rate: float, generator: torch.Generator, device=None
) -> torch.Tensor:
    """Boolean keep-mask, each element kept with probability 1 - rate."""
    return torch.rand(shape, generator=generator, device=device) < (1.0 - rate)


def apply_dropout(x: torch.Tensor, keep_mask: torch.Tensor, rate: float) -> torch.Tensor:
    """JAX's ``nn.Dropout``: ``where(mask, x / keep, 0)``. The JAX divisor
    is the Python float ``keep`` taken in ``x``'s dtype, so it is rounded
    to that dtype here too (0.69921875 in bfloat16)."""
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    if keep_mask.shape != x.shape:
        raise ValueError(f"keep_mask {tuple(keep_mask.shape)} != input {tuple(x.shape)}")
    return torch.where(keep_mask.to(device=x.device, dtype=torch.bool), x / keep,
                       torch.zeros((), dtype=x.dtype, device=x.device))
