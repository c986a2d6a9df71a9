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

PyTorch layout: NCHW-shaped activations, OIHW conv weights, IOHW
transposed-conv weights, (out, in) linear weights, and BatchNorm buffers
named ``running_mean`` / ``running_var`` — so reference-layout state_dicts
load. Parameter names follow the JAX tree (``conv``, ``deconv``, ``bn``,
``conv0``...), which keeps :mod:`tpgan_tpu_torch.convert` a mechanical walk.

Memory layout, one rule keyed on a conv's compute dtype
(:func:`conv_memory_format`): a bf16 (or fp16) conv or transposed conv
reads its input and weight channels-last (NHWC in memory) and writes
channels-last, since cuDNN's half-precision tensor-core convs on sm90 are
NHWC kernels and transpose NCHW operands in and out of every fprop,
dgrad and wgrad. Its input is converted only where it arrives in another
layout (``ops.kernels.to_memory_format``, counted in
``ops.kernels.layout_counts()``); its weight is cast straight into the
layout (``_WeightCast``, whose backward hands the parameter a contiguous
gradient). Any other conv (f32, f64) takes its input as it arrives and
its weight as stored, as before: the port hands them contiguous NCHW
(the GAN entries of an f32 model, the detector's batches, the identity
embedder's cast in the GAN step). Elementwise ops, ``torch.cat``,
BatchNorm, the reflect pad and the K1 / K2 wrappers carry the layout
along, so a bf16 model stays channels-last from its entry to its exit.
Parameters and ``state_dict`` values stay contiguous float32;
:func:`compute_copy` stores a serving copy's half-precision conv weights
channels-last. A layer sharded over a model axis (``tp``) runs as
before, in whatever layout arrives.

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
* ``pre_activation``: no layer of the port uses it. ``Conv2d`` takes
  ``bias_init`` (the detector's SSD head and extra layers start their
  biases at zero); the other layers keep torch's uniform bias.
  ``Conv2d(groups=...)`` is
  here (the embedders' depthwise convs, ``groups == in_channels``) and,
  as JAX hands its grouped convs to XLA, goes to cuDNN through
  ``F.conv2d(groups=...)``; its fan-in is ``in_channels / groups``.
* The subpixel phase decomposition in float: ``"subpixel"`` maps onto the
  same ``conv_transpose2d`` as ``"deconv"`` (same math, same parameters).
  Only the int8 path takes the phase weights (:func:`subpixel_weights`),
  because the two algorithms quantize different tensors.

Tensor parallelism (``parallel/tensor_parallel.py``): a ``Conv2d``,
``ConvTranspose2d`` or ``LinearBlock`` whose weight a mesh's model axis
shards holds its slice and its placement (``tp``) and runs the column- or
row-parallel form of its op; with no placement it runs the code above
unchanged. Synced BatchNorm runs over the mesh's data group only.

Post-training quantization (``ops/quant.py``): ``Conv2d`` and
``ConvTranspose2d`` carry a quant mode (``quant.quant_mode``). In
``calib`` a conv records the absmax of its input — after the cast to the
compute dtype and the reflect pad for ``Conv2d``, the cast input before
any padding for ``ConvTranspose2d`` (``tpgan_tpu/ops/blocks.py:139-141,
320-322``) — and runs in float. In ``int8`` a conv prepared by
``quant.prepare_int8`` (where ``quant.should_quantize`` takes it) runs
as int8 x int8 -> int32 (``quant.int8_program``): ``Conv2d`` over its
OIHW weight; ``ConvTranspose2d``
over its flipped kernel on the input dilated by the stride, or, in
``subpixel`` mode where the JAX block's test admits it, over the phase
weights followed by a depth-to-space; the bias is added after the
rescale, in the rescale dtype, and the result cast to the compute dtype
(``:172-178``).
"""

from __future__ import annotations

import contextlib
import copy
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
from tpgan_tpu_torch.ops.kernels import is_channels_last, to_memory_format
from tpgan_tpu_torch.ops.resize import resize
from tpgan_tpu_torch.parallel import tensor_parallel
from tpgan_tpu_torch.parallel.collectives import all_reduce_sum

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
    """ReflectionPad2d, torch's (left, right, top, bottom) order, NCHW. A
    channels-last x is padded as the (B, 1, H, W, C) view it is in memory
    (a 3-D reflect pad, C unpadded), so the result stays channels-last on
    every device: CUDA's 2-D reflect pad writes contiguous NCHW."""
    if is_channels_last(x):
        left, right, top, bottom = lrtb
        y = F.pad(x.permute(0, 2, 3, 1).unsqueeze(1), (0, 0, left, right, top, bottom),
                  mode="reflect")
        return y.squeeze(1).permute(0, 3, 1, 2)
    return F.pad(x, tuple(lrtb), mode="reflect")


# The quant modes of a conv layer (``ops/quant.py``'s ``quant_mode``)
CALIB = "calib"
INT8 = "int8"

# ``cfg.compute_dtype`` -> torch dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class _Quantizable(nn.Module):
    """The post-training-quantization state of a conv layer, which
    ``ops/quant.py`` sets: ``quant_mode`` (None, ``CALIB`` or ``INT8``), the
    calibrated input absmax and the two ``quant.quant_config`` knobs.
    ``quant.prepare_int8`` quantizes the weight once: the layer then holds
    its int8 program as the child ``int8`` (None where the knobs keep it
    float) and ``quant_prepared`` is set."""

    quant_mode: Optional[str] = None
    quant_absmax: Optional[torch.Tensor] = None
    quant_rescale_dtype: torch.dtype = torch.float32
    quant_min_channels: int = 0
    quant_prepared: bool = False
    tp = None  # its placement on a mesh's model axis (parallel.tensor_parallel)

    def _quant_forward(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The quant mode's part of a forward, on the cast (and padded)
        input: in ``CALIB`` the running absmax of ``x`` is recorded and None
        returned (the float conv follows); in ``INT8`` the prepared int8
        program's output, or None where the layer stays float. A layer
        sharded over a model axis is refused: JAX's serving takes no
        mesh."""
        if self.tp is not None:
            raise ValueError("post-training quantization of a layer sharded over a mesh's "
                             "model axis: quantize the single-device model "
                             "(parallel.tensor_parallel.unsharded_copy)")
        if self.quant_mode == CALIB:
            m = x.detach().abs().amax().float()
            prev = self.quant_absmax
            self.quant_absmax = m if prev is None else torch.maximum(prev, m)
            return None
        if not self.quant_prepared:
            raise ValueError("int8 mode on a conv whose weight is not quantized: "
                             "quant.prepare_int8 (or quant.make_int8_model) prepares it")
        return None if self.int8 is None else self.int8(x)


def _cast(layer: nn.Module, x: torch.Tensor):
    """(input, weight, bias) in the layer's compute dtype (the weight's
    dtype when none is set)."""
    dtype = layer.compute_dtype
    if dtype is None or dtype == layer.weight.dtype:  # the serving copy: no cast
        return x.to(layer.weight.dtype), layer.weight, layer.bias
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return x.to(dtype), layer.weight.to(dtype), bias


_HALF = (torch.bfloat16, torch.float16)


def conv_memory_format(dtype: torch.dtype) -> torch.memory_format:
    """The layout of a conv in ``dtype``: channels-last for bf16 and fp16,
    contiguous NCHW for any other dtype (module docstring)."""
    return torch.channels_last if dtype in _HALF else torch.contiguous_format


class _WeightCast(torch.autograd.Function):
    """``w.to(dtype, memory_format=torch.channels_last)`` whose backward
    casts the gradient back to ``w``'s dtype as a contiguous tensor, one op
    each way. A plain ``.to`` would hand the contiguous parameter a
    channels-last gradient (the optimizers' foreach updates take their
    per-tensor path on mixed strides). Its backward is a cast, so it
    differentiates again."""

    @staticmethod
    def forward(ctx, w, dtype):
        ctx.dtype = w.dtype
        return w.to(dtype, memory_format=torch.channels_last)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype, memory_format=torch.contiguous_format), None


def _conv_cast(layer: nn.Module, x: torch.Tensor):
    """:func:`_cast` for a conv. A half-precision conv on one device (no
    ``tp``) takes its input and weight channels-last: the input converted
    only where it arrives otherwise (``ops.kernels.to_memory_format``,
    counted), the weight cast straight into the layout (:class:`_WeightCast`)
    unless stored so (:func:`compute_copy`). Any other conv, and an
    int8-prepared layer (its float weight an empty placeholder), is
    :func:`_cast`'s, as before."""
    w = layer.weight
    dtype = layer.compute_dtype or w.dtype
    if dtype not in _HALF or layer.tp is not None or w.dim() != 4:
        return _cast(layer, x)
    if w.dtype != dtype or not w.is_contiguous(memory_format=torch.channels_last):
        w = _WeightCast.apply(w, dtype)
    b = layer.bias
    if b is not None and b.dtype != dtype:
        b = b.to(dtype)
    return to_memory_format(x.to(dtype), torch.channels_last), w, b


class Conv2d(_Quantizable):
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
        self.in_channels, self.out_channels = in_channels, out_channels
        self.quant_in_per_group, self.quant_out = in_channels // groups, out_channels
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
        x, w, b = _conv_cast(self, x)
        if self.reflect is not None:
            x = reflect_pad(x, self.reflect)
        if self.quant_mode is not None:
            y = self._quant_forward(x)
            if y is not None:
                return y
        if self.tp is not None:
            return tensor_parallel.conv2d(self.tp, x, w, b, self.stride, self.padding,
                                          self.groups)
        return F.conv2d(x, w, b, self.stride, self.padding, groups=self.groups)


def subpixel_plan(k: int, s: int, p: int, op: int):
    """Per-axis phase plan of the exact transposed-conv decomposition, a
    copy of ``tpgan_tpu/ops/blocks.py::_subpixel_plan``. In the
    dilated-forward-conv view the dilated input is non-zero only at
    ``padlo + s*i`` (padlo = k-1-p), so an output at ``s*m+r`` touches the
    kernel taps ``ky = (padlo-r) (mod s)``, each reading ``x[m +
    (r+ky-padlo)//s]``. Returns ``(taps, lo, hi, win, extra)``: ``taps[r]`` lists
    ``(kernel_tap, input_offset)`` of phase r; pad the input by (lo, hi),
    run a ``win``-wide VALID conv, and each phase yields ``H + extra``
    outputs."""
    padlo = k - 1 - p
    taps, offs = [], []
    for r in range(s):
        t = [(ky, (r + ky - padlo) // s) for ky in range((padlo - r) % s, k, s)]
        taps.append(t)
        offs += [d for _, d in t]
    dmin = min(offs) if offs else 0
    dmax = max(offs) if offs else 0
    lo = max(0, -dmin)
    extra = (k + op - 2 * p) // s - 1
    hi = dmax + extra
    win = lo + dmax + 1
    return taps, lo, hi, win, extra


def subpixel_weights(wf: torch.Tensor, taps_h, lo_h: int, win_h: int, taps_w, lo_w: int,
                     win_w: int) -> torch.Tensor:
    """A flipped transposed-conv kernel (kh, kw, cin, cout) rearranged into
    the stride-1 conv weight (win_h, win_w, cin, sh*sw*cout) of the
    subpixel decomposition, phase-major output blocks (the depth-to-space
    order): ``tpgan_tpu/ops/blocks.py::_subpixel_weights``, element for
    element (pure placement, no arithmetic)."""
    cin, cout = wf.shape[2], wf.shape[3]
    sh, sw = len(taps_h), len(taps_w)
    out = wf.new_zeros((win_h, win_w, cin, sh * sw * cout))
    for ry, th in enumerate(taps_h):
        for ky, dy in th:
            for rx, tw in enumerate(taps_w):
                for kx, dx in tw:
                    phase = ry * sw + rx
                    out[dy + lo_h, dx + lo_w, :, phase * cout:(phase + 1) * cout] = wf[ky, kx]
    return out


class ConvTranspose2d(_Quantizable):
    """torch ConvTranspose2d(k, s, p, output_padding); weight IOHW
    (in, out, kh, kw), the layout the JAX kernel (kh, kw, in, out) maps to
    without a flip (reference usage: D_and_G_model.py:218-220 —
    deconv_8's k8-from-1x1 and deconv_32's stride 4). ``algorithm``
    (``"dilated"`` or ``"subpixel"``) is how the int8 path runs it; the
    float path is ``conv_transpose2d`` either way."""

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
        algorithm: str = "dilated",
    ):
        super().__init__()
        if algorithm not in ("dilated", "subpixel"):
            raise ValueError(f"unknown transposed-conv algorithm {algorithm!r}")
        kh, kw = _pair(kernel_size)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.output_padding = _pair(output_padding)
        self.kernel_size = (kh, kw)
        self.algorithm = algorithm
        self.quant_in_per_group, self.quant_out = in_channels, out_channels
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

    def phase_plan(self):
        """The two axes' ``subpixel_plan`` when the int8 path decomposes
        this transposed conv into phases (JAX's test,
        ``tpgan_tpu/ops/blocks.py:323-333``), else None."""
        kh, kw = self.kernel_size
        (sh, sw), (ph, pw), (oph, opw) = self.stride, self.padding, self.output_padding
        if not (self.algorithm == "subpixel" and (sh > 1 or sw > 1)
                and kh - 1 - ph >= 0 and kw - 1 - pw >= 0
                and (kh + oph - 2 * ph) % sh == 0 and (kw + opw - 2 * pw) % sw == 0):
            return None
        plan_h, plan_w = subpixel_plan(kh, sh, ph, oph), subpixel_plan(kw, sw, pw, opw)
        if plan_h[2] < 0 or plan_w[2] < 0:
            return None
        return plan_h, plan_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = _conv_cast(self, x)
        if self.quant_mode is not None:
            y = self._quant_forward(x)
            if y is not None:
                return y
        if self.tp is not None:
            return tensor_parallel.conv_transpose2d(self.tp, x, w, b, self.stride, self.padding,
                                                    self.output_padding)
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding)


class BatchNorm2d(nn.BatchNorm2d):
    """torch BatchNorm2d (eps 1e-5, momentum 0.1) that normalises in f32
    and casts back to the input dtype, as the JAX BatchNorm2d does
    (``tpgan_tpu/ops/blocks.py:435-457``). Eval mode normalises with the
    running statistics. Train mode normalises with the batch statistics
    (biased variance) and advances the running ones (momentum 0.1,
    unbiased variance) unless ``advance_stats`` is False, which
    :func:`frozen_batch_stats` sets.

    ``sync_mesh`` (set by :func:`sync_batch_stats`): a mesh whose data axis
    has more than one rank, whose data ranks each hold rows of one global
    batch (the ranks of a model group hold the same rows and sync over
    their own data groups).
    Train mode then takes the global batch's statistics, JAX's
    ``axis_name`` path (``:437-447``, which GSPMD takes for any BatchNorm
    of a ``data``-sharded step): each rank's mean and biased variance,
    gathered by one sum over the ranks
    (``parallel.collectives.all_reduce_sum``, differentiable twice, so the
    GP's double backward crosses the ranks) and merged (Chan et al.: the
    mean of the means; the mean of the variances plus the variance of the
    means); the running variance is unbiased with the global count.
    Without one, the forward is torch's (cuDNN on the card)."""

    advance_stats: bool = True
    sync_mesh = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))  # a float64 model stays float64
        if self.training and self.sync_mesh is not None:
            y = self._synced(x32)
        elif self.training and not self.advance_stats:
            # the advancing pass's op on copies of the statistics: it saves
            # the same tensors for backward, which torch.utils.checkpoint
            # asks of a recompute (train/gan_trainer.py's remat)
            y = F.batch_norm(x32, self.running_mean.clone(), self.running_var.clone(),
                             self.weight, self.bias, True, self.momentum, self.eps)
        else:
            y = super().forward(x32)
        return y.to(x.dtype)

    def _synced(self, x32: torch.Tensor) -> torch.Tensor:
        mesh = self.sync_mesh
        c = x32.shape[1]
        n = x32.numel() // c * mesh.size
        # Chan's merge of the ranks' (mean, biased var) at equal counts: the
        # sums of x and x^2 lose the variance to cancellation in f32 where
        # the mean is large against it (the detector's 2x2 maps at 128 px)
        var_r, mean_r = torch.var_mean(x32, dim=(0, 2, 3), unbiased=False)
        slot = torch.zeros((mesh.size, 1, 1), dtype=x32.dtype, device=x32.device)
        slot[mesh.rank] = 1.0
        ranks = all_reduce_sum(slot * torch.stack([mean_r, var_r]), mesh.group)
        mean = ranks[:, 0].mean(0)
        var = ranks[:, 1].mean(0) + (ranks[:, 0] - mean).square().mean(0)  # biased: it normalises
        if self.advance_stats:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var * (n / max(n - 1, 1)), alpha=m)
                self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        shape = (1, c, 1, 1)
        return (x32 - mean.view(shape)) * inv.view(shape) + self.bias.view(shape)


def sync_batch_stats(module: nn.Module, mesh) -> None:
    """Sync every BatchNorm of ``module`` over ``mesh``'s data ranks
    (``BatchNorm2d.sync_mesh``) when it has more than one; with one rank,
    or none, each keeps the single-device forward."""
    synced = mesh if mesh is not None and mesh.group is not None and mesh.size > 1 else None
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            m.sync_mesh = synced


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
                algorithm="subpixel" if mode == "subpixel" else "dilated",
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
    tp = None  # its placement on a mesh's model axis (parallel.tensor_parallel)

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
        self.in_features, self.out_features = in_features, out_features
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
        y = (F.linear(*_cast(self, x)) if self.tp is None
             else tensor_parallel.linear(self.tp, *_cast(self, x)))
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


def cast_parameters_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast the conv and linear parameters of ``module`` to ``dtype`` in
    place, each conv and transposed-conv weight into
    :func:`conv_memory_format` (so a forward casts nothing). BatchNorm
    stays float32: it normalises in f32 and casts back, as the JAX
    BatchNorm2d does."""
    for m in module.modules():
        if isinstance(m, BatchNorm2d):
            continue
        conv = isinstance(m, (Conv2d, ConvTranspose2d))
        for p in m.parameters(recurse=False):
            layout = conv_memory_format(dtype) if conv and p.dim() == 4 else \
                torch.preserve_format
            p.data = p.data.to(dtype, memory_format=layout)
    return module


def compute_copy(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """A copy of ``module`` whose conv and linear parameters are in ``dtype``
    (:func:`cast_parameters_`)."""
    return cast_parameters_(copy.deepcopy(module), dtype)


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
