"""Post-training int8 quantization (PTQ) of the synthesis graph — the port
of ``tpgan_tpu/ops/quant.py``:

* **per-output-channel symmetric weight quantization**, from the float32
  weights;
* **calibrated per-tensor activation scales**: a calibration pass runs the
  float graph over representative batches and keeps the running absmax
  of every conv and transposed-conv input, a dict of 0-d float32 tensors
  keyed by the port's module names (``convert.jax_quant_scales_to_port``
  maps JAX's ``quant`` collection onto the same keys);
* **int8 x int8 -> int32 convs**: the input is quantized with its
  calibrated scale, the conv is an exact im2col of the int8 input times
  the int8 weight matrix through ``torch._int_mm`` (cuBLASLt's int8 GEMM
  on the card), and the int32 sums are rescaled by ``x_scale *
  w_scale[channel]``.

The int32 sums are exact, so a layer whose int8 input and weight equal
JAX's gives JAX's accumulator to the bit. The float arithmetic around
them follows JAX's jitted int8 program op for op, where XLA has made its
choices: the calibrated scales are constants there, so ``x / x_scale``
is the product with the float32 reciprocal of the scale (XLA's rewrite of
a division by a constant), while the weights are traced, so ``w /
w_scale`` is a true division and ``absmax / 127`` in the weight scale is
the product with float32(1 / 127). Rounding is half to even on both
sides.

The mode lives on the layers (``blocks._Quantizable``): :func:`quant_mode`
sets it on every port ``Conv2d`` / ``ConvTranspose2d`` inside a model, and
:func:`quant_config` the two tuning knobs; used as a ``with`` block, each
restores what was set before it on exit (as ``blocks.frozen_batch_stats``
does for BatchNorm). A layer runs int8 only once :func:`prepare_int8` has
quantized its weight into its :class:`Int8Conv`; :func:`make_int8_model`
does all of it on a copy of a generator. Usage::

    scales = calibrate_synthesis(cfg, gen, batches)
    synthesize = gan_trainer.make_int8_synthesize_fn(cfg, gen, scales)

The int8 conv is a library product (``torch._int_mm``), not a kernel of
the port: ``lax.conv_general_dilated(preferred_element_type=int32)``,
which it replaces, is XLA's.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from tpgan_tpu_torch.ops.blocks import (
    CALIB,
    DTYPES,
    INT8,
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    compute_copy,
    subpixel_weights,
)
from tpgan_tpu_torch.ops.resize import reciprocal_f32

# int8 serving-tuning knob defaults (see quant_config): the layers' own
DEFAULT_RESCALE_DTYPE = Conv2d.quant_rescale_dtype
DEFAULT_MIN_CHANNELS = Conv2d.quant_min_channels

# The int8 columns of one product are built for at most this many bytes;
# a larger batch is taken in chunks of images (the fm-1.0 generator's
# 7x7 64 -> 64 conv at 128x128 has K = 3,136: 411 MB of columns per 8
# images, 6.6 GB at batch 128).
COLUMN_BYTES = 1 << 30

# torch._int_mm on CUDA takes M > 16 rows and K, N multiples of 8
# (cuBLASLt's int8 GEMM); the channels (so K) and N are zero-padded to
# multiples of 8, which keeps the sums exact, and fewer rows are padded
# to _MIN_ROWS.
_ALIGN = 8
_MIN_ROWS = 17


def should_quantize(cin_per_group: int, cout: int, min_channels: Optional[int] = None) -> bool:
    """Selective quantization: convs narrower than ``min_channels`` on
    either side stay on the float path (``quant.py:57-64``)."""
    m = DEFAULT_MIN_CHANNELS if min_channels is None else min_channels
    return min(int(cin_per_group), int(cout)) >= m


def _quant_layers(model: nn.Module) -> List[Tuple[str, nn.Module]]:
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, (Conv2d, ConvTranspose2d))]


class _LayerSettings:
    """``values`` set on every conv and transposed conv of ``model`` when
    made; used as a ``with`` block, what was set before is restored on
    exit, so blocks nest."""

    def __init__(self, model: nn.Module, values: Mapping[str, Any]):
        self._saved = []
        for _, m in _quant_layers(model):
            self._saved.append((m, {k: getattr(m, k) for k in values}))
            for k, v in values.items():
                setattr(m, k, v)

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> None:
        for m, saved in reversed(self._saved):
            for k, v in saved.items():
                setattr(m, k, v)


def quant_mode(model: nn.Module, mode: Optional[str]) -> _LayerSettings:
    """Every conv and transposed conv of ``model`` runs in ``mode``:
    ``CALIB`` records the running absmax of its input, ``INT8`` runs its
    int8 program (:func:`prepare_int8` must have made it; a layer that is
    not prepared raises), ``None`` the float conv. As a ``with`` block,
    the mode before it comes back on exit."""
    if mode not in (None, CALIB, INT8):
        raise ValueError(f"unknown quant mode {mode!r}")
    return _LayerSettings(model, {"quant_mode": mode})


def quant_config(model: nn.Module, rescale_dtype: Optional[torch.dtype] = None,
                 min_channels: Optional[int] = None) -> _LayerSettings:
    """Tune the int8 convs of ``model`` (as a ``with`` block, restored on
    exit); :func:`prepare_int8` reads them:

    * ``rescale_dtype`` — the dtype of the dequantize arithmetic (int32
      sums -> float, the bias add); float32 by default;
    * ``min_channels`` — convs whose min(cin / groups, cout) is below it
      stay on the float path (:func:`should_quantize`); 0 by default.
    """
    values = {}
    if rescale_dtype is not None:
        values["quant_rescale_dtype"] = rescale_dtype
    if min_channels is not None:
        values["quant_min_channels"] = min_channels
    return _LayerSettings(model, values)


# --------------------------------------------------------------------------
# Quantizers
# --------------------------------------------------------------------------

def quantize_weight_per_channel(w: torch.Tensor, out_axis: int
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8 quantization of a kernel whose
    output channels lie on ``out_axis`` (0 for a ``Conv2d`` OIHW weight,
    1 for a ``ConvTranspose2d`` IOHW one; JAX's HWIO kernel has them last).
    Returns (w_q int8 in ``w``'s layout, w_scale float32 (out,)):
    ``scale = max(absmax, 1e-8) / 127`` and ``w_q = clip(round(w /
    scale), -127, 127)``, as JAX's jitted program computes them (the
    ``/ 127`` as the product with float32(1 / 127), ``w / scale`` a true
    division)."""
    w32 = w.float()
    dims = tuple(d for d in range(w.ndim) if d != out_axis)
    absmax = w32.abs().amax(dim=dims)
    scale = torch.clamp_min(absmax, 1e-8) * reciprocal_f32(127.0)
    shape = [1] * w.ndim
    shape[out_axis] = -1
    w_q = torch.clamp(torch.round(w32 / scale.view(shape)), -127, 127)
    return w_q.to(torch.int8), scale


def activation_scale(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax, 1e-8) / 127`` in float32, a true division on any
    device (by a tensor: CUDA divides by a CPU scalar as a product with
    its reciprocal)."""
    a = torch.clamp_min(torch.as_tensor(absmax).float(), 1e-8)
    return a / torch.full_like(a, 127.0)


def quantize_activation(x: torch.Tensor, absmax: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization with a calibrated absmax:
    (x_q int8, scale float32), ``x_q = clip(round(x * (1 / scale)), -127,
    127)`` — JAX's ``round(x / scale)`` as its jitted int8 program
    computes it, where the calibrated scale is a constant."""
    scale = activation_scale(absmax).to(x.device)
    return _quantize(x, torch.reciprocal(scale)), scale


def _quantize(x: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    x32 = x if x.dtype == torch.float32 else x.float()
    return (x32 * inv_scale).round_().clamp_(-127, 127).to(torch.int8)


# --------------------------------------------------------------------------
# The int8 conv: exact im2col + torch._int_mm
# --------------------------------------------------------------------------

def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def pack_int8_weight(w_q: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """An int8 OIHW weight (out, in / groups, kh, kw) as the (groups, Np,
    Kp) row-major matrices of the products: K in (row, column, channel)
    order — the order of the NHWC columns — with each group's channels
    zero-padded to a multiple of 8 (so Kp = kh·kw·Cgp is one too), and N
    zero-padded to a multiple of 8. The padded entries are 0: the sums are
    unchanged."""
    cout, cin_g, kh, kw = w_q.shape
    n = cout // groups
    w = F.pad(w_q.permute(0, 2, 3, 1), (0, _round_up(cin_g, _ALIGN) - cin_g))
    mats = w_q.new_zeros((groups, _round_up(n, _ALIGN), kh * kw * w.shape[-1]))
    mats[:, :n] = w.reshape(groups, n, -1)
    return mats


def _nhwc_input(x_q: torch.Tensor, groups: int, padding, lhs_dilation) -> torch.Tensor:
    """The int8 NCHW input as NHWC with each group's channels zero-padded to
    a multiple of 8, dilated (zeros between its pixels) and zero-padded
    ((top, bottom), (left, right)); 0 is the quantized zero."""
    b, c, h, w = x_q.shape
    cg = c // groups
    cgp = _round_up(cg, _ALIGN)
    (pt, pb), (pl, pr) = padding
    dh, dw = lhs_dilation
    hd, wd = (h - 1) * dh + 1, (w - 1) * dw + 1
    out = x_q.new_zeros((b, pt + hd + pb, pl + wd + pr, groups, cgp))
    out[:, pt:pt + hd:dh, pl:pl + wd:dw, :, :cg] = x_q.permute(0, 2, 3, 1).view(
        b, h, w, groups, cg)
    return out.view(b, pt + hd + pb, pl + wd + pr, groups * cgp)


def int8_conv_accumulate(x_q: torch.Tensor, mats: torch.Tensor, kernel_size: Tuple[int, int],
                         stride=(1, 1), padding=((0, 0), (0, 0)), lhs_dilation=(1, 1)
                         ) -> torch.Tensor:
    """The int32 sums of an int8 conv: ``x_q`` (B, C, H, W) int8 and the
    packed weight ``mats`` (:func:`pack_int8_weight`); returns (B, OH, OW,
    groups·Np) int32, NHWC as JAX's ``lax.conv_general_dilated(...,
    preferred_element_type=int32)`` gives it, each group's padded
    columns included (they are 0).

    The input is laid out NHWC, its channels padded to a multiple of 8, so
    that each window row of a column is one run of kw·Cgp bytes, copied as
    8-byte words: the columns are an im2col of its int64 view
    (``Tensor.unfold``, one copy into a (rows, Kp) matrix), built for at
    most :data:`COLUMN_BYTES` at a time: a larger batch goes in chunks of
    images. Each group is one ``torch._int_mm`` (int32 sums are exact in
    any order)."""
    kh, kw = kernel_size
    sh, sw = stride
    groups, n_pad, k_pad = mats.shape
    xp = _nhwc_input(x_q, groups, padding, lhs_dilation)
    b, hp, wp, cp = xp.shape
    oh, ow = (hp - kh) // sh + 1, (wp - kw) // sw + 1
    words = cp // groups // _ALIGN  # 8-byte words per group per pixel
    # (b, oh, ow, words, kh, kw) -> (b, oh, ow, kh, kw, words): K in (row, column, channel)
    patches = xp.view(torch.int64).unfold(1, kh, sh).unfold(2, kw, sw).permute(0, 1, 2, 4, 5, 3)
    chunk = max(1, min(b, COLUMN_BYTES // max(1, oh * ow * k_pad)))
    if groups == 1 and chunk == b and b * oh * ow >= _MIN_ROWS:
        # the main path: one copy makes the columns, one product
        cols = patches.reshape(b * oh * ow, -1).view(torch.int8)
        return torch._int_mm(cols, mats[0].t()).view(b, oh, ow, n_pad)
    acc = torch.empty((b, oh, ow, groups, n_pad), dtype=torch.int32, device=xp.device)
    for i0 in range(0, b, chunk):
        n = min(chunk, b - i0)
        rows = n * oh * ow
        for g in range(groups):
            cols = patches[i0:i0 + n, ..., g * words:(g + 1) * words].reshape(rows, -1)
            cols = cols.view(torch.int8)
            if rows < _MIN_ROWS:
                cols = F.pad(cols, (0, 0, 0, _MIN_ROWS - rows))
            acc[i0:i0 + n, :, :, g] = torch._int_mm(cols, mats[g].t())[:rows].view(
                n, oh, ow, n_pad)
    return acc.view(b, oh, ow, groups * n_pad)


def _rescale(acc: torch.Tensor, n_out: int, groups: int, scale: torch.Tensor,
             bias: Optional[torch.Tensor], out_dtype: torch.dtype, phases=(1, 1)) -> torch.Tensor:
    """(B, OH, OW, groups·Np) int32 -> NCHW ``out_dtype``: ``acc.to(rdt) *
    scale`` (rdt = ``scale``'s dtype; ``tpgan_tpu/ops/quant.py:170-171``), the
    depth-to-space of ``phases`` (the subpixel transposed conv's phase
    columns), ``+ bias`` in rdt, then the cast, all in JAX's order."""
    b, oh, ow, width = acc.shape
    n_pad = width // groups
    n = n_out // groups
    if n_pad != n:
        acc = acc.view(b, oh, ow, groups, n_pad)[..., :n]
    y = acc.to(scale.dtype).reshape(b, oh, ow, n_out).mul_(scale)
    sh, sw = phases
    cout = n_out // (sh * sw)
    y = y.view(b, oh, ow, sh, sw, cout)
    if bias is not None:
        y.add_(bias)
    out = torch.empty((b, cout, oh * sh, ow * sw), dtype=out_dtype, device=acc.device)
    out.view(b, cout, oh, sh, ow, sw).copy_(y.permute(0, 5, 1, 3, 2, 4))
    return out


class Int8Conv(nn.Module):
    """One conv's int8 program with its weight quantized once: the packed
    int8 weight, the reciprocal of the activation scale and ``x_scale *
    w_scale`` in the rescale dtype (and the bias in it) are buffers, so
    a forward is device work only (no host value, capturable in a CUDA
    graph) and ``torch.export`` keeps them in the artifact.

    ``weight`` (out, in / groups, kh, kw) float32: a ``Conv2d``'s weight,
    or a transposed conv's flipped kernel or subpixel phase weight
    (``ConvTranspose2d.int8_program``). ``forward(x)`` takes the conv's NCHW
    input in the compute dtype (reflect-padded already, where the layer
    pads) and returns NCHW in ``x``'s dtype."""

    def __init__(self, weight: torch.Tensor, absmax: torch.Tensor, bias: Optional[torch.Tensor],
                 rescale_dtype: torch.dtype = DEFAULT_RESCALE_DTYPE, stride=(1, 1),
                 padding=((0, 0), (0, 0)), groups: int = 1, lhs_dilation=(1, 1), phases=(1, 1)):
        super().__init__()
        w_q, w_scale = quantize_weight_per_channel(weight, out_axis=0)
        x_scale = activation_scale(absmax).to(weight.device)
        self.register_buffer("weight_q", pack_int8_weight(w_q, groups))
        self.register_buffer("x_inv_scale", torch.reciprocal(x_scale))
        self.register_buffer("scale", (x_scale * w_scale).to(rescale_dtype))
        self.register_buffer("bias", None if bias is None else bias.float().to(rescale_dtype))
        self.kernel_size = tuple(weight.shape[2:])
        self.out_channels = weight.shape[0]
        self.stride, self.padding, self.groups = tuple(stride), tuple(padding), groups
        self.lhs_dilation, self.phases = tuple(lhs_dilation), tuple(phases)

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (the conv's input) in int8 with this conv's calibrated scale."""
        return _quantize(x, self.x_inv_scale)

    def accumulate(self, x_q: torch.Tensor) -> torch.Tensor:
        """The int32 sums of the int8 input ``x_q``, NHWC (B, OH, OW, groups·Np)."""
        return int8_conv_accumulate(x_q, self.weight_q, self.kernel_size, self.stride,
                                    self.padding, self.lhs_dilation)

    def rescale(self, acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The int32 sums as this conv's NCHW output in ``dtype`` (scale,
        depth-to-space, bias)."""
        return _rescale(acc, self.out_channels, self.groups, self.scale, self.bias, dtype,
                        self.phases)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.rescale(self.accumulate(self.quantize(x)), x.dtype)


def int8_conv(x: torch.Tensor, weight: torch.Tensor, absmax: torch.Tensor, *, stride=(1, 1),
              padding=((0, 0), (0, 0)), groups: int = 1, lhs_dilation=(1, 1),
              rescale_dtype: torch.dtype = DEFAULT_RESCALE_DTYPE) -> torch.Tensor:
    """JAX's ``int8_conv`` on the port's layouts: ``x`` NCHW float,
    ``weight`` OIHW float, both quantized here (the weight per output
    channel, ``x`` with the calibrated ``absmax``), the int8 conv through
    ``torch._int_mm``, and the sums rescaled to NCHW ``rescale_dtype``."""
    conv = Int8Conv(weight, absmax, None, rescale_dtype, stride, padding, groups, lhs_dilation)
    return conv.rescale(conv.accumulate(conv.quantize(x)), rescale_dtype)


# --------------------------------------------------------------------------
# The layers' int8 programs
# --------------------------------------------------------------------------

def int8_program(layer: nn.Module) -> Int8Conv:
    """A port ``Conv2d`` or ``ConvTranspose2d`` as its :class:`Int8Conv`,
    the weight quantized now from float32 with the layer's calibrated
    absmax and rescale dtype. A ``Conv2d`` runs over its OIHW weight. A
    transposed conv runs over its subpixel phase weights followed by a
    depth-to-space where ``phase_plan`` admits it, else over the flipped
    kernel on the input dilated by the stride (input dilation interleaves
    zeros, exact under int8), each with per-channel scales over its own
    output columns."""
    args = (layer.quant_absmax, layer.bias, layer.quant_rescale_dtype)
    if isinstance(layer, Conv2d):
        ph, pw = layer.padding
        return Int8Conv(layer.weight.detach().float(), *args, stride=layer.stride,
                        padding=((ph, ph), (pw, pw)), groups=layer.groups)
    wf = layer.weight.detach().float().flip(2, 3)  # (in, out, kh, kw), flipped
    kh, kw = wf.shape[2:]
    plan = layer.phase_plan()
    if plan is not None:
        (taps_h, lo_h, hi_h, win_h, _), (taps_w, lo_w, hi_w, win_w, _) = plan
        w_sub = subpixel_weights(wf.permute(2, 3, 0, 1), taps_h, lo_h, win_h,
                                 taps_w, lo_w, win_w)  # HWIO
        return Int8Conv(w_sub.permute(3, 2, 0, 1), *args,
                        padding=((lo_h, hi_h), (lo_w, hi_w)), phases=layer.stride)
    (ph, pw), (oph, opw) = layer.padding, layer.output_padding
    if ph > kh - 1 or pw > kw - 1:
        raise ValueError(f"int8 transposed conv with padding {layer.padding} beyond "
                         f"kernel - 1 is not supported")
    pad = ((kh - 1 - ph, kh - 1 - ph + oph), (kw - 1 - pw, kw - 1 - pw + opw))
    return Int8Conv(wf.transpose(0, 1), *args, padding=pad, lhs_dilation=layer.stride)


def prepare_int8(model: nn.Module) -> None:
    """Quantize, once, the weight of every conv of ``model`` that its knobs
    (:func:`quant_config`) quantize: each gets its :class:`Int8Conv` as the
    child ``int8`` (:func:`int8_program`) and its float weight is dropped
    (the int8 path never reads it); the others keep theirs and stay float.
    Every conv is then prepared (a prepared one is left as it is): in
    ``INT8`` mode it runs what this chose."""
    for name, layer in _quant_layers(model):
        if layer.quant_prepared:
            continue
        if layer.tp is not None:
            raise ValueError(f"{name} is sharded over a mesh's model axis: quantize the "
                             "single-device model (parallel.tensor_parallel.unsharded_copy)")
        layer.int8 = None
        if should_quantize(layer.quant_in_per_group, layer.quant_out, layer.quant_min_channels):
            if layer.quant_absmax is None:
                raise ValueError(f"no calibrated absmax for {name}")
            layer.int8 = int8_program(layer)
            dtype = layer.compute_dtype or layer.weight.dtype
            layer.weight = nn.Parameter(layer.weight.new_empty(0, dtype=dtype),
                                        requires_grad=False)
            layer.bias = None
        layer.quant_prepared = True


# --------------------------------------------------------------------------
# Scales
# --------------------------------------------------------------------------

def collect_quant_scales(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{module name: calibrated absmax (0-d float32)} of ``model``'s convs."""
    return {name: m.quant_absmax for name, m in _quant_layers(model)
            if m.quant_absmax is not None}


def load_quant_scales(model: nn.Module, scales: Mapping[str, Any]) -> None:
    """Give every conv of ``model`` its calibrated absmax from ``scales``
    ({module name: absmax}, :func:`calibrate_synthesis`'s or
    ``convert.jax_quant_scales_to_port``'s), as a 0-d float32 tensor on
    the layer's device. Every conv needs one and every key must name a
    conv, as a strict ``load_state_dict``."""
    layers = dict(_quant_layers(model))
    missing = sorted(set(layers) - set(scales))
    unexpected = sorted(set(scales) - set(layers))
    if missing or unexpected:
        raise KeyError(f"quant scales do not match the model's convs: missing {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}, unexpected {unexpected[:5]}"
                       f"{'...' if len(unexpected) > 5 else ''}")
    for name, layer in layers.items():
        value = scales[name]
        value = value if torch.is_tensor(value) else torch.tensor(np.float32(value))
        layer.quant_absmax = value.detach().float().to(layer.weight.device).reshape(())


# --------------------------------------------------------------------------
# The synthesis graph: calibration and the int8 function
# --------------------------------------------------------------------------

SYNTHESIS_KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")


def _refuse_batch_norm(gen: nn.Module) -> None:
    if any(isinstance(m, BatchNorm2d) for m in gen.modules()):
        raise NotImplementedError(
            "int8 PTQ synthesis does not thread BatchNorm running statistics (the default "
            "WGAN-GP generator has no BatchNorm; tpgan_tpu/frontalize.py:341-347)")


def calibrate_synthesis(cfg, gen: nn.Module, batches: Iterable[Mapping[str, Any]],
                        zs: Optional[Iterable[Any]] = None,
                        generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """Run the float synthesis graph (``cfg.compute_dtype``, eval mode, no
    dropout) over ``batches``, recording the running absmax of every conv
    input. Returns {module name: 0-d float32 tensor on ``gen``'s device}
    for ``gan_trainer.make_int8_synthesize_fn``.

    ``batches``: NHWC batch dicts (only the five synthesis inputs are
    used). ``zs``: a matching iterable of noise vectors; by default each
    is drawn from ``generator`` (a ``torch.Generator`` seeded 0 on the
    device when none is given). JAX draws them from ``PRNGKey(0)``
    splits, which torch cannot reproduce: parity tests pass ``zs``."""
    _refuse_batch_norm(gen)
    dtype = DTYPES[cfg.compute_dtype]
    device = next(gen.parameters()).device
    model = copy.deepcopy(gen) if dtype == torch.float32 else compute_copy(gen, dtype)
    model.eval()
    if generator is None and zs is None:
        generator = torch.Generator(device=device).manual_seed(0)
    zs_iter = iter(zs) if zs is not None else None

    def nchw(v):
        return torch.as_tensor(v, device=device).permute(0, 3, 1, 2).contiguous()

    with quant_mode(model, CALIB), torch.inference_mode():
        for batch in batches:
            b = batch["img"].shape[0]
            if zs_iter is not None:
                z = torch.as_tensor(np.asarray(next(zs_iter)), device=device)
            else:
                z = torch.randn((b, cfg.G.zdim), generator=generator, device=device)
            model(*(nchw(batch[k]) for k in SYNTHESIS_KEYS), z, use_dropout=False)
    return collect_quant_scales(model)


def make_int8_model(cfg, gen: nn.Module, quant_scales: Mapping[str, Any],
                    rescale_dtype: Optional[torch.dtype] = None,
                    min_channels: Optional[int] = None) -> nn.Module:
    """A copy of ``gen`` that runs int8: its convs given ``quant_scales``,
    put in ``INT8`` mode with the knobs (:func:`quant_mode`,
    :func:`quant_config`; unset knobs take their defaults) and prepared
    (:func:`prepare_int8`, from the float32 weights, as JAX quantizes its
    f32 params); the convs that stay float and the linear layers cast to
    ``cfg.compute_dtype``; eval mode. Later changes to ``gen`` do not reach
    it. A generator with BatchNorm raises."""
    _refuse_batch_norm(gen)
    dtype = DTYPES[cfg.compute_dtype]
    model = copy.deepcopy(gen)
    load_quant_scales(model, quant_scales)
    quant_mode(model, INT8)
    quant_config(model, rescale_dtype or DEFAULT_RESCALE_DTYPE,
                 DEFAULT_MIN_CHANNELS if min_channels is None else min_channels)
    with torch.no_grad():
        prepare_int8(model)
    if dtype != torch.float32:
        model = compute_copy(model, dtype)
    return model.eval()
