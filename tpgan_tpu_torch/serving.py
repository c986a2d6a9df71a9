"""Serving export — the port of ``tpgan_tpu/serving.py``: the synthesis
function, or the whole raw-frame -> frontal-face program, captured with
``torch.export`` and saved as a ``.pt2`` artifact (weights included) that
a serving process loads and runs with torch alone (``torch.export.load``,
then ``.module()``), with no Python tracing and no ``tpgan_tpu_torch``.

**The fuse in an artifact is the plain one.** The port's K1 kernel is a
``ctypes`` launch inside an ``autograd.Function``, which ``torch.export``
cannot trace, and an artifact that called it would need the built
``.so`` to load. So the export functions set ``Generator.plain_fuse`` on
the copy they export: the artifact computes the three fuses with
``ops.kernels.fuse_parts_plain`` (bit-equal to the kernel) and loads with
torch alone. This is a property of the artifact, chosen here: every live
path (``make_synthesize_fn``, the int8 function, ``frontalize`` and
their graphed forms) keeps the kernel. The fuses are 0.12-0.18% of a
forward's device time on the H100 (``PERF.md`` §5).

JAX's ``platforms`` names XLA lowering targets; its counterpart here is
``device``, where the artifact's constants live and its program runs
(an artifact exported on ``cuda`` runs on ``cuda``; export on ``cpu``
for a CPU host). AOTInductor (a compiled ``.so`` from the artifact) is
not used: it needs ``triton`` for its CUDA code.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.frontalize import make_frontalize_fn
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2
from tpgan_tpu_torch.ops.blocks import DTYPES, BatchNorm2d, set_compute_dtype
from tpgan_tpu_torch.ops.quant import SYNTHESIS_KEYS, make_int8_model
from tpgan_tpu_torch.train.gan_trainer import make_graphed_synthesize_fn

Device = Optional[Union[str, torch.device]]


def cast_float_leaves(state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype
                      ) -> Dict[str, torch.Tensor]:
    """``state_dict`` with every floating-point parameter cast to ``dtype``;
    BatchNorm running statistics stay float32 (they feed float32
    normalisation arithmetic, ``tpgan_tpu/serving.py:129-132``), and
    integer entries stay as they are."""
    return {k: v.to(dtype) if v.is_floating_point()
            and not k.endswith(("running_mean", "running_var")) else v
            for k, v in state_dict.items()}


def with_weights_dtype(model: nn.Module, dtype: torch.dtype, compute_dtype: torch.dtype
                       ) -> nn.Module:
    """A copy of ``model`` whose float parameters hold ``dtype`` values
    (:func:`cast_float_leaves`), computing in ``compute_dtype``: conv and
    linear weights are stored in ``dtype`` and cast at use; BatchNorm's
    scale and bias take the ``dtype`` values and stay stored in float32,
    since the port's BatchNorm normalises with float32 operands."""
    out = copy.deepcopy(model)
    narrowed = cast_float_leaves(dict(out.named_parameters()), dtype)
    for name, p in out.named_parameters():
        p.data = narrowed[name]
    for m in out.modules():
        if isinstance(m, BatchNorm2d):
            for p in m.parameters(recurse=False):
                p.data = p.data.float()
    return set_compute_dtype(out, compute_dtype)


def _copy_on(model: nn.Module, device: Device) -> Tuple[nn.Module, torch.device]:
    """A copy of ``model`` on ``device`` (default: where ``model`` is). The
    export changes what it exports (``plain_fuse``, ``requires_grad``,
    eval mode), so it never takes the caller's own module."""
    here = next(model.parameters()).device
    device = here if device is None else torch.device(device)
    return copy.deepcopy(model).to(device), device


class _Program(nn.Module):
    """The exported module: ``fn`` over ``models``, registered so that
    their weights are the artifact's parameters and buffers."""

    def __init__(self, fn: Callable, models: Mapping[str, nn.Module]):
        super().__init__()
        self.models = nn.ModuleDict(dict(models))
        for m in self.models.values():
            m.requires_grad_(False)
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _synthesis_program(model: Generator) -> _Program:
    model.plain_fuse = True  # the artifact's fuse: see the module docstring

    def synthesize(batch: Dict[str, torch.Tensor], z: torch.Tensor) -> torch.Tensor:
        out = model(*(batch[k].permute(0, 3, 1, 2).contiguous() for k in SYNTHESIS_KEYS), z,
                    use_dropout=False)
        return out.img128_fake.permute(0, 2, 3, 1).contiguous()

    return _Program(synthesize, {"generator": model.eval()})


def example_inputs(cfg: Config, batch: int, device: Device = None):
    """Zero inputs of the synthesis function's shapes: (batch dict, z)."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    example = {"img": z(batch, 128, 128, 3), "left_eye": z(batch, 40, 40, 3),
               "right_eye": z(batch, 40, 40, 3), "nose": z(batch, 32, 40, 3),
               "mouth": z(batch, 32, 48, 3)}
    return example, z(batch, cfg.G.zdim)


def _save(program: _Program, args: tuple, path: str) -> None:
    exported = torch.export.export(program, args)
    torch.export.save(exported, path)


def export_synthesis(
    cfg: Config, gen: Generator, path: str, batch: int = 8, quant_scales=None,
    device: Device = None, rescale_dtype: Optional[torch.dtype] = None,
    min_channels: Optional[int] = None, weights_dtype: Optional[torch.dtype] = None,
) -> None:
    """Save the synthesis function, ``(batch dict, z) -> img128_fake`` at a
    static ``batch``, with the weights in it, to ``path`` (a ``.pt2``).

    * ``quant_scales`` (``ops.quant.calibrate_synthesis``'s): the artifact
      is the int8 program, its weights quantized once into int8 buffers
      (``ops.quant.make_int8_model``) with ``rescale_dtype`` /
      ``min_channels`` baked in like the scales; ``weights_dtype`` is
      ignored there, as in JAX: the quantization sees the float32
      weights.
    * the float weights are stored in float32 and cast to
      ``cfg.compute_dtype`` at use, as JAX's artifact bakes its float32
      parameters; ``weights_dtype`` (e.g. ``torch.bfloat16``) stores them
      in that dtype instead (:func:`cast_float_leaves`): on a bf16 model
      the matmuls are the live program's and the artifact halves.
    * ``device``: where the artifact's constants live and it runs (JAX's
      ``platforms``; default ``gen``'s device).

    The fuse is the plain one (module docstring)."""
    gen, device = _copy_on(gen, device)
    if quant_scales is not None:
        model = make_int8_model(cfg, gen, quant_scales, rescale_dtype, min_channels)
    else:
        model = with_weights_dtype(gen, weights_dtype or torch.float32, DTYPES[cfg.compute_dtype])
    _save(_synthesis_program(model), example_inputs(cfg, batch, device), path)


def export_frontalize(
    cfg: Config, detector: MobileNetV2, gen: Generator, path: str, batch: int = 8,
    input_hw: Tuple[int, int] = (128, 128), detector_size: int = 256, tta: bool = False,
    allow_upscale: bool = True, refine: bool = False, nose_prior=None, quant_scales=None,
    rescale_dtype: Optional[torch.dtype] = None, min_channels: Optional[int] = None,
    weights_dtype: Optional[torch.dtype] = None, device: Device = None,
) -> None:
    """Save the full-stack program — a uint8 frame batch (``batch``,
    ``input_hw``, 3), static, and z -> (fake, lm5, scores), as
    ``frontalize.make_frontalize_fn`` computes it with these options — to
    ``path`` (a ``.pt2``), the detector's and the generator's weights in
    it. One artifact per camera resolution (or letterbox to a canonical
    size on the host first).

    ``quant_scales`` exports the generator stage as the int8 program (the
    detector stays float). ``weights_dtype`` stores the detector's float
    parameters narrowed and, unless the generator is quantized, the
    generator's (:func:`cast_float_leaves`); the detector still computes
    in float32 (``blocks.set_compute_dtype``), as JAX's does with its
    narrowed parameters. The fuse is the plain one (module docstring)."""
    gen, device = _copy_on(gen, device)
    detector, _ = _copy_on(detector, device)
    if weights_dtype is not None:
        detector = with_weights_dtype(detector, weights_dtype, torch.float32)
        if quant_scales is None:
            gen = with_weights_dtype(gen, weights_dtype, DTYPES[cfg.compute_dtype])
    fn = make_frontalize_fn(cfg, detector, gen, detector_size=detector_size, tta=tta,
                            allow_upscale=allow_upscale, refine=refine, nose_prior=nose_prior,
                            quant_scales=quant_scales, quant_rescale_dtype=rescale_dtype,
                            quant_min_channels=min_channels)
    fn.models["generator"].plain_fuse = True
    h, w = input_hw
    images = torch.zeros((batch, h, w, 3), dtype=torch.uint8, device=device)
    z = torch.zeros((batch, cfg.G.zdim), dtype=torch.float32, device=device)
    _save(_Program(fn, fn.models), (images, z), path)


def load_synthesis(path: str) -> Callable[..., Any]:
    """Load a ``.pt2`` artifact of this module; returns a callable over its
    program: ``(batch dict, z) -> images`` for a synthesis artifact,
    ``(images, z) -> (fake, lm5, scores)`` for a frontalize one. Inputs
    may be numpy arrays or tensors; they go to the artifact's device."""
    program = torch.export.load(path)
    module = program.module()
    tensors = list(program.state_dict.values()) + list(program.constants.values())
    device = tensors[0].device if tensors else torch.device("cpu")

    def put(x):
        if isinstance(x, Mapping):
            return {k: put(v) for k, v in x.items()}
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x, device=device)

    def call(*args):
        with torch.inference_mode():
            return module(*(put(a) for a in args))

    call.device, call.program = device, program
    return call


def aot_compile_synthesis(cfg: Config, gen: Generator, batch: int = 8) -> Callable:
    """``make_graphed_synthesize_fn``'s function with its graph already
    captured at ``batch`` (one call on zero inputs), so the first request
    pays no capture; on the CPU the eager function."""
    synthesize = make_graphed_synthesize_fn(cfg, gen)
    if synthesize.device.type == "cuda":
        synthesize(*example_inputs(cfg, batch, synthesize.device))
    return synthesize
