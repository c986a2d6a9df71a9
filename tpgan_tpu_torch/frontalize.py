"""Full-stack frontalization, a raw image to a frontal face — the port of
``tpgan_tpu/frontalize.py``: letterbox the image, run the landmark
detector (MobileNetV2 + SSD), decode the four parts, map them back into
the source frame, crop the patches and run the generator, every step on
the device with no value read back to the host.
:func:`make_graphed_frontalize_fn` captures the whole program, a uint8
frame to ``(fake, lm5, scores)``, as one CUDA graph per input shape: the
port's single dispatch.

Coordinates: the detector was trained on letterboxed images whose labels
transform as ``xy * scale + pad`` (``data/celeba.letterbox``), so a
detection unmaps as ``(xy - pad) / scale``. Its classes 0-3 are (left
eye, right eye, nose, mouth midpoint); the crops want 5 points with two
mouth corners they average back into a midpoint (DataAndDataset.py:
42-43), so the midpoint fills both corner slots.

The arithmetic follows the float32 ops of JAX's jitted program one for
one: a division by a Python number is the product with its float32
reciprocal (``ops.resize.reciprocal_f32``), as XLA compiles it; a
tensor divided by a tensor is a true division; norms are
``sqrt(sum(square))`` and short means ``utils.misc.small_mean``. So the
landmarks that the crops floor come out as JAX's do, as near as the
detector's own arithmetic lets them. No constant is copied from the host
and no index is a Python list (a list index is copied to the device),
which a graph capture forbids.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpgan_tpu_torch.api import run_detector
from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.data.jit_preprocess import preprocess_for_synthesis_lm5, to_unit_float
from tpgan_tpu_torch.losses.decoder import decode_for_head_mode
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2
from tpgan_tpu_torch.ops.resize import reciprocal_f32, resize, scale_and_translate
from tpgan_tpu_torch.train.gan_trainer import make_int8_synthesize_fn, make_synthesize_fn
from tpgan_tpu_torch.utils import graphs
from tpgan_tpu_torch.utils.misc import small_mean

Frontalize = Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _norm(x: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.norm`` over the last axis: sqrt(sum(square))."""
    return torch.sqrt(torch.sum(x * x, dim=-1))


def letterbox_batch(images: torch.Tensor, size: int, allow_upscale: bool = False
                    ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """The images (B, H, W, 3), uint8 or float in [0, 1], resized keeping
    their aspect into a centred, zero-padded (size, size) square — the
    geometry of ``data/celeba.letterbox``: ``scale = size / max(h, w)``,
    pads ``(size - new) // 2``, labels transforming as ``xy * scale +
    pad``. Scale and pads are Python numbers from the static shape; the
    resize is ``bilinear`` and runs only when the size changes.
    ``allow_upscale=False`` leaves a smaller image at its own scale, as
    the bucketed pretraining does. Returns (float32 NHWC square, scale,
    (pad_left, pad_top))."""
    b, h, w = images.shape[:3]
    x = to_unit_float(images)
    scale = size / max(h, w)
    if not allow_upscale:
        scale = min(scale, 1.0)
    nh = max(int(round(h * scale)), 1)
    nw = max(int(round(w * scale)), 1)
    if (nh, nw) != (h, w):
        x = resize(x, (b, nh, nw, 3), "bilinear")
    pad_top = (size - nh) // 2
    pad_left = (size - nw) // 2
    x = F.pad(x, (0, 0, pad_left, size - nw - pad_left, pad_top, size - nh - pad_top))
    return x, scale, (pad_left, pad_top)


def _decode(detector: MobileNetV2, images: torch.Tensor, confidence_threshold: float):
    """The detector on NHWC ``images``, decoded for its head mode: the
    four parts' (points (B, 4, 2), valid (B, 4), scores (B, 4))."""
    loc, cls = run_detector(detector, images)
    d = decode_for_head_mode(detector.head_mode, confidence_threshold)(loc, cls)
    return d.points[:, :4, 0, :], d.valid[:, :4, 0], d.scores[:, :4, 0]


def refine_lm5(
    detector: MobileNetV2,
    images: torch.Tensor,
    pts: torch.Tensor,
    scores: torch.Tensor,
    detector_size: int = 256,
    confidence_threshold: float = 0.0,
    zoom: float = 1.8,
    parts: Sequence[int] = (2,),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The second stage of detection: a zoom crop per image, centred on
    the eyes and mouth of the coarse points ``pts`` (B, 4, 2, source
    frame) and ``zoom`` times the larger of the eye distance and the
    eye-to-mouth distance in half-width (at least 16 px), resampled to
    the detector's square with ``linear`` antialiased weights made per
    image (``ops.resize.scale_and_translate``); the detection there is
    mapped back through the crop's ``in * s + t``. Only the part indices
    in ``parts`` (the nose, by default: the part with the far tail) take
    the refined point and score, and only where it passes
    ``confidence_threshold``. Returns (points (B, 4, 2), scores (B, 4))."""
    dev = pts.device
    x = to_unit_float(images)
    centre = small_mean(torch.cat([pts[:, :2], pts[:, 3:]], dim=1), dim=1)  # (B, 2) xy
    eye_d = _norm(pts[:, 0] - pts[:, 1])
    em_d = _norm(small_mean(pts[:, :2], dim=1) - pts[:, 3])
    half = torch.clamp_min(torch.maximum(eye_d, em_d) * zoom, 16.0)  # (B,)
    s = torch.full_like(half, detector_size) / (2.0 * half)  # (B,)
    t = detector_size / 2.0 - centre * s[:, None]  # (B, 2) xy: out = s * in + t
    boxed = scale_and_translate(x, (detector_size, detector_size), s, t.flip(-1), "linear")
    rpts, rvalid, rscores = _decode(detector, boxed, confidence_threshold)
    rpts = (rpts - t[:, None, :]) / s[:, None, None]
    index = torch.arange(4, device=dev)
    part_mask = torch.zeros(4, dtype=torch.bool, device=dev)
    for p in parts:
        part_mask = part_mask | (index == p)
    keep = rvalid & part_mask[None, :]
    return torch.where(keep[..., None], rpts, pts), torch.where(keep, rscores, scores)


def detect_lm5(
    detector: MobileNetV2,
    images: torch.Tensor,
    detector_size: int = 256,
    confidence_threshold: float = 0.0,
    tta: bool = False,
    tta_agree_radius: float = 15.0,
    allow_upscale: bool = True,
    refine: bool = False,
    nose_prior: Optional[torch.Tensor] = None,
    nose_gate_ratio: float = 0.35,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The four parts detected on the letterboxed ``images`` (B, H, W, 3)
    and expanded to the 5-point layout: (lm5 (B, 5, 2) source-frame
    pixels, valid (B, 4), scores (B, 4) softmax confidence).
    ``confidence_threshold=0`` commits to the best location of each part,
    the serving choice (a face is assumed present).

    * ``tta``: one forward over the batch and its mirror; the mirror's
      points map back (x -> size - 1 - x, the eyes swapped), then per
      part the score-weighted mean where the two agree within
      ``tta_agree_radius`` (detector pixels), else the more confident
      point; ``valid`` is the larger score over the threshold.
    * ``refine``: :func:`refine_lm5`'s zoom crop for the nose.
    * ``nose_prior`` (7, 2), ``train.pretrain.fit_nose_prior``'s ridge
      fit: a nose further than ``nose_gate_ratio`` eye distances (at
      least 16 px) from ``[le, re, mouth, 1] @ W`` snaps to the prior;
      with ``refine`` too, a vote of the coarse point, the refined one and
      the prior: the mean of coarse and refined where they agree, else
      whichever agrees with the prior, else the prior.

    As ``tpgan_tpu/frontalize.py`` stands: with a nose prior the scores
    keep the coarse ones (the larger of coarse and refined under
    ``refine``) whatever the gate did, and ``valid`` stays the coarse
    pass's (``frontalize.py:283``)."""
    boxed, scale, (pad_left, pad_top) = letterbox_batch(images, detector_size, allow_upscale)
    dev = boxed.device
    det_in = torch.cat([boxed, torch.flip(boxed, dims=[2])]) if tta else boxed
    pts, valid, scores = _decode(detector, det_in, confidence_threshold)
    if tta:
        b = boxed.shape[0]
        pts, pts_m = pts[:b], pts[b:]
        scores, scores_m = scores[:b], scores[b:]
        valid = valid[:b]
        # back to the unmirrored frame: x -> size-1-x (pixel centres); the
        # mirror swaps the left and right eye classes
        pts_m = torch.stack([(detector_size - 1) - pts_m[..., 0], pts_m[..., 1]], dim=-1)
        pts_m = torch.cat([pts_m[:, 1:2], pts_m[:, :1], pts_m[:, 2:]], dim=1)
        scores_m = torch.cat([scores_m[:, 1:2], scores_m[:, :1], scores_m[:, 2:]], dim=1)
        d = torch.sqrt(torch.sum(torch.square(pts - pts_m), dim=-1) + 1e-12)
        agree = (d <= tta_agree_radius)[..., None]
        wsum = (scores + scores_m)[..., None]
        fused = (pts * scores[..., None] + pts_m * scores_m[..., None]) / torch.clamp_min(
            wsum, 1e-12)
        pick = torch.where((scores >= scores_m)[..., None], pts, pts_m)
        pts = torch.where(agree, fused, pick)
        scores = torch.maximum(scores, scores_m)
        valid = scores > confidence_threshold
    pts = torch.stack([pts[..., 0] - pad_left, pts[..., 1] - pad_top], dim=-1)
    pts = pts * reciprocal_f32(scale)
    if refine:
        # the second pass in a zoom crop per image: the nose's far tail
        # comes from the letterbox frame
        rmerged, rscores = refine_lm5(detector, images, pts, scores, detector_size,
                                      confidence_threshold)
    if nose_prior is not None:
        w = torch.as_tensor(nose_prior, dtype=torch.float32, device=dev)  # (7, 2)
        feats = torch.cat([pts[:, 0], pts[:, 1], pts[:, 3],
                           torch.ones(pts.shape[0], 1, dtype=pts.dtype, device=dev)], dim=1)
        prior = feats @ w  # (B, 2)
        gate = nose_gate_ratio * torch.clamp_min(_norm(pts[:, 0] - pts[:, 1]), 16.0)
        if refine:
            # a vote of three estimators that fail apart: the coarse decode,
            # the crop's and the prior; any two that agree win
            c, r = pts[:, 2], rmerged[:, 2]
            out = prior
            out = torch.where((_norm(c - prior) <= gate)[:, None], c, out)
            out = torch.where((_norm(r - prior) <= gate)[:, None], r, out)
            out = torch.where((_norm(c - r) <= gate)[:, None], (c + r) * 0.5, out)
            nose = out
            scores = torch.maximum(scores, rscores)
        else:
            # the gate: an implausible nose snaps to the prior; inliers pass
            snap = (_norm(pts[:, 2] - prior) > gate)[:, None]
            nose = torch.where(snap, prior, pts[:, 2])
        pts = torch.cat([pts[:, :2], nose[:, None], pts[:, 3:]], dim=1)
    elif refine:
        pts, scores = rmerged, rscores
        if confidence_threshold:
            valid = scores > confidence_threshold
    # the 5-point form: the mouth midpoint in both corner slots
    lm5 = torch.cat([pts, pts[:, 3:4, :]], dim=1)
    return lm5, valid, scores


def _device_of(detector: MobileNetV2, gen: Generator) -> torch.device:
    device = next(gen.parameters()).device
    det_device = next(detector.parameters()).device
    if det_device != device:
        raise ValueError(f"the detector is on {det_device} and the generator on {device}: "
                         "frontalize runs both on one device")
    return device


def _computes_in_f32(detector: MobileNetV2) -> bool:
    """Every parameter float32, or held narrower by a layer whose compute
    dtype is float32 (``blocks.set_compute_dtype``): the detector then
    computes in float32 either way (``serving.export_frontalize``'s
    narrowed weights)."""
    return all(p.dtype == torch.float32 or getattr(m, "compute_dtype", None) == torch.float32
               for m in detector.modules() for p in m.parameters(recurse=False))


def make_frontalize_fn(
    cfg: Config,
    detector: MobileNetV2,
    gen: Generator,
    detector_size: int = 256,
    tta: bool = False,
    allow_upscale: bool = True,
    refine: bool = False,
    nose_prior=None,
    nose_gate_ratio: float = 0.35,
    quant_scales=None,
    quant_rescale_dtype: Optional[torch.dtype] = None,
    quant_min_channels: Optional[int] = None,
) -> Frontalize:
    """The raw image -> frontal face program: ``frontalize(images, z)``
    with images (B, H, W, 3), uint8 or float in [0, 1], and z (B, zdim)
    (tensors or numpy arrays) returns (fake (B, 128, 128, 3) in [-1, 1]
    in ``cfg.compute_dtype``, lm5 (B, 5, 2), part scores (B, 4)), on the
    device of ``detector`` and ``gen``.

    :func:`detect_lm5` with these options finds the landmarks; the
    detector runs in float32 and eval mode (it is put in eval mode here),
    as the JAX package builds it; the synthesis batch is cropped from
    them (``data/jit_preprocess``) and the generator runs through
    ``make_synthesize_fn`` in ``cfg.compute_dtype``. ``quant_scales``
    (``ops.quant.calibrate_synthesis``'s) swaps the generator stage onto
    the int8 program (``gan_trainer.make_int8_synthesize_fn``, with
    ``quant_rescale_dtype`` / ``quant_min_channels`` as its knobs); the
    detector stays float, as in ``tpgan_tpu/frontalize.py:333-348``.
    ``frontalize.models`` holds the detector and the generator the
    program runs (the generator's compute-dtype or int8 copy)."""
    device = _device_of(detector, gen)
    if not _computes_in_f32(detector):
        raise ValueError("frontalize runs the detector in float32; its parameters are not")
    detector.eval()
    if quant_scales is not None:
        synthesize = make_int8_synthesize_fn(cfg, gen, quant_scales,
                                             rescale_dtype=quant_rescale_dtype,
                                             min_channels=quant_min_channels)
    else:
        synthesize = make_synthesize_fn(cfg, gen)
    prior = None if nose_prior is None else torch.as_tensor(
        np.asarray(nose_prior, np.float32), device=device)

    def frontalize(images, z):
        images = torch.as_tensor(images, device=device)
        lm5, _valid, scores = detect_lm5(
            detector, images, detector_size=detector_size, tta=tta,
            allow_upscale=allow_upscale, refine=refine, nose_prior=prior,
            nose_gate_ratio=nose_gate_ratio)
        batch = preprocess_for_synthesis_lm5(images, lm5)
        fake = synthesize(batch, torch.as_tensor(z, device=device))
        return fake, lm5, scores

    frontalize.device = device
    frontalize.models = {"detector": detector, "generator": synthesize.model}
    return frontalize


def make_graphed_frontalize_fn(cfg: Config, detector: MobileNetV2, gen: Generator,
                               **options) -> Frontalize:
    """:func:`make_frontalize_fn`'s function with the same contract, each
    call one CUDA-graph replay on the card: the whole program, the raw
    frame to (fake, lm5, scores), is captured at the first call of each
    input shape and dtype (after warm-up calls on a side stream), and
    every call copies its inputs into that graph's buffers, replays it
    and returns copies of the outputs. A failed capture raises; nothing
    falls back to eager calls. ``graphed.launches()`` holds each graph's
    kernel launches of one replay. ``options`` are
    :func:`make_frontalize_fn`'s, the int8 ones included. On the CPU it is
    the eager function."""
    frontalize = make_frontalize_fn(cfg, detector, gen, **options)
    if frontalize.device.type != "cuda":
        return frontalize
    return graphs.graphed_per_shape(frontalize, frontalize.device)
