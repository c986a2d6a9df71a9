"""Synthesis preprocessing on the device — the port of
``tpgan_tpu/data/jit_preprocess.py``, the reference's host-side
TestDataset path (DataAndDataset.py:230-256) as tensor ops over a
fixed-shape batch:

    raw images (B, H, W, 3) + 68-point landmarks (B, 68, 2)
      -> the 68 -> 5 landmark reduction (UtilityMethods.py:147-164)
      -> the landmarks rescaled to the 128x128 frame (:244-246)
      -> Lanczos-3 resize to 128, then 64, then 32, each clipped to
         [0, 1] (:247,250-251), through ``ops.resize``, the port's copy of
         ``jax.image``'s resampler
      -> landmark-centred patch crops (:248, ``data.patches``)
      -> [-1, 1] (:253-255)

Every op runs on the images' device, and no value goes back to the host:
:func:`make_synthesis_pipeline` captures preprocessing and the generator
forward as one CUDA graph on the card.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import torch

from tpgan_tpu_torch.data.patches import crop_patches_batch
from tpgan_tpu_torch.ops.resize import reciprocal_f32, resize
from tpgan_tpu_torch.utils import graphs
from tpgan_tpu_torch.utils.misc import FIVE_PTS_IDX, small_mean


def five_landmarks_from_68_batch(lm68: torch.Tensor) -> torch.Tensor:
    """Batched 68 -> 5 reduction, (B, 68+, 2) -> (B, 5, 2): the mean of
    each index range of ``utils.misc.FIVE_PTS_IDX`` (``small_mean``: JAX's
    float32 bits), with its 68-row fallback (a range past the last row
    takes dlib's right mouth corner, index 54)."""
    n = lm68.shape[1]
    outs = []
    for lo, hi in FIVE_PTS_IDX:
        if lo >= n:
            lo = hi = 54
        outs.append(small_mean(lm68[:, lo:hi + 1, :], dim=1))
    return torch.stack(outs, dim=1)


def to_unit_float(images: torch.Tensor) -> torch.Tensor:
    """uint8 images / 255, as JAX's jitted program takes it (the product
    with float32(1 / 255): ``ops.resize.reciprocal_f32``), the same bits
    on the card and on the CPU; float images as they are, in float32."""
    x = images.to(torch.float32)
    if images.dtype == torch.uint8:
        x = x * reciprocal_f32(255.0)
    return x


def preprocess_for_synthesis(images: torch.Tensor, landmarks68: torch.Tensor
                             ) -> Dict[str, torch.Tensor]:
    """The synthesis batch of ``images`` (B, H, W, 3), uint8 or float in
    [0, 1], and their 68-point landmarks (B, 68, 2) in pixels of the
    source frame: ``img`` / ``img64`` / ``img32`` and the four patches,
    NHWC float32 in [-1, 1] on the images' device."""
    lm5 = five_landmarks_from_68_batch(landmarks68.to(torch.float32))
    return preprocess_for_synthesis_lm5(images, lm5)


def preprocess_for_synthesis_lm5(images: torch.Tensor, lm5: torch.Tensor
                                 ) -> Dict[str, torch.Tensor]:
    """:func:`preprocess_for_synthesis` entered with 5-point landmarks
    (B, 5, 2), the form the landmark detector emits (``frontalize``)."""
    b, h, w, _ = images.shape
    x = to_unit_float(images)
    lm5 = lm5.to(torch.float32)
    lm5 = torch.stack([lm5[..., 0] * (128.0 / w), lm5[..., 1] * (128.0 / h)], dim=-1)
    # clipped after each resize: Lanczos ringing overshoots [0, 1], which
    # PIL's uint8 output clamps (parity with the host path)
    img128 = torch.clamp(resize(x, (b, 128, 128, 3), "lanczos3"), 0.0, 1.0)
    img64 = torch.clamp(resize(img128, (b, 64, 64, 3), "lanczos3"), 0.0, 1.0)
    img32 = torch.clamp(resize(img64, (b, 32, 32, 3), "lanczos3"), 0.0, 1.0)
    batch = {name: patch * 2.0 - 1.0 for name, patch in crop_patches_batch(img128, lm5).items()}
    batch["img"] = img128 * 2.0 - 1.0
    batch["img64"] = img64 * 2.0 - 1.0
    batch["img32"] = img32 * 2.0 - 1.0
    return batch


def make_synthesis_pipeline(
    synthesize: Callable[[Mapping[str, torch.Tensor], torch.Tensor], torch.Tensor],
) -> Callable[..., torch.Tensor]:
    """Preprocessing and the generator forward as one program:
    ``pipeline(images, landmarks68, z)`` -> the frontal faces (B, 128,
    128, 3), raw images in (uint8 or float in [0, 1]; tensors or numpy
    arrays), on the device of ``synthesize`` (a
    ``train.gan_trainer.make_synthesize_fn`` function).

    On the card each input shape is captured once as a CUDA graph (after
    warm-up calls on a side stream), and every call copies its inputs
    into that graph's buffers, replays it and returns a copy of its
    output; a failed capture raises, nothing falls back to eager calls.
    On the CPU it is the eager function."""
    device = synthesize.device

    def eager(images, landmarks68, z):
        images = torch.as_tensor(images, device=device)
        batch = preprocess_for_synthesis(images, torch.as_tensor(landmarks68, device=device))
        return synthesize(batch, torch.as_tensor(z, device=device))

    if device.type != "cuda":
        return eager
    return graphs.graphed_per_shape(eager, device)

