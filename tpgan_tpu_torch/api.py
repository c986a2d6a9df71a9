"""The inference API of the full stack, raw images to frontal faces —
the port of ``tpgan_tpu/api.py``: the landmark detector (MobileNetV2 +
SSD, ``models/mobilenet_v2.py``), the preprocessing of
``data/jit_preprocess.py`` and the generator, on the device of the
modules given.

``tpgan_tpu_torch.frontalize`` is the serving path built from the same
pieces (letterbox, test-time mirror, refinement, the nose prior);
:func:`make_full_inference_fn` is the plain chain, kept as the JAX
package keeps it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from tpgan_tpu_torch.config import Config
from tpgan_tpu_torch.data.jit_preprocess import preprocess_for_synthesis_lm5
from tpgan_tpu_torch.losses.decoder import decode_for_head_mode
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2
from tpgan_tpu_torch.ops.resize import resize
from tpgan_tpu_torch.train.gan_trainer import make_synthesize_fn

# the 5-point preprocessing of known landmarks: the JAX package's
# ``api.preprocess_from_landmarks5`` is ``jit_preprocess.
# preprocess_for_synthesis_lm5`` line for line, so the port has one
preprocess_from_landmarks5 = preprocess_for_synthesis_lm5


def landmarks5_from_detection(points4: torch.Tensor) -> torch.Tensor:
    """Detector points (B, 4, 2) [left eye, right eye, nose, mouth
    centre] -> the 5-point layout the crops take: both mouth corners set
    to the centre, whose midpoint is then the centre itself
    (DataAndDataset.py:42-43)."""
    mouth = points4[:, 3:4, :]
    return torch.cat([points4[:, :3, :], mouth, mouth], dim=1)


def run_detector(detector: MobileNetV2, images: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The detector's (loc (B, N, 2), cls (B, N, C)) for NHWC float32
    ``images``, without autograd (the detector takes NCHW)."""
    with torch.inference_mode():
        return detector(images.permute(0, 3, 1, 2).contiguous())


def detect_landmarks(detector: MobileNetV2, images: torch.Tensor,
                     confidence_threshold: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """The detector's part points (B, 4, 2) in the pixels of ``images``
    (B, H, W, 3), float in [0, 1], and their (B, 4) validity, decoded
    for the detector's head mode (NMS + top-1 for ``absolute``, the soft
    cluster for ``anchor_offset``). The detector runs in the mode it is
    in: :func:`make_full_inference_fn` puts it in eval mode."""
    loc, cls = run_detector(detector, images)
    decoded = decode_for_head_mode(detector.head_mode, confidence_threshold)(loc, cls)
    return decoded.points[:, :4, 0, :], decoded.valid[:, :4, 0]


def make_full_inference_fn(cfg: Config, gen: Generator, detector: MobileNetV2,
                           detector_input_size: int = 256
                           ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """``infer(images (B, H, W, 3), z (B, zdim))`` -> the frontal faces
    (B, 128, 128, 3) in [-1, 1]: the landmarks detected on a bilinear
    ``detector_input_size`` square copy and scaled back, the synthesis
    batch cropped from them, the generator (``make_synthesize_fn``, in
    ``cfg.compute_dtype``). Runs where ``gen`` and ``detector`` are; the
    detector in eval mode.

    As ``tpgan_tpu/api.py:189-195`` stands, the detector's copy is
    resized from ``images`` as float32 with no division by 255 and then
    clipped to [0, 1]: the function expects float images in [0, 1], and
    a uint8 image reaches the detector nearly binary (the preprocessing
    of the synthesis batch does divide uint8 by 255)."""
    device = next(gen.parameters()).device
    synthesize = make_synthesize_fn(cfg, gen)
    detector.eval()

    def infer(images, z) -> torch.Tensor:
        images = torch.as_tensor(images, device=device)
        b, h, w, _ = images.shape
        s = detector_input_size
        det_in = torch.clamp(resize(images.to(torch.float32), (b, s, s, 3), "linear"), 0.0, 1.0)
        pts, _valid = detect_landmarks(detector, det_in)
        pts = torch.stack([pts[..., 0] * (w / s), pts[..., 1] * (h / s)], dim=-1)
        batch = preprocess_from_landmarks5(images, landmarks5_from_detection(pts))
        return synthesize(batch, torch.as_tensor(z, device=device))

    return infer
