"""MobileNetV2 backbone + SSD-style landmark head — the port of
``tpgan_tpu/models/mobilenet_v2.py`` (reference: MobileNetV2.py:10-340).

* :class:`InvertedResidual` — expand (1x1, x6) -> depthwise (3x3) ->
  project (1x1), BN + RELU6, residual add iff stride 1 and in == out
  (:81-120). The identity embedder's MobileNetV2 branch
  (:class:`tpgan_tpu_torch.models.feature_extract.MobileNetV2Classifier`)
  is built from it too.
* :class:`MobileNetV2` — the landmark detector: stem conv (3->32, s2),
  the 17 inverted residuals of the t/c/n/s table, a 1x1 conv to 1280,
  seven extra convs (biased, no norm, no activation), and feature taps
  at block 12, after conv2 and at extras 1/3/4/6 (:199-213), into
  :class:`SSDHead`. The reference's He init (:220-250): convs
  N(0, sqrt(2 / (k*k*out))), the head's and the extras' biases zero.
* :class:`SSDHead` — a 3x3 loc and a 3x3 cls conv per tapped scale (in
  96/1280/512/256/256/128 channels, 4/6/6/6/6/6 anchors; :28-44), in
  both of the JAX package's head modes: ``absolute`` (the loc conv
  emits the ReLU-clamped pixel coordinate, :67) and ``anchor_offset``
  (coord = cell centre + raw * stride, clipped to the image).

Activations are NCHW. The head permutes each scale's output to NHWC
before flattening it, so the (B, N, 2) / (B, N, C) predictions come in
the JAX package's order: per scale, (row, column, anchor) row-major.
Every clip is ``torch.maximum`` / ``torch.minimum``, the ops JAX's
``jnp.maximum(x, 0)`` and ``jnp.clip`` are, so a value on a corner takes
their gradient of 0.5 (``torch.relu`` gives 0 there, ``torch.clamp`` 1).
The convs, the depthwise ones too, go to cuDNN, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from tpgan_tpu_torch.losses.decoder import DecodedLandmarks, decode_landmarks
from tpgan_tpu_torch.losses.multitask import clip
from tpgan_tpu_torch.ops import initializers as init_lib
from tpgan_tpu_torch.ops.activations import RELU6, apply_activation
from tpgan_tpu_torch.ops.blocks import BatchNorm2d, Conv2d

# t (expansion), c (out channels), n (repeats), s (first stride)
# (reference: MobileNetV2.py:133-142)
INVERTED_RESIDUAL_SETTING = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

# 6 SSD feature scales: (input channels, anchors) (reference: :28-44)
SSD_SCALES = ((96, 4), (1280, 6), (512, 6), (256, 6), (256, 6), (128, 6))
# the downsamplings before each tapped scale: block 12 /16, conv2 /32,
# extra1 /64, extra3 /128, extra4 /256, extra6 /512
SSD_DOWNSAMPLINGS = (4, 5, 6, 7, 8, 9)
# extra pyramid (reference: :177-185): (cin, cout, k, s, p)
EXTRA_LAYERS = (
    (1280, 512, 1, 1, 0),
    (512, 512, 3, 2, 1),
    (512, 256, 1, 1, 0),
    (256, 256, 3, 2, 1),
    (256, 256, 3, 2, 1),
    (256, 128, 1, 1, 0),
    (128, 128, 3, 2, 1),
)
EXTRA_TAPS = (1, 3, 4, 6)
FIRST_TAP_BLOCK = 12
NUM_LANDMARK_CLASSES = 5  # left eye, right eye, nose, mouth + background
HEAD_MODES = ("absolute", "anchor_offset")


class InvertedResidual(nn.Module):
    """expand (1x1, x``expand_ratio``) -> depthwise (3x3, ``groups`` =
    width) -> project (1x1), each followed by BatchNorm, the first two by
    RELU6; the input is added back iff stride is 1 and in == out. Convs
    are bias-free with MobileNetV2's He init (``init_lib.he_ssd_conv``)."""

    def __init__(self, inp: int, oup: int, stride: int = 1, expand_ratio: int = 6,
                 device=None):
        super().__init__()
        mid = inp * expand_ratio
        he = init_lib.he_ssd_conv()
        self.expand = Conv2d(inp, mid, 1, 1, 0, use_bias=False, kernel_init=he, device=device)
        self.expand_bn = BatchNorm2d(mid, device=device)
        self.depthwise = Conv2d(mid, mid, 3, stride, 1, use_bias=False, kernel_init=he,
                                groups=mid, device=device)
        self.depthwise_bn = BatchNorm2d(mid, device=device)
        self.project = Conv2d(mid, oup, 1, 1, 0, use_bias=False, kernel_init=he, device=device)
        self.project_bn = BatchNorm2d(oup, device=device)
        self.residual = stride == 1 and inp == oup

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = apply_activation(self.expand_bn(self.expand(x)), RELU6)
        h = apply_activation(self.depthwise_bn(self.depthwise(h)), RELU6)
        h = self.project_bn(self.project(h))
        return x + h if self.residual else h


def _he_conv(cin, cout, k, s, p, use_bias=True, device=None, groups=1) -> Conv2d:
    return Conv2d(cin, cout, k, s, p, use_bias=use_bias, kernel_init=init_lib.he_ssd_conv(),
                  bias_init=init_lib.zeros, groups=groups, device=device)


def _scale_grid(ih: int, iw: int, fh: int, fw: int, device=None):
    """The (fh, fw, 2) cell centres ((j + 0.5) * stride_x, (i + 0.5) *
    stride_y) of one scale, as (x, y) f32 pairs, and its (2,) stride."""
    sy, sx = ih / fh, iw / fw
    cx = (torch.arange(fw, dtype=torch.float32, device=device) + 0.5) * sx
    cy = (torch.arange(fh, dtype=torch.float32, device=device) + 0.5) * sy
    grid = torch.stack(torch.broadcast_tensors(cx[None, :], cy[:, None]), dim=-1)
    return grid, torch.tensor([sx, sy], dtype=torch.float32, device=device)


class SSDHead(nn.Module):
    """Per-scale loc/cls convs. ``head_mode="absolute"``: the loc conv's
    output is the landmark's absolute pixel coordinate, clamped at 0
    (reference parity). ``head_mode="anchor_offset"``: each cell's anchor
    sits at its centre and the conv regresses the offset in stride units,
    decoded in f32 and clipped per axis to the image bounds — the JAX
    package's redesign (``tpgan_tpu/models/mobilenet_v2.py:101-133``)."""

    def __init__(self, num_of_out_classes: int = NUM_LANDMARK_CLASSES,
                 head_mode: str = "absolute", device=None):
        super().__init__()
        if head_mode not in HEAD_MODES:
            raise ValueError(f"unknown head_mode: {head_mode!r}")
        self.num_classes = num_of_out_classes
        self.head_mode = head_mode
        for idx, (cin, anchors) in enumerate(SSD_SCALES):
            setattr(self, f"loc{idx}", _he_conv(cin, anchors * 2, 3, 1, 1, device=device))
            setattr(self, f"cls{idx}", _he_conv(cin, anchors * num_of_out_classes, 3, 1, 1,
                                                device=device))

    def forward(self, features: Sequence[torch.Tensor],
                image_hw: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.head_mode == "anchor_offset" and image_hw is None:
            raise ValueError("anchor_offset head needs image_hw")
        locations, classifications = [], []
        zero = torch.zeros((), device=features[0].device)
        for idx, (_cin, anchors) in enumerate(SSD_SCALES):
            feat = features[idx]
            b, _, fh, fw = feat.shape
            loc = getattr(self, f"loc{idx}")(feat).permute(0, 2, 3, 1)  # NHWC
            if self.head_mode == "anchor_offset":
                ih, iw = int(image_hw[0]), int(image_hw[1])
                centres, stride = _scale_grid(ih, iw, fh, fw, feat.device)
                raw = loc.float().reshape(b, fh, fw, anchors, 2)
                decoded = centres[None, :, :, None, :] + raw * stride
                hi = torch.tensor([iw, ih], dtype=torch.float32, device=feat.device)
                loc = clip(decoded, 0.0, hi).reshape(b, -1, 2)
            else:
                loc = torch.maximum(loc.reshape(b, -1, 2), zero.to(loc.dtype))
            locations.append(loc)
            cls = getattr(self, f"cls{idx}")(feat).permute(0, 2, 3, 1)
            classifications.append(cls.reshape(b, -1, self.num_classes))
        return torch.cat(locations, dim=1), torch.cat(classifications, dim=1)


class MobileNetV2(nn.Module):
    """The landmark detector. ``forward(x)`` takes NCHW images and
    returns ``(loc (B, N, 2), cls (B, N, num_of_out_classes))``.
    ``use_dropout`` is accepted and ignored, as in the reference (:189).
    Parameter names follow the JAX tree (``stem``, ``block{i}``,
    ``conv2``, ``extra{i}``, ``ssd_head.loc{j}`` / ``cls{j}``), which
    keeps :func:`tpgan_tpu_torch.convert.jax_detector_variables_to_state_dict`
    a mechanical walk."""

    def __init__(self, num_of_out_classes: int = NUM_LANDMARK_CLASSES,
                 head_mode: str = "absolute", device=None):
        super().__init__()
        self.stem = _he_conv(3, 32, 3, 2, 1, use_bias=False, device=device)
        self.stem_bn = BatchNorm2d(32, device=device)
        self.blocks: List[str] = []
        cin = 32
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            for rep in range(n):
                name = f"block{len(self.blocks)}"
                setattr(self, name, InvertedResidual(cin, c, s if rep == 0 else 1, t,
                                                     device=device))
                self.blocks.append(name)
                cin = c
        self.conv2 = _he_conv(320, 1280, 1, 1, 0, use_bias=False, device=device)
        self.conv2_bn = BatchNorm2d(1280, device=device)
        for i, (ci, co, k, s, p) in enumerate(EXTRA_LAYERS):
            setattr(self, f"extra{i}", _he_conv(ci, co, k, s, p, device=device))
        self.ssd_head = SSDHead(num_of_out_classes, head_mode, device=device)

    @property
    def head_mode(self) -> str:
        return self.ssd_head.head_mode

    def forward(self, x: torch.Tensor, use_dropout: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        del use_dropout
        features = []
        h = apply_activation(self.stem_bn(self.stem(x)), RELU6)
        for i, name in enumerate(self.blocks):
            h = getattr(self, name)(h)
            if i == FIRST_TAP_BLOCK:
                features.append(h)
        h = apply_activation(self.conv2_bn(self.conv2(h)), RELU6)
        features.append(h)
        for i in range(len(EXTRA_LAYERS)):
            h = getattr(self, f"extra{i}")(h)
            if i in EXTRA_TAPS:
                features.append(h)
        return self.ssd_head(features, image_hw=(x.shape[2], x.shape[3]))


def _anchor_grid(image_hw, device=None):
    """Per anchor, in the head's concatenation order: the (N, 2) centres
    and the (N, 1) pixel stride of its scale."""
    ih, iw = int(image_hw[0]), int(image_hw[1])

    def down(v, n):
        for _ in range(n):
            v = (v + 1) // 2  # every downsampling in the pyramid is k3 s2 p1
        return v

    centres, strides = [], []
    for n_down, (_cin, anchors) in zip(SSD_DOWNSAMPLINGS, SSD_SCALES):
        fh, fw = down(ih, n_down), down(iw, n_down)
        grid, stride = _scale_grid(ih, iw, fh, fw, device)
        centres.append(grid[:, :, None, :].expand(fh, fw, anchors, 2).reshape(-1, 2))
        strides.append(stride.expand(fh * fw * anchors, 2))
    return torch.cat(centres, dim=0), torch.cat(strides, dim=0)


def anchor_centres(image_hw, device=None) -> torch.Tensor:
    """The (N, 2) anchor-centre grid in the SSD head's concatenation
    order — per scale, (row, column, anchor) row-major, (x, y) pixel
    pairs; the anchor head emits it verbatim when its loc convs are
    zero. The anchor head's loss assigns its positives from it."""
    return _anchor_grid(image_hw, device)[0]


def anchor_strides(image_hw, device=None) -> torch.Tensor:
    """The (N, 2) pixel strides (x, y) of the anchors' scales, in the
    head's order: the anchor head decodes ``centre + raw * stride``, so
    ``(loc - anchor_centres) / anchor_strides`` is what its convs emit
    (where the decode was not clipped)."""
    return _anchor_grid(image_hw, device)[1]


def find_best_coordinates(locations: torch.Tensor, classifications: torch.Tensor,
                          distance_threshold: float = 15.0) -> DecodedLandmarks:
    """The best coordinate per part by NMS + top-1 decode: the working
    equivalent of the reference's dead-code helper (MobileNetV2.py:
    290-340, which indexes a 10-channel location tensor the head never
    emits), as the JAX package defines it."""
    return decode_landmarks(locations, classifications, confidence_threshold=0.0, top_k=1,
                            nms_distance_threshold=distance_threshold)
