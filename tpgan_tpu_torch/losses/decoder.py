"""Landmark decoders — the port of ``tpgan_tpu/losses/decoder.py``
(reference: MultiTaskDecoder, MobileNetV2.py:536-649): a confidence
threshold, greedy distance-NMS and top-k, as fixed-shape masked tensor
ops batched over images and classes.

The greedy NMS is a loop of exactly ``max_keep`` iterations; each takes
the highest-scoring surviving candidate (the first index among equal
scores, as ``jnp.argmax``), records it and suppresses everything within
the distance threshold. No iteration reads a value back to the host.
Results are dense (B, C, top_k) tensors with a validity mask.

The soft decode ranks each class's candidates by a stable descending
sort: ``lax.top_k`` puts the lower index first among equal scores, and
the candidates' order decides which of two equal cluster masses wins.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import torch


class DecodedLandmarks(NamedTuple):
    points: torch.Tensor  # (B, C, top_k, 2)
    scores: torch.Tensor  # (B, C, top_k)
    valid: torch.Tensor   # (B, C, top_k) bool


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance over the last axis, as the JAX decoder takes it
    (``sqrt(sum(square) + 1e-20)``)."""
    return torch.sqrt(torch.sum(torch.square(a - b), dim=-1) + 1e-20)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx, :]`` per leading index: x (..., N, D), idx (...)."""
    return torch.gather(x, -2, idx[..., None, None].expand(*idx.shape, 1, x.shape[-1]))[..., 0, :]


def masked_nms(
    points: torch.Tensor,  # (..., N, 2)
    scores: torch.Tensor,  # (..., N)
    valid: torch.Tensor,   # (..., N) bool
    distance_threshold: float,
    max_keep: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Greedy distance-NMS (MobileNetV2.py:599-636) with static shapes,
    over any leading batch axes. Returns (kept_points (..., max_keep, 2),
    kept_scores (..., max_keep), kept_valid (..., max_keep)) ordered by
    descending score; slots past the last survivor are zero and invalid."""
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype, device=scores.device)
    alive = valid
    kp, ks, kv = [], [], []
    for _ in range(max_keep):
        s = torch.where(alive, scores, neg_inf)
        idx = torch.argmax(s, dim=-1)
        best = torch.gather(s, -1, idx[..., None])[..., 0]
        found = best > neg_inf
        point = _take(points, idx)
        kp.append(torch.where(found[..., None], point, torch.zeros_like(point)))
        ks.append(torch.where(found, torch.gather(scores, -1, idx[..., None])[..., 0],
                              torch.zeros_like(best)))
        kv.append(found)
        suppress = _dist(points, point[..., None, :]) <= distance_threshold  # includes idx
        alive = alive & torch.where(found[..., None], ~suppress, alive)
    return torch.stack(kp, -2), torch.stack(ks, -1), torch.stack(kv, -1)


def decode_landmarks(
    locations: torch.Tensor,  # (B, N, 2)
    classifications: torch.Tensor,  # (B, N, C)
    confidence_threshold: float = 0.5,
    top_k: int = 1,
    nms_distance_threshold: float = 20.0,
) -> DecodedLandmarks:
    """Batched decode. Defaults mirror MultiTaskDecoder.__init__
    (MobileNetV2.py:537). Per class: the softmax scores above the
    threshold go through :func:`masked_nms`; with ``top_k=1`` this is a
    thresholded per-class argmax, what the reference's threshold + NMS +
    top-1 computes."""
    scores = torch.softmax(classifications.float(), dim=-1).transpose(1, 2)  # (B, C, N)
    pts = locations.float()[:, None].expand(-1, scores.shape[1], -1, -1)
    kp, ks, kv = masked_nms(pts, scores, scores > confidence_threshold,
                            nms_distance_threshold, top_k)
    return DecodedLandmarks(points=kp, scores=ks, valid=kv)


def soft_decode_landmarks(
    locations: torch.Tensor,  # (B, N, 2)
    classifications: torch.Tensor,  # (B, N, C)
    confidence_threshold: float = 0.5,
    candidates: int = 128,
    cluster_radius: float = 15.0,
) -> DecodedLandmarks:
    """Soft-top-k decode for anchor-offset heads: per class, the
    score-weighted mean of the top-``candidates`` anchors' positions
    inside the cluster (radius ``cluster_radius``) around the candidate
    whose neighbourhood holds the most score mass; its confidence is the
    cluster's largest member score. The (B, C, 1, ...) layout of
    :func:`decode_landmarks` with ``top_k=1``. Defaults are the JAX
    package's (its round-4 sweep, ``decoder.py:147-155``)."""
    scores = torch.softmax(classifications.float(), dim=-1).transpose(1, 2)  # (B, C, N)
    n = locations.shape[1]
    candidates = min(candidates, n)
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :candidates], idx[..., :candidates]  # (B, C, K)
    loc = locations.float()
    pts = torch.gather(loc[:, None].expand(-1, idx.shape[1], -1, -1), 2,
                       idx[..., None].expand(*idx.shape, 2))  # (B, C, K, 2)
    d = _dist(pts[..., None, :, :], pts[..., :, None, :])  # (B, C, K, K)
    mass = torch.sum((d <= cluster_radius) * vals[..., None, :], dim=-1)
    centre = _take(pts, torch.argmax(mass, dim=-1))  # (B, C, 2)
    dc = _dist(pts, centre[..., None, :])
    w = vals * (dc <= cluster_radius)
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-12)
    point = torch.sum((w / wsum[..., None])[..., None] * pts, dim=-2)
    conf = torch.amax(w, dim=-1)
    return DecodedLandmarks(points=point[:, :, None], scores=conf[:, :, None],
                            valid=(conf > confidence_threshold)[:, :, None])


def decode_for_head_mode(head_mode: str, confidence_threshold: float = 0.5):
    """The decode matching an SSD-head parameterization: the reference
    NMS + top-1 for ``absolute`` heads, the soft-top-k cluster decode for
    ``anchor_offset`` heads. Returns fn(locations, classifications) ->
    DecodedLandmarks with a (B, C, 1, ...) layout either way."""
    if head_mode == "anchor_offset":
        return partial(soft_decode_landmarks, confidence_threshold=confidence_threshold)
    return partial(decode_landmarks, confidence_threshold=confidence_threshold, top_k=1)
