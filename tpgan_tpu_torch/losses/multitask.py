"""SSD-style landmark multi-task loss — the port of
``tpgan_tpu/losses/multitask.py`` (reference: MobileNetV2.py:342-534), as
fixed-shape masked tensor ops batched over the images: no Python loop
over items and no value read back to the host.

Per image:

1. distances (N, 4) from every prediction (or, with ``assign_points``,
   every static anchor centre) to the 4 ground-truth points;
2. per label, the threshold is the k-th smallest distance, k = ratio * N;
   positives are the predictions within it (MobileNetV2.py:394-412);
3. each positive takes its nearest label (the first among equal
   distances); the rest are background (:414-443);
4. loss = alpha * sum_label MSE(normalised positive coords, label coord)
        + beta * [ sum_label CE(positives, label)
                 + CE(a random background subsample of at most
                      ratio_bg * #positives, background class) ]  (:480-533)

The background subsample ranks the background predictions by uniforms
``u`` (B, N), stably; the caller passes them (the tests inject JAX's
``jax.random.uniform`` draws) or a ``torch.Generator`` to draw them from.

The coordinate clips are built from ``torch.maximum`` / ``torch.minimum``,
the ops ``jnp.clip`` lowers to, so an input exactly on a clip corner
takes JAX's gradient of 0.5 (``torch.clamp`` would give 1): every anchor
the absolute head's ReLU zeroed sits on the lower corner.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

NUM_LABELS = 4


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, as the JAX loss casts it; float64 stays float64
    (a float64 run of the port is the tests' reference for f32 noise)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _bound(v, x: torch.Tensor) -> torch.Tensor:
    """A clip bound in ``x``'s dtype on its device; a Python number by a
    fill kernel, not a copy from the host (a CUDA-graph capture of the
    anchor head's forward makes its bounds)."""
    if torch.is_tensor(v):
        return v.to(dtype=x.dtype, device=x.device)
    return torch.full((), v, dtype=x.dtype, device=x.device)


def clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` = ``minimum(maximum(x, lo), hi)``, with its
    gradient of 0.5 at a tie on either corner."""
    return torch.minimum(torch.maximum(x, _bound(lo, x)), _bound(hi, x))


def landmark_assignment(
    points: torch.Tensor,  # (B, N, 2) or (N, 2): what the distances are measured from
    loc_true: torch.Tensor,  # (B, 8)
    distance_threshold_ratio: float,
) -> torch.Tensor:
    """The positive assignment: (B, N) int64, the nearest label of each
    prediction within its labels' k-th smallest distance, -1 for
    background. Distances in float32, as JAX takes them."""
    b = loc_true.shape[0]
    lt = loc_true.reshape(b, NUM_LABELS, 2).float()
    ap = points.detach().float()
    if ap.dim() == 2:
        ap = ap[None]
    n = ap.shape[1]
    d = torch.sqrt(torch.sum(torch.square(ap[:, :, None, :] - lt[:, None, :, :]), dim=-1)
                   + 1e-20)  # (B, N, 4)
    k = max(int(distance_threshold_ratio * n), 1)
    thresh = torch.kthvalue(d, k, dim=1).values  # (B, 4)
    pos = d <= thresh[:, None, :]
    d_masked = torch.where(pos, d, torch.full((), float("inf"), device=d.device))
    assigned = torch.argmin(d_masked, dim=-1)
    return torch.where(pos.any(dim=-1), assigned, torch.full_like(assigned, -1))


def background_keep(assigned: torch.Tensor, u: torch.Tensor,
                    ratio_non_background: float) -> torch.Tensor:
    """(B, N) bool: the background predictions whose stable rank by ``u``
    among the background is below floor(ratio * #positives)."""
    bg = assigned == -1
    n_pos = torch.sum(~bg, dim=-1)
    max_bg = torch.floor(ratio_non_background * n_pos.float()).long()
    keyed = torch.where(bg, u.float(), torch.full((), float("inf"), device=u.device))
    order = torch.argsort(keyed, dim=-1, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(order.shape[-1], device=order.device).expand_as(order))
    return bg & (rank < max_bg[:, None])


def multitask_landmark_loss(
    loc_pred: torch.Tensor,  # (B, N, 2)
    cls_pred: torch.Tensor,  # (B, N, C), background = last class
    loc_true: torch.Tensor,  # (B, 8)
    u: Optional[torch.Tensor] = None,  # (B, N) uniforms of the background draw
    *,
    image_size: Tuple[int, int],  # (height, width)
    alpha: float = 30.0,
    beta: float = 0.1,
    distance_threshold_ratio: float = 0.1,
    ratio_non_background: float = 5.0,
    assign_points: Optional[torch.Tensor] = None,  # (N, 2) static anchor centres
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batched multi-task landmark loss: (mean total loss, aux). ``aux``
    holds the means of ``location_loss``, ``classification_loss`` and
    ``num_positives`` (as the JAX loss returns them) and the assignment:
    ``assigned`` (B, N) and ``keep_bg`` (B, N). Defaults mirror
    config.py:25-27. ``u``: the background draw's uniforms, else drawn
    with ``torch.rand`` from ``generator`` on the predictions' device.
    ``assign_points``: the anchor head's static assignment points; None
    measures from the predictions (reference parity)."""
    b, n, _ = loc_pred.shape
    if u is None:
        if generator is None:
            raise ValueError("multitask_landmark_loss needs the uniforms u or a generator")
        u = torch.rand((b, n), generator=generator, device=loc_pred.device)
    lp = _wide(loc_pred)
    lt = _wide(loc_true.reshape(b, NUM_LABELS, 2)).to(lp.dtype)
    assigned = landmark_assignment(lp if assign_points is None else assign_points,
                                   loc_true, distance_threshold_ratio)

    h, w = image_size
    size = torch.tensor([w, h], dtype=lp.dtype, device=lp.device)
    p = clip(lp / size, 0.0, 1.0)
    t = clip(lt / size, 0.0, 1.0)

    # per-label MSE over the label's positives, summed (:481-489)
    sq = torch.mean(torch.square(p[:, :, None, :] - t[:, None, :, :]), dim=-1)  # (B, N, 4)
    onehot = (assigned[..., None] == torch.arange(NUM_LABELS, device=lp.device)).to(lp.dtype)
    counts = onehot.sum(dim=1)  # (B, 4)
    denom = torch.clamp_min(counts, 1.0)
    zero = torch.zeros((), dtype=lp.dtype, device=lp.device)
    location_loss = torch.where(counts > 0, torch.sum(sq * onehot, dim=1) / denom, zero).sum(-1)

    # per-label CE over the positives, summed (:520-528)
    logp = torch.log_softmax(_wide(cls_pred), dim=-1)
    ce = torch.where(counts > 0, torch.sum(-logp[..., :NUM_LABELS] * onehot, dim=1) / denom,
                     zero).sum(-1)

    # background CE over the subsample (:492-517)
    keep_bg = background_keep(assigned, u, ratio_non_background)
    keep = keep_bg.to(lp.dtype)
    n_bg = keep.sum(-1)
    ce = ce + torch.where(n_bg > 0, torch.sum(-logp[..., -1] * keep, dim=-1)
                          / torch.clamp_min(n_bg, 1.0), zero)

    total = alpha * location_loss + beta * ce
    aux = {
        "location_loss": location_loss.mean(),
        "classification_loss": ce.mean(),
        "num_positives": counts.sum(-1).mean(),
        "assigned": assigned,
        "keep_bg": keep_bg,
    }
    return total.mean(), aux
