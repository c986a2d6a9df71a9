"""Evaluation — the port of ``tpgan_tpu/evaluate.py`` and of the scoring
body of ``tpgan_tpu/cli.py::cmd_eval`` (``:505-613``, the ground-truth
landmark path): pixel parity (PSNR, SSIM) of frontalized outputs against
the frontal ground truth, identity similarity and Rank-1 identification
through the identity embedder, per camera and over noise draws.

Images are NHWC, as the JAX functions and the synthesis function's output
are; the embed function takes NCHW, as the train step's identity term
calls it (``models.feature_extract.make_identity_embed_fn``), so the
images are permuted on the way in. The SSIM filter is a depthwise 11x11
Gaussian, ``F.conv2d(groups=C)``: the JAX package hands it to XLA.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from tpgan_tpu_torch.data.multipie import camera_token

EmbedFn = Callable[[torch.Tensor], torch.Tensor]


def _clipped_f32(a, b, data_range: float, clip: bool):
    a = torch.as_tensor(a).float()
    b = torch.as_tensor(b, device=a.device).float()
    if clip:
        half = data_range / 2.0
        a, b = a.clamp(-half, half), b.clamp(-half, half)
    return a, b


def psnr(a, b, data_range: float = 2.0, aggregate: bool = True, clip: bool = True
         ) -> torch.Tensor:
    """Peak signal-to-noise ratio per image of an NHWC batch (their mean
    unless ``aggregate=False``); ``data_range`` 2 for [-1, 1]. ``clip``
    clamps both inputs to the data range first: the activation-free
    parity head can emit values outside it."""
    a, b = _clipped_f32(a, b, data_range, clip)
    mse = (a - b).square().mean(dim=(1, 2, 3))
    v = 10.0 * torch.log10((data_range ** 2) / mse.clamp_min(1e-12))
    return v.mean() if aggregate else v


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma).square())
    g = g / g.sum()
    return torch.outer(g, g)


def ssim(a, b, data_range: float = 2.0, aggregate: bool = True, clip: bool = True
         ) -> torch.Tensor:
    """Mean SSIM (Wang et al.) over an NHWC batch with the 11x11 Gaussian
    window (sigma 1.5, VALID), scikit-image's defaults; per image with
    ``aggregate=False``. As in the JAX function: the second moments are
    taken of the images centred on their own mean (``E[(x - mu)^2]``, not
    the cancelling ``E[x^2] - mu^2``), the variances clamped at 0 and the
    covariance clipped to +-sqrt(var_a var_b) (Cauchy-Schwarz), so SSIM
    stays in [-1, 1] on near-constant windows; ``clip`` clamps the inputs
    to the data range."""
    a, b = _clipped_f32(a, b, data_range, clip)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    a, b = a.permute(0, 3, 1, 2), b.permute(0, 3, 1, 2)
    c = a.shape[1]
    kern = _gaussian_kernel().to(a.device)[None, None].repeat(c, 1, 1, 1)

    def filt(x):
        return F.conv2d(x, kern, groups=c)

    mu_a, mu_b = filt(a), filt(b)
    ac = a - a.mean(dim=(2, 3), keepdim=True)
    bc = b - b.mean(dim=(2, 3), keepdim=True)
    mu_ac, mu_bc = filt(ac), filt(bc)
    sa = (filt(ac * ac) - mu_ac * mu_ac).clamp_min(0.0)
    sb = (filt(bc * bc) - mu_bc * mu_bc).clamp_min(0.0)
    sab = filt(ac * bc) - mu_ac * mu_bc
    bound = torch.sqrt(sa * sb)
    sab = torch.minimum(torch.maximum(sab, -bound), bound)
    s = ((2 * mu_a * mu_b + c1) * (2 * sab + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (sa + sb + c2))
    return s.mean() if aggregate else s.mean(dim=(1, 2, 3))


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit length, the norm clipped at 1e-12 (as JAX's)."""
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def rank1_correct(probe_embeddings, probe_labels, gallery_embeddings, gallery_labels
                  ) -> torch.Tensor:
    """Per-probe Rank-1 hit mask (bool, (P,)): each probe takes the label
    of its cosine-nearest gallery embedding (the first on ties, as
    ``jnp.argmax``)."""
    p = l2_normalize(torch.as_tensor(probe_embeddings).float())
    g = l2_normalize(torch.as_tensor(gallery_embeddings, device=p.device).float())
    nearest = torch.argmax(p @ g.T, dim=-1)
    gallery_labels = torch.as_tensor(gallery_labels, device=p.device)
    return gallery_labels[nearest] == torch.as_tensor(probe_labels, device=p.device)


def rank1_accuracy(probe_embeddings, probe_labels, gallery_embeddings, gallery_labels
                   ) -> torch.Tensor:
    """Cosine nearest-neighbour Rank-1 identification accuracy."""
    return rank1_correct(probe_embeddings, probe_labels, gallery_embeddings,
                         gallery_labels).float().mean()


def _embed_nhwc(embed_fn: EmbedFn, images) -> torch.Tensor:
    return embed_fn(torch.as_tensor(images).permute(0, 3, 1, 2))


def evaluate_frontalization(
    synthesize_fn: Callable,
    embed_fn: EmbedFn,
    probe_batch: Mapping,
    probe_labels,
    gallery_images,
    gallery_labels,
    frontal_gt,
    z,
) -> Dict[str, torch.Tensor]:
    """Synthesize frontal probes (``synthesize_fn(batch, z)``, the weights
    bound in it), then PSNR and SSIM against ``frontal_gt`` and Rank-1
    through ``embed_fn`` against the gallery (NHWC images)."""
    fake = synthesize_fn(probe_batch, z)
    gt = torch.as_tensor(frontal_gt, device=fake.device)
    gallery = torch.as_tensor(gallery_images, device=fake.device)
    return {
        "psnr": psnr(fake, gt),
        "ssim": ssim(fake, gt),
        "rank1": rank1_accuracy(_embed_nhwc(embed_fn, fake), probe_labels,
                                _embed_nhwc(embed_fn, gallery), gallery_labels),
    }


def evaluate_protocol(
    synthesize: Callable,
    batches: Iterable[Mapping],
    img_list: Sequence[str],
    zdim: int,
    *,
    embed: Optional[EmbedFn] = None,
    z_samples: int = 1,
    generator: Optional[torch.Generator] = None,
    draw_z: Optional[Callable[[int, int, int], object]] = None,
) -> Dict[str, object]:
    """Score a frontalization protocol with ground-truth landmarks — the
    body of ``cmd_eval`` (``tpgan_tpu/cli.py:505-613``).

    ``synthesize(batch, z)``: an NHWC synthesis function
    (``make_synthesize_fn`` or ``make_graphed_synthesize_fn``).
    ``batches``: the TrainDataset batches in ``img_list``'s order (``img``,
    the four patches, ``img_frontal``, ``label``). Each batch is scored for
    ``z_samples`` noise draws: ``z ~ N(0, 1)`` from ``generator``, or
    ``draw_z(batch_index, z_index, batch_size)`` when given (the tests
    inject JAX's draws). ``embed``: the identity embed function (NCHW).

    Returns ``psnr`` and ``ssim`` (per-item means over z, averaged),
    ``num_images``, ``landmarks``; with ``z_samples`` > 1, ``z_samples``,
    ``psnr_z_std`` and ``ssim_z_std`` (the spread over z of the set's
    mean); with ``embed``, ``identity_sim`` (the mean cosine between the
    embeddings of each first-draw fake and of its frontal image) and
    ``rank1`` against a gallery of each label's first frontal image; and
    ``per_camera`` (keyed by ``data.multipie.camera_token``), unless the
    listed and evaluated counts differ, which is reported on stderr."""
    n_z = max(int(z_samples), 1)
    if draw_z is None and generator is None:
        raise ValueError("evaluate_protocol needs a torch.Generator or draw_z for its noise")
    psnrs = [[] for _ in range(n_z)]
    ssims = [[] for _ in range(n_z)]
    id_sims, probe_emb, probe_lbl, gallery = [], [], [], {}
    for bi, batch in enumerate(batches):
        gt = torch.as_tensor(batch["img_frontal"])
        b = gt.shape[0]
        for zi in range(n_z):
            if draw_z is not None:
                z = torch.as_tensor(draw_z(bi, zi, b))
            else:
                z = torch.randn((b, zdim), generator=generator, device=generator.device)
            fake = synthesize(batch, z)
            gt = gt.to(fake.device)
            psnrs[zi].append(psnr(fake, gt, aggregate=False))
            ssims[zi].append(ssim(fake, gt, aggregate=False))
            if zi == 0 and embed is not None:
                with torch.no_grad():
                    pe = l2_normalize(_embed_nhwc(embed, fake).float())
                    ge = l2_normalize(_embed_nhwc(embed, gt).float())
                labels = torch.as_tensor(batch["label"]).cpu()
                probe_emb.append(pe)
                probe_lbl.append(labels)
                id_sims.append((pe * ge).sum(dim=-1))
                for i, lbl in enumerate(labels.tolist()):
                    gallery.setdefault(int(lbl), ge[i])

    # one transfer to the host per metric, after the last batch
    psnr_z = torch.stack([torch.cat(p) for p in psnrs]).cpu().numpy()  # (Z, N)
    ssim_z = torch.stack([torch.cat(s) for s in ssims]).cpu().numpy()
    psnr_items, ssim_items = psnr_z.mean(axis=0), ssim_z.mean(axis=0)
    out: Dict[str, object] = {
        "psnr": float(np.mean(psnr_items)), "ssim": float(np.mean(ssim_items)),
        "num_images": int(psnr_items.shape[0]), "landmarks": "ground_truth"}
    if n_z > 1:
        out["z_samples"] = n_z
        out["psnr_z_std"] = float(np.std(psnr_z.mean(axis=1)))
        out["ssim_z_std"] = float(np.std(ssim_z.mean(axis=1)))
    correct = None
    if id_sims:
        id_sims = torch.cat(id_sims).cpu().numpy()
        out["identity_sim"] = float(np.mean(id_sims))
    if embed is not None and gallery:
        g_lbl = sorted(gallery)
        # Rank-1 on the embeddings' device; only the hit mask comes back
        correct = rank1_correct(torch.cat(probe_emb), torch.cat(probe_lbl),
                                torch.stack([gallery[lbl] for lbl in g_lbl]),
                                torch.tensor(g_lbl)).cpu().numpy()
        out["rank1"] = float(np.mean(correct))

    cams = [camera_token(p) for p in img_list]
    if len(cams) != len(psnr_items):
        print(f"warning: per-camera breakdown skipped — {len(cams)} listed items but "
              f"{len(psnr_items)} evaluated (unreadable items were dropped by the iterator)",
              file=sys.stderr)
        return out
    per = {}
    for cam in sorted(set(cams)):
        sel = np.asarray([c == cam for c in cams])
        row = {"psnr": float(np.mean(psnr_items[sel])), "ssim": float(np.mean(ssim_items[sel])),
               "n": int(sel.sum())}
        if correct is not None:
            row["rank1"] = float(np.mean(correct[sel]))
        if len(id_sims) == len(psnr_items):
            row["identity_sim"] = float(np.mean(id_sims[sel]))
        per[cam] = row
    out["per_camera"] = per
    return out
