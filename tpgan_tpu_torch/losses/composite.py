"""The composite generator objective — the port of
``tpgan_tpu/losses/composite.py``: every weighted term of
config.py:71-82,

    weight_adv_G      * (-E[D(fake)])
  + weight_pixelwise  * multiscale L1 (128/64/32, scale weights)
  + weight_pixelwise_local * L1(fused fake patches, fused frontal patches)
  + weight_symmetry   * L1(fake, mirror(fake))
  + weight_total_varation * TV(fake)
  + weight_identity_preserving * L1(embed(fake), embed(frontal))
  + weight_cross_entropy * CE(encoder_predict, subject label)

Symmetry and TV come from one fused pass, the CUDA kernel
``ops.kernels.symmetry_tv_losses`` on the card. The key names are the
JAX ones, the sic ``weight_total_varation`` included.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
import torch.nn.functional as F

from tpgan_tpu_torch.config import LossConfig
from tpgan_tpu_torch.losses.gan import generator_adversarial_loss
from tpgan_tpu_torch.losses.pixel import l1, local_pixel_loss, multiscale_pixel_loss
from tpgan_tpu_torch.ops.kernels import symmetry_tv_losses


def generator_loss_components(
    *,
    fake128: torch.Tensor,
    fake_scores: torch.Tensor,
    encoder_predict: torch.Tensor,
    fused_local_fake: torch.Tensor,
    fused_local_frontal: torch.Tensor,
    gt128: torch.Tensor,
    gt64: torch.Tensor,
    gt32: torch.Tensor,
    labels: torch.Tensor,
    cfg: LossConfig,
    identity_embed: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """Every G-loss component, unweighted (the weights are applied in
    :func:`total_generator_loss`, so metrics can log both). NCHW images."""
    sym, tv = symmetry_tv_losses(fake128)
    comps = {
        "adv_G": generator_adversarial_loss(fake_scores),
        "pixelwise": multiscale_pixel_loss(
            fake128, gt128, gt64, gt32, cfg.weight_128, cfg.weight_64, cfg.weight_32,
        ),
        "pixelwise_local": local_pixel_loss(fused_local_fake, fused_local_frontal),
        "symmetry": sym,
        "total_variation": tv,
        "cross_entropy": F.cross_entropy(encoder_predict.float(), labels.long()),
    }
    if identity_embed is not None:
        comps["identity_preserving"] = l1(identity_embed(fake128), identity_embed(gt128))
    else:
        comps["identity_preserving"] = torch.zeros((), dtype=torch.float32, device=fake128.device)
    return comps


def total_generator_loss(comps: Mapping[str, torch.Tensor], cfg: LossConfig) -> torch.Tensor:
    return (
        cfg.weight_adv_G * comps["adv_G"]
        + cfg.weight_pixelwise * comps["pixelwise"]
        + cfg.weight_pixelwise_local * comps["pixelwise_local"]
        + cfg.weight_symmetry * comps["symmetry"]
        + cfg.weight_total_varation * comps["total_variation"]
        + cfg.weight_identity_preserving * comps["identity_preserving"]
        + cfg.weight_cross_entropy * comps["cross_entropy"]
    )
