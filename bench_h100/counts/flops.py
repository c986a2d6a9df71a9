"""Model FLOPs, counted from the layer shapes of the plain reference: two
FLOPs per multiply-add that the algorithm needs, whatever implements it.
A conv counts the (output, tap) pairs whose input lies inside the image
(zero padding needs no product); a transposed conv the (input, tap)
pairs whose output lies inside it, so its input-dilated and its phase
(subpixel) forms count alike; recomputation is not counted.

For a network N: F(N) is its forward, W(N) the weight gradients of all
its layers (F again), X(N) the input gradients of the layers whose input
needs one (F less the layers fed straight from data). The terms of each
step are listed in the functions below; elementwise work, norms and
losses are not counted, the optimizer update is.
"""

from __future__ import annotations

import math
from typing import Dict

from bench_h100.reference import detector as det_ref
from bench_h100.reference import tpgan as gan_ref


def _fxw(net) -> Dict[str, float]:
    f = 2.0 * sum(c.products for c in net.calls)
    x = 2.0 * sum(c.products for c in net.calls if c.input_grad)
    return {"F": f, "W": f, "X": x}


def _params(net) -> int:
    return sum(math.prod(leaf.shape) for leaf in net.spec.values()
               if leaf.std is not None)


def tpgan_networks() -> Dict[str, Dict[str, float]]:
    """F, W, X and parameter counts per image of the generator, the critic
    and the identity embedder (batch-1 shapes)."""
    out = {}
    for kind in ("generator", "critic", "embedder"):
        net = gan_ref.spec(kind)
        out[kind] = {**_fxw(net), "params": float(_params(net))}
    return out


ADAM_FLOPS_PER_PARAM = 10.0  # two moments, bias corrections, the update
EMA_FLOPS_PER_PARAM = 3.0
SGD_FLOPS_PER_PARAM = 5.0  # decay, momentum, Nesterov, the update


def gan_train_terms(batch: int, identity: bool = True, ema: bool = True) -> Dict[str, float]:
    """FLOPs per image of one WGAN-GP D+G step, by term:

    * ``d.g_forward``: the generator forward of the D phase (no gradient);
    * ``d.critic_real`` / ``d.critic_fake``: the critic on the real and the
      generated images, forward and weight gradients;
    * ``d.gp``: the gradient penalty on the interpolates: the forward, the
      input gradients of every layer (created as a graph), and the second
      backward through them, a product for the gradient of each input
      gradient and one for its weight (4 F);
    * ``g.generator``: the generator forward, weight and input gradients;
    * ``g.critic``: the critic forward and input gradients down to the
      image (no weight gradients);
    * ``g.identity``: the embedder on the generated image (forward and
      input gradients) and on the frontal image (forward);
    * ``update``: Adam on both models, the generator's EMA.
    """
    n = tpgan_networks()
    g, d, e = n["generator"], n["critic"], n["embedder"]
    terms = {
        "d.g_forward": g["F"],
        "d.critic_real": d["F"] + d["W"],
        "d.critic_fake": d["F"] + d["W"],
        "d.gp": 4.0 * d["F"],
        "g.generator": g["F"] + g["W"] + g["X"],
        "g.critic": 2.0 * d["F"],
        "g.identity": 3.0 * e["F"] if identity else 0.0,
        "update": (ADAM_FLOPS_PER_PARAM * (g["params"] + d["params"])
                   + (EMA_FLOPS_PER_PARAM * g["params"] if ema else 0.0)) / batch,
    }
    return terms


def synthesis_per_image() -> float:
    return tpgan_networks()["generator"]["F"]


def pretrain_terms(batch: int, image_size: int = 256) -> Dict[str, float]:
    """FLOPs per image of one detector step: ``forward``, ``backward``
    (weight gradients of every layer, input gradients of all but the
    stem), ``update`` (SGD)."""
    net = det_ref.spec(image_size)
    c = _fxw(net)
    return {"forward": c["F"], "backward": c["W"] + c["X"],
            "update": SGD_FLOPS_PER_PARAM * _params(net) / batch}
