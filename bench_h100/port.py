"""The benchmark's calls into the program (``tpgan_tpu_torch``): its
configuration built from a configuration file, and seeded weights put
into its models. Drivers take the system under test from here; the
reference never imports this module."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from bench_h100 import weights
from bench_h100.reference import detector as det_ref
from bench_h100.reference import tpgan as gan_ref


def tpgan_config(conf: Dict[str, Any], batch: int):
    """The port's ``Config`` for a ``tpgan`` configuration file."""
    from tpgan_tpu_torch.config import make_config

    t = conf["train"]
    fx = conf["feature_extract_model"]
    return make_config({
        "G": {k: conf["G"][k] for k in ("zdim", "num_classes", "fm_multiplier",
                                          "local_feature_layer_dim", "use_batchnorm",
                                          "use_residual_block", "upsample_mode")},
        "D": dict(conf["D"]),
        "loss": dict(conf["loss"]),
        "feature_extract_model": {"base_model_name": fx["base_model_name"],
                                  "num_of_output_classes": fx["num_of_output_classes"]},
        "train": {"learning_rate": t["learning_rate"], "beta1": t["beta1"], "beta2": t["beta2"],
                  "ema_decay": t["ema_decay"], "batch_size": batch},
        "compute_dtype": conf["precision"]["compute_dtype"],
        "param_dtype": conf["precision"]["param_dtype"],
    })


def compute_dtype(conf: Dict[str, Any]) -> torch.dtype:
    return getattr(torch, conf["precision"]["compute_dtype"])


def detector_config(conf: Dict[str, Any], batch: int):
    """The port's ``Config`` for an ``mnv2-ssd`` configuration file."""
    from tpgan_tpu_torch.config import make_config

    o = conf["optimizer"]
    return make_config({
        "pretrain": {"batch_size": batch, "image_size": conf["image_size"],
                     "head_mode": conf["head_mode"], "optimizer": o["name"],
                     "use_learning_rate_scheduler": True,
                     "learning_rate_scheduler_milestone": tuple(o["milestones_epochs"]),
                     "learning_rate_scheduler_gamma": o["gamma"], "loss": dict(conf["loss"])},
        "optimizer_param": {"learning_rate": o["learning_rate"], "momentum": o["momentum"],
                            "nesterov": o["nesterov"], "weight_decay": o["weight_decay"]},
    })


def seeded(kind: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weights of the reference's ``kind`` (generator, critic, embedder,
    detector) drawn on ``device`` from ``seed``."""
    net = det_ref.spec() if kind == "detector" else gan_ref.spec(kind)
    return weights.make(net.spec, seed, device)


def to_host(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in w.items()}


def to_device(w: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in w.items()}


def gan_models(cfg, seeds: Tuple[int, int, int], device):
    """(state, gen, disc, g_opt, d_opt, embedder, host weights): the port's
    GAN state with the seeded generator and critic loaded (the EMA copy
    restarted from them) and its frozen identity embedder; the weights
    the benchmark drew, kept on the host for the reference."""
    from tpgan_tpu_torch.models.feature_extract import build_feature_extract_model
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state

    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, device)
    host = {}
    for kind, module, seed in (("generator", gen, seeds[0]), ("critic", disc, seeds[1])):
        w = seeded(kind, seed, device)
        weights.load(module, w)
        host[kind] = to_host(w)
        del w
    with torch.no_grad():
        for name, p in gen.named_parameters():
            if name in state.g_ema_params:
                state.g_ema_params[name].copy_(p)
    emb = build_feature_extract_model(cfg, device)
    w = seeded("embedder", seeds[2], device)
    weights.load(emb, w)
    host["embedder"] = to_host(w)
    del w
    return state, gen, disc, g_opt, d_opt, emb, host
