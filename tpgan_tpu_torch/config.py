"""Typed configuration tree — the PyTorch port's own copy of
``tpgan_tpu/config.py``, kept key-for-key identical so both packages read
the same ``--set a.b=value`` overrides. The port imports nothing of
``tpgan_tpu``, so it carries this copy instead of importing that one.

Mirrors every key/default of the reference's plain-dict config module
(reference: config.py:3-85) as frozen dataclasses, adds the TPU-specific
knobs the reference lacks (mesh shape, dtype policy, fixed image buckets),
and replaces the reference's ``eval(pretrain['model_name'])`` model lookup
(reference: Pretrain.py:113) with an explicit registry key.

Configs are plain dataclasses so they can be overridden from files or CLI
flags without a framework dependency.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple


@dataclass(frozen=True)
class PretrainLossConfig:
    """Landmark multi-task loss weights (reference: config.py:24-27)."""

    alpha: float = 30.0  # location-loss weight
    beta: float = 0.1  # classification-loss weight
    ratio_non_background: float = 5.0  # background subsample multiple
    # positive-set size: per GT point, positives = predictions within the
    # (ratio * N)-th smallest distance (reference MobileNetV2.py:399-401;
    # 0.1 = reference parity). With head_mode=anchor_offset the decode
    # commits to the argmax-SCORE anchor, so training ~10% of all anchors
    # as positives lets a far cell (noisy long-range offset) win the
    # argmax — measured round 4 as 32 px decode error on a loss that was
    # converging. 0.01 restricts positives to the cells around the GT,
    # aligning what classification rewards with what regression does
    # best (the anchor-recipe value; absolute-head recipes keep 0.1).
    distance_threshold_ratio: float = 0.1


@dataclass(frozen=True)
class PretrainConfig:
    """Landmark-detector pretraining (reference: config.py:3-27).

    TPU redesign: the reference trains batch_size=1 on variable-size
    images (config.py:12); we resize/pad into a fixed ``image_size``
    bucket so shapes are static under jit and batches are real.
    """

    txt_name: str = "list_landmarks_celeba.txt"
    data_root_dir: str = "./data/CelebA"
    log_root_dir: str = "./logs"
    model_name: str = "mobilenet_v2"  # registry key, not eval()'d
    train_data_ratio: float = 0.95
    validation_data_ratio: float = 0.0005
    batch_size: int = 64
    optimizer: str = "sgd"
    use_learning_rate_scheduler: bool = True
    learning_rate_scheduler_milestone: Tuple[int, ...] = (10, 20, 30)
    learning_rate_scheduler_gamma: float = 0.1
    num_epochs: int = 5
    log_step_of_batchs: int = 200
    image_size: int = 256  # fixed bucket (TPU static shapes)
    # multi-bucket mode: ascending sizes, each image letterboxed into the
    # smallest bucket that fits it WITHOUT downscaling — keeps the banded
    # accuracy in the reference's source-pixel frame (Pretrain.py:31-32)
    # up to the largest bucket (cap intent: general.image_max_size,
    # config.py:40). None = single image_size bucket.
    image_buckets: Optional[Tuple[int, ...]] = None
    # SSD-head location parameterization: "absolute" = reference parity
    # (the loc conv emits absolute ReLU-clamped pixel coordinates,
    # reference MobileNetV2.py:67 — measurably capped at ~12 px median
    # error because convs are translation-equivariant and absolute
    # position is outside their function class); "anchor_offset" = the
    # TPU-first redesign (coord = cell centre + conv output * stride,
    # models/mobilenet_v2.SSDHead). Checkpoints record their mode in a
    # detector_meta.json sidecar and loaders auto-apply it.
    head_mode: str = "absolute"
    loss: PretrainLossConfig = field(default_factory=PretrainLossConfig)


@dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer hyperparameters (reference: config.py:31-35)."""

    learning_rate: float = 5e-4
    momentum: float = 0.9
    nesterov: bool = True
    weight_decay: float = 5e-4


@dataclass(frozen=True)
class GeneralConfig:
    """General knobs (reference: config.py:39-40)."""

    image_max_size: int = 1024


@dataclass(frozen=True)
class TrainConfig:
    """GAN training (reference: config.py:50-57)."""

    img_list: str = "./img.list"
    learning_rate: float = 1e-4
    num_epochs: int = 50
    batch_size: int = 50
    log_step: int = 1000
    resume_model: Optional[str] = None
    resume_optimizer: Optional[str] = None
    # TPU additions
    checkpoint_dir: str = "./checkpoints"
    checkpoint_every_steps: int = 1000
    beta1: float = 0.5  # Adam betas, standard WGAN-GP practice
    beta2: float = 0.9
    seed: int = 0
    remat: bool = False  # rematerialise activations in backward passes
    # (jax.checkpoint): trades recompute FLOPs for HBM, enabling larger
    # per-chip batches
    remat_scope: str = "generator"  # which subgraph jax.checkpoint wraps
    # when train.remat is on:
    #   "generator" — the G forward (both phases); round 1-4 behaviour.
    #   "critic"    — the critic only (all D applies incl. the GP
    #                 double-backward and the G-phase adversarial term).
    #                 The roofline decomposition showed G-forward remat
    #                 recompute costs 182 GFLOP/img of the 876 total
    #                 while the HBM wall is the critic/GP intermediates
    #                 (docs/BENCHMARKS.md round-4 MFU table) — scoping
    #                 remat to the critic keeps the memory relief where
    #                 it matters and stops paying the G recompute.
    #   "both"      — maximum memory relief.
    yaw_weight_gamma: float = 0.0  # when > 0, bias training-batch
    # sampling toward extreme-yaw items: item weight = 1 + gamma *
    # (|yaw|/90)^2, yaw read from the Multi-PIE camera token in the
    # filename (data/synthetic_faces.CAMERA_YAWS naming). gamma=3 makes
    # a ±90° item ~4x as likely as a frontal one. Rationale: the round-4
    # hard protocol localised the identity-quality floor to the ±90°
    # bins (cameras 020/240 at ~0.69 identity_sim vs ≥0.93 in-dist,
    # artifacts/eval_protocol300_hard_r4.json) — those bins need both
    # corpus coverage (train on the full 13-camera ring) and enough
    # sampling mass to matter in the loss. Host-side sampling only;
    # the jitted step is unchanged.
    ema_decay: float = 0.99  # when > 0, keep an exponential moving
    # average of the generator weights updated inside the jitted step
    # (pure pytree lerp, fuses with the optimizer update); inference and
    # eval prefer the EMA weights — the standard GAN quality lever.
    # Default 0.99 set by the round-4 A/B (artifacts/eval_ema_ab_*_r4
    # .json): EMA weights beat the no-EMA arm +0.12 dB PSNR and +0.060
    # identity_sim at equal steps, while the SAME checkpoint's live
    # weights score like the no-EMA arm — tracking is free, the win is
    # entirely in the averaged weights. Set 0.0 to disable.
    grad_accum_steps: int = 1  # split each batch into this many
    # sequential microbatches inside the jitted step (lax.scan) and
    # average the grads before each optimizer update — the critic/GP
    # intermediates (the HBM wall past b=128, docs/BENCHMARKS.md) then
    # scale with the microbatch, not the batch


@dataclass(frozen=True)
class GeneratorConfig:
    """Generator hyperparameters (reference: config.py:60-64)."""

    zdim: int = 64
    use_residual_block: bool = False
    use_batchnorm: bool = False
    num_classes: int = 347
    # TPU additions (the reference ctors expose FM_multiplier too,
    # D_and_G_model.py:19,162,410)
    fm_multiplier: float = 1.0
    local_feature_layer_dim: int = 64
    # zero-pad off-tile conv input channels (75/203/206/208 concats) to
    # this multiple for MXU lane alignment; semantics-preserving
    # (ops.blocks.Conv2d.pad_in_multiple). None = reference-parity layout.
    pad_channel_multiple: Optional[int] = None
    # "deconv" = reference-parity transpose convs (input-dilated form);
    # "subpixel" = the SAME transpose convs (identical params/checkpoints)
    # computed via the exact phase decomposition — no dilation-zero MACs;
    # "resize_conv" = opt-in nearest-upsample + 3x3 conv with different
    # params (checkerboard-artifact fix, the quality winner). See
    # ops.blocks.DeconvBlock.mode.
    upsample_mode: str = "deconv"


@dataclass(frozen=True)
class DiscriminatorConfig:
    """Discriminator hyperparameters (reference: config.py:67-68)."""

    use_batchnorm: bool = False
    fm_multiplier: float = 1.0


@dataclass(frozen=True)
class LossConfig:
    """The 11 composite GAN loss weights (reference: config.py:71-82)."""

    weight_gradient_penalty: float = 10.0
    weight_128: float = 1.0
    weight_64: float = 1.0
    weight_32: float = 1.5
    weight_pixelwise: float = 1.0
    weight_pixelwise_local: float = 3.0
    weight_symmetry: float = 3e-1
    weight_adv_G: float = 1e-3
    weight_identity_preserving: float = 3e1
    weight_total_varation: float = 1e-3  # sic — key name kept for parity
    weight_cross_entropy: float = 1e1


@dataclass(frozen=True)
class FeatureExtractConfig:
    """Identity-embedder resume path (reference: config.py:84-85)."""

    resume: str = "save/feature_extract_model/resnet18/try_1"
    base_model_name: str = "resnet"
    num_of_output_classes: int = 347


@dataclass(frozen=True)
class MeshConfig:
    """TPU device-mesh layout (no reference equivalent — the reference is
    single-device, Pretrain.py:111-114). ``data`` is the batch (DP) axis,
    ``model`` optionally shards wide channel dimensions (TP)."""

    data: int = -1  # -1: use all remaining devices
    model: int = 1
    data_axis: str = "data"
    model_axis: str = "model"


@dataclass(frozen=True)
class Config:
    """Root config bundling all reference config groups."""

    pretrain: PretrainConfig = field(default_factory=PretrainConfig)
    optimizer_param: OptimizerConfig = field(default_factory=OptimizerConfig)
    general: GeneralConfig = field(default_factory=GeneralConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    G: GeneratorConfig = field(default_factory=GeneratorConfig)
    D: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    feature_extract_model: FeatureExtractConfig = field(
        default_factory=FeatureExtractConfig
    )
    mesh: MeshConfig = field(default_factory=MeshConfig)
    compute_dtype: str = "bfloat16"  # MXU-native compute precision
    param_dtype: str = "float32"


def _replace_nested(cfg: Any, overrides: Mapping[str, Any]) -> Any:
    updates = {}
    for key, value in overrides.items():
        if not hasattr(cfg, key):
            raise KeyError(f"unknown config key: {key!r} on {type(cfg).__name__}")
        current = getattr(cfg, key)
        if dataclasses.is_dataclass(current) and isinstance(value, Mapping):
            updates[key] = _replace_nested(current, value)
        else:
            updates[key] = value
    return dataclasses.replace(cfg, **updates)


def make_config(overrides: Optional[Mapping[str, Any]] = None) -> Config:
    """Build a Config, optionally applying a nested-dict override tree.

    Example::

        cfg = make_config({"G": {"zdim": 128}, "train": {"batch_size": 8}})
    """
    cfg = Config()
    if overrides:
        cfg = _replace_nested(cfg, overrides)
    return cfg


def flat_override(cfg: Config, assignments: Sequence[str]) -> Config:
    """Apply CLI-style ``a.b=value`` assignments (values parsed as Python
    literals when possible, else kept as strings)."""
    import ast

    tree: dict = {}
    for item in assignments:
        path, _, raw = item.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = tree
        parts = path.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return _replace_nested(cfg, tree)
