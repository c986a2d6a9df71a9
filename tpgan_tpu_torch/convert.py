"""Carry weights, and whole train states, from the JAX package to the
port: the generator, the critic, a whole GAN train state, the identity
embedder (:func:`jax_embedder_variables_to_state_dict`), the landmark
detector (:func:`jax_detector_variables_to_state_dict`) and the int8
calibration (:func:`jax_quant_scales_to_port`).

The inverse of ``tpgan_tpu/train/checkpoint.py``'s torch-to-Flax import
(``conv_weight``, ``deconv_weight``, ``_bn`` and the fc1 flatten
permutation of ``import_generator_pth``). It needs numpy only: the input
is the JAX parameter tree already on the host, e.g.
``jax.device_get(state.g_params)``. :func:`load_jax_gan_state` carries a
whole JAX ``GANTrainState`` (step, weights, BatchNorm statistics, EMA and
both optax Adam states) into a port state: the port's way to resume a
JAX run, with no Orbax.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Dict, Mapping, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from tpgan_tpu_torch.train.gan_trainer import GANTrainState

# the Generator's fc1 input is the 8x8 conv4 map at every fm_multiplier
_FC1_SPATIAL = 8


def _fc1_weight(kernel: np.ndarray) -> np.ndarray:
    """JAX fc1 kernel (H*W*C, out), rows in NHWC-flatten order -> torch
    (out, C*H*W), columns in the NCHW-flatten order the port uses."""
    s = _FC1_SPATIAL
    c = kernel.shape[0] // (s * s)
    w = kernel.T.reshape(kernel.shape[1], s, s, c)
    return w.transpose(0, 3, 1, 2).reshape(kernel.shape[1], c * s * s)


def _leaf(path: tuple, name: str, value: np.ndarray) -> Dict[str, np.ndarray]:
    parent = path[-1] if path else ""
    if name == "kernel":
        if value.ndim == 4 and parent == "deconv":
            return {"weight": value.transpose(2, 3, 0, 1)}  # (kh,kw,in,out) -> IOHW
        if value.ndim == 4:
            return {"weight": value.transpose(3, 2, 0, 1)}  # HWIO -> OIHW
        if value.ndim == 2:
            if path[-2:] == ("global_pathway", "fc1"):
                return {"weight": _fc1_weight(value)}
            return {"weight": value.T}  # (in, out) -> (out, in)
        raise ValueError(f"unexpected kernel rank {value.ndim} at {'.'.join(path)}")
    if name == "scale":  # BatchNorm
        return {"weight": value}
    if name == "bias":
        return {"bias": value}
    raise ValueError(f"unknown parameter {'.'.join(path + (name,))}")


def _walk(tree: Mapping[str, Any], path: tuple, out: Dict[str, np.ndarray]) -> None:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            _walk(value, path + (key,), out)
        else:
            for tname, arr in _leaf(path, key, np.asarray(value)).items():
                out[".".join(path + (tname,))] = arr


def _bn_paths(tree: Mapping[str, Any], path: tuple = ()):
    """Every BatchNorm node, whatever its name (``bn``, ``stem_bn``,
    ``expand_bn``, ...): the nodes that hold a ``scale``."""
    for key, value in tree.items():
        if isinstance(value, Mapping):
            if "scale" in value:
                yield path + (key,), value
            else:
                yield from _bn_paths(value, path + (key,))


def _lookup(tree: Mapping[str, Any], path: tuple) -> Mapping[str, Any]:
    for key in path:
        tree = tree[key]
    return tree


def jax_generator_params_to_state_dict(
    params_np: Mapping[str, Any], batch_stats_np: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """Map the JAX Generator's numpy parameter tree (and, for a BatchNorm
    generator, its ``batch_stats``) onto the port's ``state_dict``, to be
    loaded with ``strict=True``.

    * conv kernels HWIO -> OIHW; transposed-conv kernels (kh, kw, in, out)
      -> (in, out, kh, kw) with no flip; linear (in, out) -> (out, in);
    * ``global_pathway.fc1``: columns permuted from the NHWC flatten to
      the NCHW flatten;
    * every BatchNorm (any node holding a ``scale``, so the critic's and
      the embedders' trees too): ``scale``/``bias`` -> ``weight``/``bias``, running stats
      ``mean``/``var`` -> ``running_mean``/``running_var`` (the JAX init
      values, zeros and ones, when no ``batch_stats`` are given);
    * ``deconv`` and ``resize_conv`` trees alike (their ``deconv``/``conv``
      names carry over).
    """
    flat: Dict[str, np.ndarray] = {}
    _walk(params_np, (), flat)
    for path, bn in _bn_paths(params_np):
        n = np.asarray(bn["scale"]).shape[0]
        stats = _lookup(batch_stats_np, path) if batch_stats_np else None
        prefix = ".".join(path)
        flat[f"{prefix}.running_mean"] = (
            np.asarray(stats["mean"]) if stats else np.zeros(n, np.float32)
        )
        flat[f"{prefix}.running_var"] = (
            np.asarray(stats["var"]) if stats else np.ones(n, np.float32)
        )
    sd = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in flat.items()}
    for path, _bn in _bn_paths(params_np):
        sd[".".join(path) + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
    return sd


def jax_quant_scales_to_port(quant_collection: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map JAX's ``quant`` collection (``ops.quant.calibrate_synthesis``'s
    result: ``{"local_left_eye": {"conv0": {"conv": {"x_absmax": a}}}, ...}``,
    on the host) onto the port's calibration: {module name: 0-d float32
    tensor}, ``"local_left_eye.conv0.conv"``, the walk of
    :func:`jax_generator_params_to_state_dict` (a conv's ``quant`` variable
    sits on the module that holds its ``kernel``). Load it with
    ``ops.quant.load_quant_scales`` or pass it to
    ``gan_trainer.make_int8_synthesize_fn``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], path: tuple) -> None:
        for key, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + (key,))
            elif key == "x_absmax":
                out[".".join(path)] = torch.tensor(np.float32(np.asarray(value)))
            else:
                raise ValueError(f"unknown quant variable {'.'.join(path + (key,))}")

    walk(quant_collection, ())
    return out


def jax_critic_params_to_state_dict(
    params_np: Mapping[str, Any], batch_stats_np: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """The same walk for the JAX Discriminator's tree (``conv0``..``conv4``,
    ``res3``, ``res4``, ``head``): it has no ``fc1`` and no ``deconv``, so
    only the conv and BatchNorm rules apply. Load with ``strict=True``."""
    return jax_generator_params_to_state_dict(params_np, batch_stats_np)


def jax_embedder_variables_to_state_dict(
    variables: Mapping[str, Any], base_model_name: str
) -> Dict[str, torch.Tensor]:
    """Map a JAX ``FeatureExtractModel``'s numpy variables (``{"params",
    "batch_stats"}``, e.g. ``jax.device_get`` of ``fx.init``'s output or
    of a restored embedder checkpoint) onto the port model's
    ``state_dict``, to be loaded with ``strict=True``, for either backbone
    (``base_model_name`` ``resnet`` or ``mobilenetv2``):

    * conv kernels HWIO -> OIHW; a depthwise kernel (kh, kw, 1, C) becomes
      (C, 1, kh, kw) by the same transpose;
    * Dense kernels (in, out) -> (out, in);
    * every BatchNorm (``bn``, ``stem_bn``, ``expand_bn``, ...):
      ``scale`` / ``bias`` -> ``weight`` / ``bias``, ``mean`` / ``var`` ->
      ``running_mean`` / ``running_var``.
    """
    stem = {"resnet": "conv1", "mobilenetv2": "stem"}.get(base_model_name.lower())
    if stem is None:
        raise ValueError(f"unknown embedder backbone {base_model_name!r}: expected 'resnet' "
                         "or 'mobilenetv2'")
    params = variables["params"]
    if set(params) != {"base"} or stem not in params["base"]:
        raise ValueError(f"not a {base_model_name} FeatureExtractModel tree (no base.{stem})")
    return jax_generator_params_to_state_dict(params, variables.get("batch_stats"))


def jax_detector_variables_to_state_dict(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Map a JAX ``MobileNetV2`` detector's numpy variables (``{"params",
    "batch_stats"}``, e.g. ``jax.device_get`` of ``model.init``'s output or
    of a pretrain state's ``params`` / ``batch_stats``) onto the port
    detector's ``state_dict``, to be loaded with ``strict=True``. The same
    walk as the embedder's: conv kernels HWIO -> OIHW (a depthwise kernel
    (3, 3, 1, C) -> (C, 1, 3, 3)), biases as they are, every BatchNorm's
    ``scale`` / ``bias`` / ``mean`` / ``var`` to ``weight`` / ``bias`` /
    ``running_mean`` / ``running_var``. Both head modes have the same
    tree."""
    params = variables["params"]
    if "stem" not in params or "ssd_head" not in params:
        raise ValueError("not a MobileNetV2 detector tree (no stem and ssd_head)")
    return jax_generator_params_to_state_dict(params, variables.get("batch_stats"))


def _unflatten(arrays: Mapping[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}}."""
    tree: Dict[str, Any] = {}
    for key, value in arrays.items():
        node = tree
        *path, leaf = key.split("/")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.asarray(value)
    return tree


def _load_adam(opt: torch.optim.Optimizer, model: torch.nn.Module, adam: Mapping[str, Any],
               critic: bool) -> None:
    """optax ``ScaleByAdamState`` (``mu``, ``nu``, ``count``) -> torch
    Adam's ``exp_avg``, ``exp_avg_sq`` and ``step`` for ``model``'s
    parameters, through the weights' layout maps (elementwise moments
    move as their weights do)."""
    convert = jax_critic_params_to_state_dict if critic else jax_generator_params_to_state_dict
    mu, nu = convert(adam["mu"]), convert(adam["nu"])
    count = float(np.asarray(adam["count"]))
    names = [n for n, _ in model.named_parameters()]
    saved = opt.state_dict()
    saved["state"] = {
        i: {"step": torch.tensor(count), "exp_avg": mu[n], "exp_avg_sq": nu[n]}
        for i, n in enumerate(names)
    }
    opt.load_state_dict(saved)


def load_jax_gan_state(arrays: Mapping[str, Any], state: "GANTrainState") -> "GANTrainState":
    """Load a JAX ``GANTrainState`` exported to numpy into ``state`` (a
    port state from ``create_gan_state`` with the same config), in place,
    and return it.

    ``arrays`` (an ``np.load`` of an npz, or a dict) holds the state's
    leaves under ``/``-joined paths: ``step``; ``g_params/...``,
    ``d_params/...``, ``g_batch_stats/...``, ``d_batch_stats/...`` and
    ``g_ema_params/...`` (the Flax trees); ``g_opt_state/mu/...``,
    ``g_opt_state/nu/...``, ``g_opt_state/count`` and the same under
    ``d_opt_state`` (the ``ScaleByAdamState`` of ``optax.adam``). Adam's
    moments become ``exp_avg`` / ``exp_avg_sq`` under the weights' layout
    maps and ``count`` becomes ``step``. As ``restore_gan_checkpoint``
    does, a state that tracks EMA where the JAX one does not starts its
    EMA from the loaded weights, and JAX EMA weights the state does not
    track are dropped. A state sharded over a mesh's model axis takes
    each rank's slices of the whole tensors (``parallel.whole``; every rank
    of the model group calls); the usual order is to load the whole state,
    then place it (``parallel.place(state, parallel.shard_gan_state(mesh,
    state))``)."""
    from tpgan_tpu_torch.parallel.sharding import whole

    with whole(state):
        return _load_jax_gan_state(arrays, state)


def _load_jax_gan_state(arrays: Mapping[str, Any], state: "GANTrainState") -> "GANTrainState":
    tree = _unflatten(arrays)
    gen_sd = jax_generator_params_to_state_dict(tree["g_params"], tree.get("g_batch_stats"))
    disc_sd = jax_critic_params_to_state_dict(tree["d_params"], tree.get("d_batch_stats"))
    state.gen.load_state_dict(gen_sd, strict=True)
    state.disc.load_state_dict(disc_sd, strict=True)
    _load_adam(state.g_opt, state.gen, tree["g_opt_state"], critic=False)
    _load_adam(state.d_opt, state.disc, tree["d_opt_state"], critic=True)
    if state.g_ema_params:
        ema = (jax_generator_params_to_state_dict(tree["g_ema_params"])
               if tree.get("g_ema_params") else dict(state.gen.named_parameters()))
        with torch.no_grad():
            for name, t in state.g_ema_params.items():
                t.copy_(ema[name])
    state.step = int(np.asarray(tree["step"]))
    return state
