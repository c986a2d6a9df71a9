"""Carry weights from the JAX package's Generator and Discriminator to
the port's.

The inverse of ``tpgan_tpu/train/checkpoint.py``'s torch-to-Flax import
(``conv_weight``, ``deconv_weight``, ``_bn`` and the fc1 flatten
permutation of ``import_generator_pth``). It needs numpy only: the input
is the JAX parameter tree already on the host, e.g.
``jax.device_get(state.g_params)``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

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
    for key, value in tree.items():
        if isinstance(value, Mapping):
            if key == "bn":
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
    * BatchNorm ``scale``/``bias`` -> ``weight``/``bias``, running stats
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


def jax_critic_params_to_state_dict(
    params_np: Mapping[str, Any], batch_stats_np: Optional[Mapping[str, Any]] = None
) -> Dict[str, torch.Tensor]:
    """The same walk for the JAX Discriminator's tree (``conv0``..``conv4``,
    ``res3``, ``res4``, ``head``): it has no ``fc1`` and no ``deconv``, so
    only the conv and BatchNorm rules apply. Load with ``strict=True``."""
    return jax_generator_params_to_state_dict(params_np, batch_stats_np)
