"""Shared helpers of the tests that hold the PyTorch port
(``tpgan_tpu_torch``) against the JAX package: numpy-drawn weights over a
JAX module's parameter tree, layout conversions, and loading the converted
weights into a port module with ``strict=True``.

Weights are drawn with numpy over the tree that ``jax.eval_shape`` gives
for ``Module.init``, not by ``Module.init`` itself: on one CPU core the
jitted Generator init takes about 40 s even at fm_multiplier 0.25, while
its forward compiles in about 2 s. The tree is the one ``init`` returns,
so the converter and the ``strict=True`` load see the same keys and shapes.
"""

from __future__ import annotations

import numpy as np
import torch

import jax

from tpgan_tpu_torch.convert import jax_generator_params_to_state_dict

# torch vs JAX in float32 on the CPU: the existing parity bar
# (tests/test_generator_parity.py) — summation order differs between
# XLA's and torch's CPU convolutions.
F32_TOL = dict(rtol=2e-3, atol=2e-4)


def nchw(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


def nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))


def numpy_variables(shapes, seed: int = 0):
    """(params, batch_stats) numpy trees over ``jax.eval_shape`` output:
    normal kernels with variance 1/fan_in, small uniform biases, BatchNorm scales near
    one and non-trivial running statistics."""
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(shape)).astype(np.float32)
        return rng.uniform(-0.1, 0.1, shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    return tree["params"], tree.get("batch_stats") or None


def init_numpy(module, *args, seed: int = 0, **kwargs):
    """numpy (params, batch_stats) for a JAX ``module`` called on ``args``."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    return numpy_variables(shapes, seed)


def jax_variables(params, stats):
    v = {"params": params}
    if stats:
        v["batch_stats"] = stats
    return v


def load_port(module: torch.nn.Module, params, stats=None, prefix: str = ""):
    """Load converted JAX weights into ``module`` (strict) and set eval
    mode. ``prefix`` nests ``params`` under that key for the converter's
    name-based rules (``deconv`` marks a transposed-conv kernel)."""
    if prefix:
        sd = jax_generator_params_to_state_dict(
            {prefix: params}, {prefix: stats} if stats else None
        )
        sd = {k[len(prefix) + 1:]: v for k, v in sd.items()}
    else:
        sd = jax_generator_params_to_state_dict(params, stats)
    module.load_state_dict(sd, strict=True)
    return module.eval()
