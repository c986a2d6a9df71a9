"""Shared pieces of the detector tests (``tests/test_torch_detector.py``,
``test_torch_multitask.py``, ``test_torch_pretrain.py``): the JAX
``MobileNetV2`` with numpy-drawn variables, carried to the port's
detector by ``convert.jax_detector_variables_to_state_dict``, the JAX
loss's background uniforms, and JAX's positive assignment."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp
from jax import lax

from tpgan_tpu.models.mobilenet_v2 import MobileNetV2 as JMobileNetV2
from tpgan_tpu_torch.convert import jax_detector_variables_to_state_dict
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2

from _torch_port import init_numpy

# 128x128: the last backbone BatchNorms normalise 4x4 maps; at 64 or 32
# JAX's variance as E[x^2] - E[x]^2 cancels over the few values there
SIZE = 128


def images(batch: int, seed: int, size: int = SIZE) -> np.ndarray:
    return np.random.RandomState(seed).uniform(0, 1, (batch, size, size, 3)).astype(np.float32)


def labels(batch: int, seed: int, size: int = SIZE) -> np.ndarray:
    """Landmarks inside the central part of the image, as faces put them."""
    rng = np.random.RandomState(seed)
    return rng.uniform(0.25 * size, 0.75 * size, (batch, 8)).astype(np.float32)


def detector_pair(head_mode: str, seed: int = 0, size: int = SIZE):
    """(JAX model, its numpy variables, the port model loaded strict)."""
    jmod = JMobileNetV2(head_mode=head_mode, accum_f32=False)
    params, stats = init_numpy(jmod, jnp.zeros((1, size, size, 3)), seed=seed)
    variables = {"params": params, "batch_stats": stats}
    model = MobileNetV2(head_mode=head_mode, device="cpu")
    model.load_state_dict(jax_detector_variables_to_state_dict(variables), strict=True)
    return jmod, variables, model


def jax_uniforms(rng, batch: int, n: int) -> np.ndarray:
    """The (B, N) uniforms ``multitask_landmark_loss`` draws per item
    (``split(rng, B)``, then ``uniform(key, (N,))``)."""
    keys = jax.random.split(rng, batch)
    return np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(keys))


def jax_assignment(loc, lbl, u, ratio: float = 0.1, ratio_bg: float = 5.0,
                   assign_points=None):
    """JAX's positive assignment and background subsample, computed with
    the ops of ``tpgan_tpu/losses/multitask.py:59-113`` (which keeps
    them internal): (assigned (B, N), keep_bg (B, N))."""
    def one(lp, lt, uu):
        n = lp.shape[0]
        lt = lt.reshape(4, 2)
        ap = lp if assign_points is None else jnp.asarray(assign_points, jnp.float32)
        d = jnp.sqrt(jnp.sum(jnp.square(ap[:, None, :] - lt[None, :, :]), axis=-1) + 1e-20)
        k = max(int(ratio * n), 1)
        neg, _ = lax.top_k(-d.T, k)
        pos = d <= (-neg[:, -1])[None, :]
        assigned = jnp.where(jnp.any(pos, axis=1),
                             jnp.argmin(jnp.where(pos, d, jnp.inf), axis=1), -1)
        bg = assigned == -1
        max_bg = jnp.floor(ratio_bg * jnp.sum(~bg)).astype(jnp.int32)
        order = jnp.argsort(jnp.where(bg, uu, jnp.inf))
        rank = jnp.argsort(order)
        return assigned, bg & (rank < max_bg)

    a, k = jax.jit(jax.vmap(one))(jnp.asarray(loc, jnp.float32), jnp.asarray(lbl),
                                  jnp.asarray(u))
    return np.asarray(a), np.asarray(k)


def port_outputs(model: MobileNetV2, x_nhwc: np.ndarray, train: bool):
    model.train(train)
    with torch.no_grad():
        loc, cls = model(torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2))))
    return loc.numpy(), cls.numpy()


def bn_stats(model) -> dict:
    return {k: v.numpy().copy() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def jax_stats_as_port(params, batch_stats) -> dict:
    sd = jax_detector_variables_to_state_dict({"params": params, "batch_stats": batch_stats})
    return {k: v.numpy() for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


# ---- a torch module tree with the reference's naming (copied from
# tests/test_mobilenet_parity.py): the source of the .pth import tests ----

import torch.nn as tnn  # noqa: E402

from tpgan_tpu.models.mobilenet_v2 import INVERTED_RESIDUAL_SETTING, SSD_SCALES  # noqa: E402


def _torch_inverted_residual(inp, oup, stride, t):
    mid = inp * t
    return tnn.Sequential(
        tnn.Conv2d(inp, mid, 1, 1, 0, bias=False),
        tnn.BatchNorm2d(mid),
        tnn.ReLU6(inplace=True),
        tnn.Conv2d(mid, mid, 3, stride, 1, groups=mid, bias=False),
        tnn.BatchNorm2d(mid),
        tnn.ReLU6(inplace=True),
        tnn.Conv2d(mid, oup, 1, 1, 0, bias=False),
        tnn.BatchNorm2d(oup),
    )


class TorchRef(tnn.Module):
    """Minimal torch mirror producing the reference's state-dict naming
    and forward dataflow (taps at bottleneck 12, conv2, extras 1/3/4/6)."""

    def __init__(self):
        super().__init__()
        self.conv1 = tnn.Sequential(
            tnn.Conv2d(3, 32, 3, 2, 1, bias=False), tnn.BatchNorm2d(32), tnn.ReLU6(inplace=True))
        blocks = []
        cin = 32
        for t, c, n, s in INVERTED_RESIDUAL_SETTING:
            for rep in range(n):
                stride = s if rep == 0 else 1
                m = tnn.Module()
                m.conv = _torch_inverted_residual(cin, c, stride, t)
                m.use_res = stride == 1 and cin == c
                blocks.append(m)
                cin = c
        self.bottlenecks = tnn.ModuleList(blocks)
        self.conv2 = tnn.Sequential(
            tnn.Conv2d(320, 1280, 1, 1, 0, bias=False), tnn.BatchNorm2d(1280),
            tnn.ReLU6(inplace=True))
        self.extra_layers = tnn.ModuleList([
            tnn.Conv2d(1280, 512, 1), tnn.Conv2d(512, 512, 3, 2, 1), tnn.Conv2d(512, 256, 1),
            tnn.Conv2d(256, 256, 3, 2, 1), tnn.Conv2d(256, 256, 3, 2, 1),
            tnn.Conv2d(256, 128, 1), tnn.Conv2d(128, 128, 3, 2, 1),
        ])
        head = tnn.Module()
        head.location_layer = tnn.ModuleList(
            [tnn.Conv2d(cin, a * 2, 3, padding=1) for cin, a in SSD_SCALES])
        head.classification_layer = tnn.ModuleList(
            [tnn.Conv2d(cin, a * 5, 3, padding=1) for cin, a in SSD_SCALES])
        self.ssd_head = head

    def forward(self, x):
        feats = []
        x = self.conv1(x)
        for i, m in enumerate(self.bottlenecks):
            x = x + m.conv(x) if m.use_res else m.conv(x)
            if i == 12:
                feats.append(x)
        x = self.conv2(x)
        feats.append(x)
        for i, m in enumerate(self.extra_layers):
            x = m(x)
            if i in (1, 3, 4, 6):
                feats.append(x)
        locs, clss = [], []
        for i, f in enumerate(feats):
            l = self.ssd_head.location_layer[i](f)
            locs.append(torch.relu(l.permute(0, 2, 3, 1).reshape(f.shape[0], -1, 2)))
            c = self.ssd_head.classification_layer[i](f)
            clss.append(c.permute(0, 2, 3, 1).reshape(f.shape[0], -1, 5))
        return torch.cat(locs, 1), torch.cat(clss, 1)
