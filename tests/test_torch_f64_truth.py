"""Which float32 side is nearer the truth (ROADMAP C3): the gradient of
the composite generator loss with respect to the generator's parameters,
at fm_multiplier 0.25 (local_feature_layer_dim 16), batch 2, no
BatchNorm, against the seeded critic, from the same numpy weights, batch,
z and dropout keep-mask on both sides.

The truth is the JAX package run in float64 (under ``jax.enable_x64``, a
context manager, so the flag does not leak into other tests on the
worker), checked against the port run in float64. Both packages compute
their loss heads in float32 (the L1 terms, TV and cross-entropy cast), so
the truth is float64 through the models and these casts are kept on every
side. Then JAX's jitted float32 gradient and the port's float32 gradient
are each held against it.

The file takes minutes, not seconds, almost all of it in JAX. On one x86
core JAX's jitted float64 gradient compiles in about 75 s and runs in
about 80 s (XLA's CPU backend has no library path for float64
convolutions); its float32 gradient compiles in about 30 s and runs in
3 s; the port's two gradients take about 11 s. Unjitted, the float64
gradient takes longer still (about 180 s), and passing the weights, batch
and masks as arguments rather than constants saves nothing.
"""

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.losses.composite import generator_loss_components as jax_components
from tpgan_tpu.losses.composite import total_generator_loss as jax_total
from tpgan_tpu.models.local_fuser import fuse_parts as jax_fuse_parts
from tpgan_tpu.train.gan_trainer import build_models as jax_build_models
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import (
    jax_critic_params_to_state_dict,
    jax_generator_params_to_state_dict,
)
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.losses.composite import generator_loss_components, total_generator_loss
from tpgan_tpu_torch.ops.blocks import set_compute_dtype
from tpgan_tpu_torch.ops.kernels import fuse_parts
from tpgan_tpu_torch.train.gan_trainer import FRONTAL_PATCH_KEYS, PATCH_KEYS, build_models

from _torch_port import init_numpy
from _torch_train_parity import overrides

torch.set_num_threads(1)

BATCH = 2
# The two float32 sides are about equally far from the truth (relative L2
# over all generator leaves 3.03591e-4 for the port, 3.03600e-4 for JAX,
# on an x86 CPU); the port is held to no more than 5% beyond JAX's
# distance, room for another BLAS's summation order.
MARGIN = 1.05
# The two float64 runs agree to 2.7e-8 (relative L2): the truth is common.
TRUTHS_AGREE = 1e-6


@pytest.fixture(scope="module")
def setup():
    ov = overrides(use_batchnorm=False)
    jcfg, cfg = jax_make_config(ov), make_config(ov)
    jgen, jdisc = jax_build_models(jcfg)
    batch = synthetic_gan_batch(BATCH, seed=10)
    imgs = [batch[k] for k in PATCH_KEYS]
    rng = np.random.RandomState(3)
    z = rng.standard_normal((BATCH, cfg.G.zdim)).astype(np.float32)
    mask = rng.uniform(size=(BATCH, 256)) < 0.7  # the keep-mask of Dropout(0.3)
    g_params, _ = init_numpy(jgen, *imgs, z, seed=1)
    d_params, _ = init_numpy(jdisc, imgs[0], seed=2)
    return dict(jcfg=jcfg, cfg=cfg, batch=batch, z=z, mask=mask, g_params=g_params,
                d_params=d_params)


def jax_grads(s, dtype):
    """JAX's jitted gradient in ``dtype``, under the port's names and
    layouts (float64 numpy)."""
    jgen, jdisc = jax_build_models(s["jcfg"], dtype=dtype)
    cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)
    g_params, d_params = cast(s["g_params"]), cast(s["d_params"])
    batch = {k: jnp.asarray(v, dtype) if v.dtype.kind == "f" else jnp.asarray(v)
             for k, v in s["batch"].items()}
    z, mask = jnp.asarray(s["z"], dtype), jnp.asarray(s["mask"])

    def dropout(next_fun, args, kwargs, context):  # nn.Dropout's select, with the given mask
        if isinstance(context.module, fnn.Dropout):
            x = args[0]
            return jnp.where(mask, x / (1.0 - context.module.rate), jnp.zeros_like(x))
        return next_fun(*args, **kwargs)

    def loss(params):
        fused = jax_fuse_parts(*(batch[k] for k in FRONTAL_PATCH_KEYS))
        with fnn.intercept_methods(dropout):
            out, _ = jgen.apply({"params": params, "batch_stats": {}},
                                *(batch[k] for k in PATCH_KEYS), z, use_dropout=True,
                                train=True, mutable=["batch_stats"])
        scores, _ = jdisc.apply({"params": d_params, "batch_stats": {}}, out.img128_fake,
                                train=True, mutable=["batch_stats"])
        comps = jax_components(
            fake128=out.img128_fake, fake_scores=scores, encoder_predict=out.encoder_predict,
            fused_local_fake=out.local_fake, fused_local_frontal=fused,
            gt128=batch["img_frontal"], gt64=batch["img64_frontal"],
            gt32=batch["img32_frontal"], labels=batch["label"], cfg=s["jcfg"].loss)
        return jax_total(comps, s["jcfg"].loss)

    grads = jax.tree.map(lambda a: np.asarray(a, np.float64), jax.jit(jax.grad(loss))(g_params))
    # the converter is linear: gradients map like weights
    return {k: v.double().numpy() for k, v in jax_generator_params_to_state_dict(grads).items()}


def port_grads(s, dtype):
    """The port's gradient in ``dtype`` (float64 numpy)."""
    gen, disc = build_models(s["cfg"], "cpu")
    gen.load_state_dict(jax_generator_params_to_state_dict(s["g_params"]), strict=True)
    disc.load_state_dict(jax_critic_params_to_state_dict(s["d_params"]), strict=True)
    for m in (gen, disc):
        set_compute_dtype(m.to(dtype), dtype).train()
    nchw = lambda v: torch.from_numpy(v).permute(0, 3, 1, 2).contiguous().to(dtype)
    b = {k: nchw(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in s["batch"].items()}
    out = gen(*(b[k] for k in PATCH_KEYS), torch.from_numpy(s["z"]).to(dtype), use_dropout=True,
              drop_mask=torch.from_numpy(s["mask"]))
    comps = generator_loss_components(
        fake128=out.img128_fake, fake_scores=disc(out.img128_fake),
        encoder_predict=out.encoder_predict, fused_local_fake=out.local_fake,
        fused_local_frontal=fuse_parts(*(b[k] for k in FRONTAL_PATCH_KEYS)),
        gt128=b["img_frontal"], gt64=b["img64_frontal"], gt32=b["img32_frontal"],
        labels=b["label"], cfg=s["cfg"].loss)
    names, params = zip(*gen.named_parameters())
    grads = torch.autograd.grad(total_generator_loss(comps, s["cfg"].loss), params)
    return {n: g.double().numpy() for n, g in zip(names, grads)}


def distance(got, truth):
    """(relative L2 over all leaves, the worst leaf's max|got - truth| over
    its max|truth|)."""
    num = sum(float(np.square(got[k] - t).sum()) for k, t in truth.items())
    den = sum(float(np.square(t).sum()) for t in truth.values())
    worst = max(float(np.abs(got[k] - t).max() / np.abs(t).max())
                for k, t in truth.items() if np.abs(t).max() > 0)
    return np.sqrt(num / den), worst


def test_port_f32_is_no_further_from_the_f64_truth_than_jax_f32(setup):
    with jax.enable_x64(True):
        truth = jax_grads(setup, jnp.float64)
    port64 = port_grads(setup, torch.float64)
    assert port64.keys() == truth.keys()
    agree, agree_worst = distance(port64, truth)
    assert agree <= TRUTHS_AGREE and agree_worst <= 10 * TRUTHS_AGREE, (agree, agree_worst)

    jax32 = distance(jax_grads(setup, jnp.float32), truth)
    port32 = distance(port_grads(setup, torch.float32), truth)
    print(f"relative L2 / worst leaf from the f64 truth: port f32 {port32}, JAX f32 {jax32}; "
          f"the two f64 runs {agree, agree_worst}")
    assert 0 < port32[0] <= MARGIN * jax32[0], (port32, jax32)
    assert port32[1] <= MARGIN * jax32[1], (port32, jax32)