"""The BatchNorm variant of the port's fused train step (G and D with
BatchNorm) against the JAX package's, one SGD(1e-2) step at fm 0.25,
batch 2, float32, with the JAX step's noise injected: the metrics, the
critic's gradients, and the running statistics after the step. They hold
the two BatchNorm rules of the step: the generator's statistics advance
on both of its forwards (D phase, then G phase), the critic's only on the
real-image pass — the fake, GP and G-phase passes normalise with their own
batch statistics and advance nothing (``gan_trainer.py:273-282,311``).

The generator's gradients are held against JAX's own gradient composed
of jitted pieces instead of the jitted step: on the CPU (jax 0.9.0), the
jitted gradient of the whole BatchNorm generator in train mode disagrees
with JAX's eager gradient by up to 41% of a LocalPathway leaf's max, while
the eager one, the composition below and the port agree to ~1e-6. The
pieces: the jitted gradient of (fuse + GlobalPathway) with respect to
the four LocalPathways' outputs and the GlobalPathway's parameters, then
each LocalPathway's VJP. With BatchNorm at batch 2 the GlobalPathway's
gradients are ill-conditioned in f32: the port's own f32 gradients differ
from its float64 run by up to 1.7e-2 of a leaf's max, so this comparison
takes atol 3e-2 x the leaf's max (the LocalPathway leaves agree to ~1e-6
against JAX's eager gradient)."""

BN_GRAD_ATOL_SHARE = 3e-2

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.models.global_pathway import GlobalPathway as JGlobalPathway
from tpgan_tpu.models.local_pathway import LocalPathway as JLocalPathway
from tpgan_tpu.ops.pallas_kernels import fuse_parts_pallas
from tpgan_tpu_torch.convert import jax_generator_params_to_state_dict

from _torch_train_parity import (
    PATCH_KEYS,
    Pair,
    assert_grads_match,
    assert_metrics_match,
    jax_as_port,
    sgd,
    torch_sgd,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def steps():
    pair = Pair(use_batchnorm=True, seed=20)
    return pair, pair.jax_step(sgd), pair.port_step(torch_sgd)


def test_bn_step_metrics_match_jax(steps):
    _, (_, _, want), (_, _, got) = steps
    assert_metrics_match(got, want)


def test_bn_step_critic_gradients_match_jax(steps):
    _, (_, ja, _), (_, ta, _) = steps
    assert_grads_match(jax_as_port(ja.d_opt_state, critic=True), ta["d_grad"], "d")


def test_bn_generator_train_mode_gradients_match_jax_composed(steps):
    pair = steps[0]
    params, stats = pair.g_params, pair.g_stats
    imgs = [pair.batch[k] for k in PATCH_KEYS]
    z = pair.noise["z"]
    r = np.sin(np.arange(2 * 128 * 128 * 3)).reshape(2, 128, 128, 3).astype(np.float32)
    local = JLocalPathway(use_batchnorm=True, feature_layer_dim=16, fm_multiplier=0.25)
    glob = JGlobalPathway(zdim=64, local_feature_layer_dim=16, use_batchnorm=True,
                          fm_multiplier=0.25)
    names = ("local_left_eye", "local_right_eye", "local_nose", "local_mouth")

    def local_apply(p, name, x):
        return local.apply({"params": p, "batch_stats": stats[name]}, x, train=True,
                           mutable=["batch_stats"])[0]

    outs = [jax.jit(local_apply, static_argnums=1)(params[n], n, x)
            for n, x in zip(names, imgs[1:])]

    def rest(gp, outs):
        fake = fuse_parts_pallas(*(o[0] for o in outs))
        feat = fuse_parts_pallas(*(o[1] for o in outs))
        img, _ = glob.apply({"params": gp, "batch_stats": stats["global_pathway"]}, imgs[0],
                            fake, feat, z, train=True, mutable=["batch_stats"])[0]
        return jnp.sum(img * r)

    g_glob, g_outs = jax.jit(jax.grad(rest, argnums=(0, 1)))(params["global_pathway"], outs)
    want = {"global_pathway": g_glob}
    for n, x, g_out in zip(names, imgs[1:], g_outs):
        _, vjp = jax.vjp(lambda p: local_apply(p, n, x), params[n])
        want[n] = vjp(g_out)[0]
    want = {k: v.numpy() for k, v in jax_generator_params_to_state_dict(want).items()}

    gen = pair.port_models()[0].train()
    out = gen(*(torch.from_numpy(a).permute(0, 3, 1, 2).contiguous() for a in imgs),
              torch.from_numpy(z))
    (out.img128_fake * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    got = {n: p.grad.numpy() for n, p in gen.named_parameters() if p.grad is not None}
    assert {n.split(".")[0] for n in got} == set(names) | {"global_pathway"}
    assert_grads_match(want, got, "g", atol_share=BN_GRAD_ATOL_SHARE)


@pytest.mark.parametrize("model", ["d", "g"])
def test_bn_running_stats_after_the_step_match_jax(steps, model):
    pair, (_, ja, _), (tb, ta, _) = steps
    critic = model == "d"
    params, stats = (ja.d_params, ja.d_batch_stats) if critic else (ja.g_params, ja.g_batch_stats)
    want = jax_as_port(params, critic, stats)
    got = ta[f"{model}_stats"]
    assert got and set(got) <= set(want)
    for name, value in got.items():
        assert not np.array_equal(value, tb[f"{model}_stats"][name]), f"{name} did not advance"
        np.testing.assert_allclose(value, want[name], rtol=2e-3, atol=2e-4, err_msg=name)


def test_critic_stats_advance_once_per_step(steps):
    """Re-derive the critic's first running mean by hand: one momentum-0.1
    update from the real images alone."""
    pair, _, (tb, ta, _) = steps
    disc = pair.port_models()[1]
    real = torch.from_numpy(pair.batch["img_frontal"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        h = disc.conv0.conv(real)
    mean = h.mean(dim=(0, 2, 3)).numpy()
    var = h.var(dim=(0, 2, 3), unbiased=True).numpy()
    m0, v0 = tb["d_stats"]["conv0.bn.running_mean"], tb["d_stats"]["conv0.bn.running_var"]
    np.testing.assert_allclose(ta["d_stats"]["conv0.bn.running_mean"], 0.9 * m0 + 0.1 * mean,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ta["d_stats"]["conv0.bn.running_var"], 0.9 * v0 + 0.1 * var,
                               rtol=1e-5, atol=1e-6)
