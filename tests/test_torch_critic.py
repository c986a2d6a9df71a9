"""The port's PatchGAN critic against the JAX package's at fm_multiplier
0.25, in float32 on the CPU: without BatchNorm, and with BatchNorm in
eval mode (running statistics) and in train mode (batch statistics,
running statistics advanced with momentum 0.1 and the unbiased
variance). Weights are numpy draws over the JAX init tree, carried
across by ``jax_critic_params_to_state_dict`` and loaded with
``strict=True``."""

import numpy as np
import pytest
import torch

import jax

from tpgan_tpu.models.discriminator import Discriminator as JDiscriminator
from tpgan_tpu_torch.convert import jax_critic_params_to_state_dict
from tpgan_tpu_torch.models.discriminator import Discriminator
from tpgan_tpu_torch.ops.blocks import BatchNorm2d, frozen_batch_stats

from _torch_port import F32_TOL, init_numpy, jax_variables, nchw, nhwc

torch.set_num_threads(1)


def _pair(use_batchnorm, seed=0):
    x = np.random.RandomState(seed).uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    jmod = JDiscriminator(use_batchnorm=use_batchnorm, fm_multiplier=0.25)
    params, stats = init_numpy(jmod, x, seed=seed + 1)
    disc = Discriminator(use_batchnorm=use_batchnorm, fm_multiplier=0.25)
    disc.load_state_dict(jax_critic_params_to_state_dict(params, stats), strict=True)
    return x, jmod, params, stats, disc


def test_parameter_names_are_the_jax_tree():
    _x, _jmod, params, _stats, disc = _pair(False)
    assert set(params) == {"conv0", "conv1", "conv2", "conv3", "conv4", "res3", "res4", "head"}
    assert {n.split(".")[0] for n, _ in disc.named_parameters()} == set(params)
    # the RGB input stays at 3 channels at fm 0.25
    assert disc.conv0.conv.weight.shape == (16, 3, 3, 3)


@pytest.mark.parametrize("use_batchnorm", [False, True])
def test_critic_eval_matches_jax(use_batchnorm):
    x, jmod, params, stats, disc = _pair(use_batchnorm, seed=3)
    want = jax.jit(jmod.apply)(jax_variables(params, stats), x)
    with torch.no_grad():
        got = disc.eval()(torch.from_numpy(nchw(x)))
    assert got.shape == (2, 1, 4, 4) and np.asarray(want).shape == (2, 4, 4, 1)
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **F32_TOL)


def test_batchnorm_critic_train_mode_matches_jax():
    x, jmod, params, stats, disc = _pair(True, seed=5)
    want, mutated = jax.jit(
        lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"])
    )(jax_variables(params, stats), x)
    with torch.no_grad():
        got = disc.train()(torch.from_numpy(nchw(x)))
    np.testing.assert_allclose(nhwc(got.numpy()), np.asarray(want), **F32_TOL)
    new = jax_critic_params_to_state_dict(params, jax.device_get(mutated["batch_stats"]))
    sd = disc.state_dict()
    for name in new:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), new[name].numpy(), **F32_TOL,
                                       err_msg=name)


def test_running_var_advances_with_the_unbiased_variance():
    bn = BatchNorm2d(3).train()
    x = torch.from_numpy(np.random.RandomState(7).standard_normal((2, 3, 4, 5)).astype(np.float32))
    bn(x)
    n = 2 * 4 * 5
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 + 0.1 * biased * n / (n - 1), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * x.mean(dim=(0, 2, 3)), rtol=1e-6,
                               atol=1e-7)


def test_frozen_batch_stats_normalises_the_same_and_advances_nothing():
    _x, _jmod, _params, _stats, disc = _pair(True, seed=9)
    x = torch.from_numpy(nchw(np.random.RandomState(2).uniform(-1, 1, (2, 128, 128, 3))
                              .astype(np.float32)))
    disc.train()
    before = {k: v.clone() for k, v in disc.state_dict().items()}
    with frozen_batch_stats(disc), torch.no_grad():
        frozen = disc(x)
    assert all(torch.equal(before[k], v) for k, v in disc.state_dict().items())
    with torch.no_grad():
        advancing = disc(x)
    assert torch.equal(frozen, advancing)
    assert not torch.equal(before["conv0.bn.running_mean"], disc.conv0.bn.running_mean)
    assert all(m.advance_stats for m in disc.modules() if isinstance(m, BatchNorm2d))
