"""The port's layer library (``tpgan_tpu_torch.ops.blocks``) against the
JAX blocks it replaces, on the same numpy-drawn weights carried across by
``tpgan_tpu_torch.convert``; and the port's initializers against the JAX
initializers' fan rules."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.ops import blocks as jb
from tpgan_tpu.ops import initializers as jinit
from tpgan_tpu.ops.activations import LEAKY_RELU, RELU, SIGMOID, TANH
from tpgan_tpu_torch.ops import blocks as tb
from tpgan_tpu_torch.ops import initializers as tinit

from _torch_port import init_numpy, jax_variables, load_port, nchw, nhwc

torch.set_num_threads(1)

# single layers: only the summation order differs
TOL = dict(rtol=1e-4, atol=1e-5)


def _x(b, h, w, c, seed=0):
    return np.random.RandomState(seed).standard_normal((b, h, w, c)).astype(np.float32)


def _run(jax_mod, port_mod, x, seed=0, prefix=""):
    params, stats = init_numpy(jax_mod, x, seed=seed)
    want = np.asarray(jax_mod.apply(jax_variables(params, stats), jnp.asarray(x)))
    load_port(port_mod, params, stats, prefix=prefix)
    with torch.no_grad():
        got = port_mod(torch.from_numpy(nchw(x))).numpy()
    return nhwc(got), want


@pytest.mark.parametrize(
    "cin,cout,k,s,padding,hw",
    [
        (3, 8, 3, 1, 1, 16),  # int padding
        (4, 6, 3, 2, (1, 2), 16),  # (padH, padW), stride 2
        (5, 7, 2, 1, (1, 0, 1, 0), 8),  # reflect (l, r, t, b): add_8 / enhance_8
        (6, 5, 5, 1, (2, 1, 0, 2), 9),  # asymmetric reflect
        (8, 16, 3, 2, 1, 16),  # stride 2
    ],
)
def test_conv2d_matches_jax(cin, cout, k, s, padding, hw):
    got, want = _run(
        jb.Conv2d(cin, cout, k, s, padding),
        tb.Conv2d(cin, cout, k, s, padding),
        _x(2, hw, hw, cin, seed=k),
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "cin,cout,k,s,p,op,hw",
    [
        (6, 4, 8, 1, 0, 0, 1),  # deconv_8: k8 from a 1x1 map
        (4, 8, 3, 4, 0, 1, 2),  # deconv_32: k3, s4, p0, op1
        (4, 8, 3, 2, 1, 1, 8),  # the k3/s2/p1/op1 upsamplers
    ],
)
def test_conv_transpose2d_matches_jax(cin, cout, k, s, p, op, hw):
    got, want = _run(
        jb.ConvTranspose2d(cin, cout, k, s, p, op),
        tb.ConvTranspose2d(cin, cout, k, s, p, op),
        _x(2, hw, hw, cin, seed=k + s),
        prefix="deconv",
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["deconv", "subpixel", "resize_conv"])
@pytest.mark.parametrize(
    "cin,cout,k,s,p,op,hw",
    [(6, 4, 8, 1, 0, 0, 1), (4, 8, 3, 4, 0, 1, 2), (4, 8, 3, 2, 1, 1, 8)],
)
def test_deconv_block_modes_match_jax(mode, cin, cout, k, s, p, op, hw):
    got, want = _run(
        jb.DeconvBlock(cin, cout, k, s, p, op, "kaiming", RELU, mode=mode),
        tb.DeconvBlock(cin, cout, k, s, p, op, "kaiming", RELU, mode=mode),
        _x(2, hw, hw, cin, seed=hw),
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("act", [LEAKY_RELU, SIGMOID, TANH], ids=lambda a: a[0])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_block_batchnorm_eval_matches_jax(act, stride):
    """BatchNorm in eval mode on running statistics, with the
    saturating-activation ordering."""
    kw = dict(activation=act, use_batchnorm=True)
    got, want = _run(
        jb.ConvBlock(4, 6, 3, stride, 1, **kw), tb.ConvBlock(4, 6, 3, stride, 1, **kw),
        _x(2, 8, 8, 4),
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", ["deconv", "resize_conv"])
def test_deconv_block_batchnorm_eval_matches_jax(mode):
    kw = dict(use_batchnorm=True, mode=mode)
    got, want = _run(
        jb.DeconvBlock(4, 6, 3, 2, 1, 1, "kaiming", RELU, **kw),
        tb.DeconvBlock(4, 6, 3, 2, 1, 1, "kaiming", RELU, **kw),
        _x(2, 8, 8, 4, seed=5),
    )
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "act,use_batchnorm", [(None, False), (LEAKY_RELU, False), (RELU, True)]
)
def test_linear_block_matches_jax(act, use_batchnorm):
    x = np.random.RandomState(1).standard_normal((4, 24)).astype(np.float32)
    jmod = jb.LinearBlock(24, 10, activation=act, use_batchnorm=use_batchnorm)
    params, stats = init_numpy(jmod, x)
    want = np.asarray(jmod.apply(jax_variables(params, stats), jnp.asarray(x)))
    tmod = load_port(tb.LinearBlock(24, 10, act, use_batchnorm), params, stats)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize(
    "kw,cin,hw",
    [
        (dict(), 6, 8),  # identity shortcut, k3
        (dict(kernel_size=2, padding=(1, 0, 1, 0), activation=LEAKY_RELU), 6, 8),
        (dict(kernel_size=5, activation=LEAKY_RELU, scaling_factor=0.5), 4, 9),
        (dict(is_bottleneck=True), 8, 8),
        (dict(out_channels=10, use_projection=True), 6, 8),
        (dict(out_channels=10, stride=2, is_bottleneck=True, use_projection=True), 8, 8),
        (dict(use_batchnorm=True, activation=LEAKY_RELU), 6, 8),
    ],
    ids=["identity", "k2_reflect", "k5_scaled", "bottleneck", "projection",
         "bottleneck_projection_s2", "batchnorm"],
)
def test_residual_block_matches_jax(kw, cin, hw):
    got, want = _run(
        jb.ResidualBlock(cin, **kw), tb.ResidualBlock(cin, **kw), _x(2, hw, hw, cin, seed=cin)
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kw", [dict(out_channels=8), dict(stride=2)])
def test_residual_block_rejects_stale_identity_shortcut(kw):
    """An identity shortcut with in != out or stride != 1 is refused by
    both packages (blocks.py:702-710)."""
    x = jnp.zeros((1, 8, 8, 4))
    with pytest.raises(ValueError, match="identity shortcut"):
        jb.ResidualBlock(4, **kw).init(jax.random.PRNGKey(0), x)
    with pytest.raises(ValueError, match="identity shortcut"):
        tb.ResidualBlock(4, **kw)


def test_resize_conv_rejects_fractional_ratio():
    block = tb.DeconvBlock(2, 2, 4, 2, 1, 1, mode="resize_conv")  # 3 -> 7
    with pytest.raises(ValueError, match="integer upsampling ratio"):
        block(torch.zeros(1, 2, 3, 3))


# (JAX initializer, port initializer, JAX shape, port shape): the same
# tensor in the two packages' layouts
_CONV = ((3, 3, 16, 32), (32, 16, 3, 3))
_DECONV = ((3, 3, 16, 32), (16, 32, 3, 3))
_LINEAR = ((48, 96), (96, 48))


@pytest.mark.parametrize(
    "jfn,tfn,shapes",
    [
        (jinit.kaiming_normal_conv(0.01), tinit.kaiming_normal_conv(0.01), _CONV),
        (jinit.kaiming_normal_deconv(0.0), tinit.kaiming_normal_deconv(0.0), _DECONV),
        (jinit.xavier_normal_conv(), tinit.xavier_normal_conv(), _CONV),
        (jinit.xavier_normal_deconv(), tinit.xavier_normal_deconv(), _DECONV),
        (jinit.torch_default_conv(), tinit.torch_default_conv(), _CONV),
        (jinit.torch_default_deconv(), tinit.torch_default_deconv(), _DECONV),
        (jinit.torch_default_linear(), tinit.torch_default_linear(), _LINEAR),
        (jinit.kaiming_normal_linear(0.2), tinit.kaiming_normal_linear(0.2), _LINEAR),
        (jinit.xavier_normal_linear(), tinit.xavier_normal_linear(), _LINEAR),
        (jinit.uniform_bias(75), tinit.uniform_bias(75), ((4096,), (4096,))),
    ],
    ids=["kaiming_conv", "kaiming_deconv", "xavier_conv", "xavier_deconv",
         "default_conv", "default_deconv", "default_linear", "kaiming_linear",
         "xavier_linear", "uniform_bias"],
)
def test_initializers_follow_jax_fan_rules(jfn, tfn, shapes):
    """Same distribution in the two layouts (std within 5%, mean near 0,
    same bound for the uniform ones) — includes the ConvTranspose2d
    fan_in = out*kh*kw quirk."""
    jshape, tshape = shapes
    want = np.asarray(jfn(jax.random.PRNGKey(0), jshape, jnp.float32))
    got = tfn(torch.empty(tshape), torch.Generator().manual_seed(0)).numpy()
    assert abs(got.std() / want.std() - 1) < 0.05
    assert abs(got.mean()) < 0.1 * want.std()
    assert abs(np.abs(got).max() / np.abs(want).max() - 1) < 0.5


def test_seeded_init_is_reproducible():
    def draw(seed):
        block = tb.ResidualBlock(4, is_bottleneck=True)
        tb.reset_parameters(block, torch.Generator().manual_seed(seed))
        return torch.cat([p.flatten() for p in block.parameters()])

    assert torch.equal(draw(3), draw(3))
    assert not torch.equal(draw(3), draw(4))
