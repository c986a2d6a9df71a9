"""The port's GAN losses against the JAX package's, in float32 on the CPU:
the pixel losses, the WGAN losses and the gradient penalty (the same
``eps``, drawn by ``jax.random.uniform``), the composite generator loss,
and the symmetry + TV reduction K2 — its plain version and wrapper
against ``_sym_tv_sums_raw(interpret=True)`` and ``symmetry_tv_losses``,
and its gradient against ``jax.grad`` through ``symmetry_tv_losses`` on
inputs with planted ties, where JAX's abs rule (sign(0) = +1) decides the
TV gradient."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.losses import composite as jcomposite
from tpgan_tpu.losses import gan as jgan
from tpgan_tpu.losses import pixel as jpixel
from tpgan_tpu.models.discriminator import Discriminator as JDiscriminator
from tpgan_tpu.ops.pallas_kernels import _sym_tv_sums_raw, symmetry_tv_losses as jax_sym_tv
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import jax_critic_params_to_state_dict
from tpgan_tpu_torch.losses import composite, gan, pixel
from tpgan_tpu_torch.models.discriminator import Discriminator
from tpgan_tpu_torch.ops import kernels

from _torch_port import init_numpy, jax_variables, nchw

torch.set_num_threads(1)

RTOL = 1e-5


def _img(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(nchw(x))


def _close(got, want, rtol=RTOL, atol=0.0):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(float(got), float(want), rtol=rtol, atol=atol)


def test_pixel_losses_match_jax():
    fake = _img((2, 128, 128, 3), 0)
    gts = [_img((2, s, s, 3), i) for i, s in enumerate((128, 64, 32), start=1)]
    _close(pixel.l1(_t(fake), _t(gts[0])), jpixel.l1(fake, gts[0]))
    _close(pixel.multiscale_pixel_loss(_t(fake), *map(_t, gts)),
           jpixel.multiscale_pixel_loss(fake, *gts))
    _close(pixel.multiscale_pixel_loss(_t(fake), *map(_t, gts), 0.5, 2.0, 3.0),
           jpixel.multiscale_pixel_loss(fake, *gts, 0.5, 2.0, 3.0))
    _close(pixel.local_pixel_loss(_t(fake), _t(gts[0])), jpixel.local_pixel_loss(fake, gts[0]))
    _close(pixel.symmetry_loss(_t(fake)), jpixel.symmetry_loss(fake))
    _close(pixel.total_variation(_t(fake)), jpixel.total_variation(fake))
    np.testing.assert_allclose(pixel._downsample_area(_t(fake), 4).numpy(),
                               nchw(np.asarray(jpixel._downsample_area(fake, 4))), rtol=1e-6,
                               atol=1e-7)


def test_l1_gradient_at_exact_ties_is_jax_sign():
    a = _img((2, 8, 8, 3), 3)
    b = a.copy()
    b[0, :4] = _img((4, 8, 3), 4)  # half the elements differ, half tie exactly
    want = np.asarray(jax.grad(jpixel.l1)(a, b))
    ta = _t(a).requires_grad_()
    pixel.l1(ta, _t(b)).backward()
    got = ta.grad.numpy()
    np.testing.assert_allclose(got, nchw(want), rtol=1e-6)
    ties = nchw(a == b)
    assert ties.any() and np.all(got[ties] > 0)  # +1/N at a tie, where torch's abs gives 0


def test_wgan_losses_match_jax():
    real = np.random.RandomState(5).standard_normal((2, 4, 4, 1)).astype(np.float32)
    fake = np.random.RandomState(6).standard_normal((2, 4, 4, 1)).astype(np.float32)
    _close(gan.discriminator_loss(_t(real), _t(fake)), jgan.discriminator_loss(real, fake))
    _close(gan.generator_adversarial_loss(_t(fake)), jgan.generator_adversarial_loss(fake))


def test_gradient_penalty_matches_jax():
    real, fake = _img((2, 128, 128, 3), 7), _img((2, 128, 128, 3), 8)
    jmod = JDiscriminator(fm_multiplier=0.25)
    params, stats = init_numpy(jmod, real, seed=9)
    rng = jax.random.PRNGKey(11)
    critic = lambda x: jmod.apply(jax_variables(params, stats), x)
    want = jax.jit(lambda r, f: jgan.gradient_penalty(critic, r, f, rng))(real, fake)
    eps = np.array(jax.random.uniform(rng, (2, 1, 1, 1), dtype=jnp.float32))
    disc = Discriminator(fm_multiplier=0.25)
    disc.load_state_dict(jax_critic_params_to_state_dict(params, stats), strict=True)
    got = gan.gradient_penalty(disc, _t(real), _t(fake), torch.from_numpy(eps))
    assert got.dtype == torch.float32 and got.requires_grad  # differentiable in D's weights
    _close(got, want)


def test_composite_components_and_total_match_jax():
    rng = np.random.RandomState(12)
    fake128 = _img((2, 128, 128, 3), 13)
    args = dict(
        fake_scores=rng.standard_normal((2, 4, 4, 1)).astype(np.float32),
        encoder_predict=rng.standard_normal((2, 347)).astype(np.float32),
        fused_local_fake=_img((2, 128, 128, 3), 14),
        fused_local_frontal=_img((2, 128, 128, 3), 15),
        gt128=_img((2, 128, 128, 3), 16), gt64=_img((2, 64, 64, 3), 17),
        gt32=_img((2, 32, 32, 3), 18),
    )
    labels = rng.randint(0, 347, (2,)).astype(np.int32)
    jcfg, cfg = jax_make_config({}).loss, make_config({}).loss
    want = jcomposite.generator_loss_components(fake128=fake128, labels=labels, cfg=jcfg, **args)
    got = composite.generator_loss_components(
        fake128=_t(fake128), labels=torch.from_numpy(labels), cfg=cfg,
        **{k: _t(v) if v.ndim == 4 else torch.from_numpy(v) for k, v in args.items()},
    )
    assert set(got) == set(want)
    assert got["identity_preserving"].dtype == torch.float32
    for k in want:
        _close(got[k], want[k], atol=1e-7)
    _close(composite.total_generator_loss(got, cfg), jcomposite.total_generator_loss(want, jcfg))


def _tied(seed, dtype=np.float32):
    """An image with planted TV ties (equal vertical and horizontal
    neighbours) and symmetry ties (mirror columns equal)."""
    x = _img((2, 16, 12, 3), seed)
    x[:, 3] = x[:, 2]             # H ties along a whole row
    x[:, :, 5] = x[:, :, 4]       # W ties along a whole column
    x[1, :, 9] = x[1, :, 2]       # symmetry ties (mirror of column 2 is 9)
    x[0, 7:10, 1:4] = 0.25        # a flat patch: H and W ties together
    return x.astype(dtype)


def test_sym_tv_plain_and_wrapper_match_the_tpu_kernel():
    x = _tied(20)
    sums = np.asarray(_sym_tv_sums_raw(x, interpret=True))[0]
    np.testing.assert_allclose(kernels.sym_tv_sums_plain(_t(x)).numpy(), sums, rtol=RTOL)
    want_sym, want_tv = jax_sym_tv(x)
    got_sym, got_tv = kernels.symmetry_tv_losses(_t(x))
    assert got_sym.dtype == got_tv.dtype == torch.float32 and got_sym.dim() == 0
    _close(got_sym, want_sym)
    _close(got_tv, want_tv)
    _close(pixel.symmetry_loss(_t(x)), want_sym)
    _close(pixel.total_variation(_t(x)), want_tv)
    assert kernels.launch_counts()["sym_tv"] == 0  # the CPU runs the plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sym_tv_gradient_matches_jax_grad_at_ties(dtype):
    x = _tied(21)
    g_sym, g_tv = 0.3, 1e-3 * 7.0
    jx = jnp.asarray(x, dtype=dtype)
    want = jax.grad(lambda v: g_sym * jax_sym_tv(v)[0] + g_tv * jax_sym_tv(v)[1])(jx)
    want = nchw(np.asarray(want.astype(jnp.float32)))
    tx = torch.from_numpy(nchw(np.array(jx.astype(jnp.float32)))).to(getattr(torch, dtype))
    tx.requires_grad_()
    sym, tv = kernels.symmetry_tv_losses(tx)
    (g_sym * sym + g_tv * tv).backward()
    assert tx.grad.dtype == tx.dtype
    got = tx.grad.float().numpy()
    # f32: summation order only; bf16: the one rounding of dx can land on
    # the neighbouring bf16 value (2^-8 relative)
    rtol = 1e-5 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * np.abs(want).max())
    # the ties decide: the same losses through torch's abs (sign(0) = 0)
    # miss the TV gradient at the ties by g_tv / N_h, far outside rtol
    xt = tx.detach().float().requires_grad_()
    (g_sym * (xt - xt.flip(3)).abs().mean()
     + g_tv * ((xt[:, :, 1:] - xt[:, :, :-1]).abs().mean()
               + (xt[..., 1:] - xt[..., :-1]).abs().mean())).backward()
    n_h = 2 * 3 * 15 * 12
    assert np.abs(xt.grad.numpy() - want).max() > 0.5 * g_tv / n_h


def test_sym_tv_backward_plain_version_is_jax_rule_by_hand():
    x = torch.tensor([[[[1.0, 1.0, 2.0], [1.0, 0.0, 1.0]]]])  # (1, 1, 2, 3)
    g = kernels.sym_tv_bwd_plain(x, torch.tensor(1.0), torch.tensor(0.0))
    # symmetry: pairs (0, 2): s(1-2) - s(2-1) = -2 at w=0, +2 at w=2; w=1
    # is its own mirror: s(0) - s(0) = 0; row 1 ties with its mirror: 0
    np.testing.assert_allclose(g.numpy()[0, 0], [[-2 / 6, 0, 2 / 6], [0, 0, 0]])
    g = kernels.sym_tv_bwd_plain(x, torch.tensor(0.0), torch.tensor(1.0))
    n_h, n_w = 3, 4
    # H: x[1,0] == x[0,0] -> s(0) = +1 to the lower, -1 to the upper
    want_h = np.array([[-1, 1, 1], [1, -1, -1]]) / n_h
    want_w = np.array([[-1, 1 - 1, 1], [1, -1 - 1, 1]]) / n_w
    np.testing.assert_allclose(g.numpy()[0, 0], want_h + want_w, rtol=1e-6)
