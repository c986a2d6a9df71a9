"""Shared set-up of the tests that hold the port's fused WGAN-GP train step
against ``tpgan_tpu.train.gan_trainer.make_gan_train_step`` on the CPU.

Both sides start from the same numpy-drawn weights (``_torch_port``), see
the same batch, and the port is handed the JAX step's own noise: ``z`` and
the GP ``eps`` regenerated from the step rng's splits
(``gan_trainer.py:337-338``, ``losses/gan.py:45``), and the two dropout
keep-masks captured from the JAX generator with
``flax.linen.intercept_methods`` on ``nn.Dropout.__call__`` (the mask is
``y != 0``; the dropout input, the bottleneck max, is never exactly 0).
"""

from __future__ import annotations

import numpy as np
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp
import optax

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.train.gan_trainer import GANTrainState as JGANTrainState
from tpgan_tpu.train.gan_trainer import build_models as jax_build_models
from tpgan_tpu.train.gan_trainer import make_gan_train_step as jax_make_gan_train_step
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import (
    jax_critic_params_to_state_dict,
    jax_generator_params_to_state_dict,
)
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.train.gan_trainer import (
    GANTrainState,
    build_models,
    make_gan_train_step,
)

from _torch_port import init_numpy

BATCH = 2
SGD_LR = 1e-2
PATCH_KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")


def overrides(use_batchnorm: bool = False, train=None) -> dict:
    return {
        "G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16,
              "use_batchnorm": use_batchnorm},
        "D": {"fm_multiplier": 0.25, "use_batchnorm": use_batchnorm},
        "compute_dtype": "float32",
        "train": dict(train or {}),
    }


def tree_np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


class Pair:
    """One configuration's JAX models, initial numpy weights, batch and
    the JAX step's noise, with helpers to run one step on either side.
    ``train``: train-config overrides of both sides (``grad_accum_steps``
    gives the noise a leading microbatch axis, as the JAX step draws it)."""

    def __init__(self, use_batchnorm: bool = False, seed: int = 0, batch: int = BATCH,
                 train=None, data=None):
        ov = overrides(use_batchnorm, train)
        self.jcfg, self.cfg = jax_make_config(ov), make_config(ov)
        self.jgen, self.jdisc = jax_build_models(self.jcfg)
        # ``data``: a float batch of ``batch`` items in place of the
        # synthetic one
        self.batch = synthetic_gan_batch(batch, seed=seed + 10) if data is None else data
        imgs = [self.batch[k] for k in PATCH_KEYS]
        z0 = np.zeros((batch, self.cfg.G.zdim), np.float32)
        self.g_params, self.g_stats = init_numpy(self.jgen, *imgs, z0, seed=seed + 1)
        self.d_params, self.d_stats = init_numpy(self.jdisc, imgs[0], seed=seed + 2)
        self.rng = jax.random.PRNGKey(seed + 3)
        self.noise = self._jax_noise()

    def _jax_noise(self) -> dict:
        """The step's draws as ``gan_trainer.py:337-338`` (one batch) or
        ``:398-405`` (accumulation: z for all microbatches at once, one GP
        rng and two dropout rngs per microbatch) makes them. The masks are
        tracers inside the JAX scan, so each is regenerated by applying the
        generator outside it, on that microbatch with its own rng."""
        accum = max(int(self.cfg.train.grad_accum_steps or 1), 1)
        b = self.batch["img"].shape[0]
        m = b // accum
        z_rng, gp_rng, drop_rng, drop_rng2 = jax.random.split(self.rng, 4)
        gen = self.jgen

        @jax.jit
        def keep_mask(drop_rng, imgs, z):
            seen = {}

            def grab(next_fun, args, kwargs, context):
                out = next_fun(*args, **kwargs)
                if isinstance(context.module, fnn.Dropout):
                    seen["y"] = out
                return out

            with fnn.intercept_methods(grab):
                gen.apply(
                    {"params": self.g_params, "batch_stats": self.g_stats or {}},
                    *imgs, z,
                    use_dropout=True, train=True, rngs={"dropout": drop_rng},
                    mutable=["batch_stats"],
                )
            return seen["y"] != 0

        imgs = [self.batch[k] for k in PATCH_KEYS]
        if accum == 1:
            z = jax.random.normal(z_rng, (b, self.cfg.G.zdim), jnp.float32)
            eps = jax.random.uniform(gp_rng, (b, 1, 1, 1), dtype=jnp.float32)
            masks = [keep_mask(r, imgs, z) for r in (drop_rng, drop_rng2)]
        else:
            z = jax.random.normal(z_rng, (accum, m, self.cfg.G.zdim), jnp.float32)
            eps = jnp.stack([jax.random.uniform(r, (m, 1, 1, 1), dtype=jnp.float32)
                             for r in jax.random.split(gp_rng, accum)])
            masks = [
                jnp.stack([keep_mask(r, [x[i * m:(i + 1) * m] for x in imgs], z[i])
                           for i, r in enumerate(jax.random.split(rng, accum))])
                for rng in (drop_rng, drop_rng2)
            ]
        return {  # np.array: writable copies for torch
            "z": np.array(z), "gp_eps": np.array(eps),
            "drop_mask_d": np.array(masks[0]), "drop_mask_g": np.array(masks[1]),
        }

    def jax_step(self, make_tx, identity_embed=None):
        """One jitted JAX step from the initial weights: (old, new, metrics);
        ``identity_embed``: JAX's embed function for the identity term."""
        g_tx, d_tx = make_tx(), make_tx()
        gp, dp = self.g_params, self.d_params
        state = JGANTrainState(
            step=jnp.zeros((), jnp.int32), g_params=gp, d_params=dp,
            g_opt_state=g_tx.init(gp), d_opt_state=d_tx.init(dp),
            g_batch_stats=self.g_stats or {}, d_batch_stats=self.d_stats or {},
            g_ema_params=jax.tree.map(jnp.copy, gp),
        )
        step = jax.jit(jax_make_gan_train_step(self.jcfg, self.jgen, self.jdisc, g_tx, d_tx,
                                               identity_embed))
        new, metrics = step(state, self.batch, self.rng)
        return tree_np(state), tree_np(new), {k: float(v) for k, v in metrics.items()}

    def port_models(self):
        gen, disc = build_models(self.cfg, "cpu")
        gen.load_state_dict(jax_generator_params_to_state_dict(self.g_params, self.g_stats),
                            strict=True)
        disc.load_state_dict(jax_critic_params_to_state_dict(self.d_params, self.d_stats),
                             strict=True)
        return gen, disc

    def port_step(self, make_opt, identity_embed=None):
        """One port step from the same weights with the JAX noise:
        (state before as numpy dicts, state after, metrics)."""
        gen, disc = self.port_models()
        g_opt, d_opt = make_opt(gen.parameters()), make_opt(disc.parameters())
        ema = {n: p.detach().clone() for n, p in gen.named_parameters()}
        state = GANTrainState(0, gen, disc, g_opt, d_opt, ema)
        before = snapshot(state)
        step = make_gan_train_step(self.cfg, gen, disc, g_opt, d_opt, identity_embed)
        state, metrics = step(state, self.batch, torch.Generator().manual_seed(0), self.noise)
        return before, snapshot(state), {k: float(v) for k, v in metrics.items()}


def snapshot(state: GANTrainState) -> dict:
    """Numpy copies of the state's parameters, EMA and running stats."""
    grab = lambda d: {k: v.detach().numpy().copy() for k, v in d.items()}
    grads = lambda d: {k: v.grad.numpy().copy() for k, v in d.items() if v.grad is not None}
    return {
        "g": grab(state.g_params), "d": grab(state.d_params),
        "g_grad": grads(state.g_params), "d_grad": grads(state.d_params),
        "ema": grab(state.g_ema_params),
        "g_stats": grab(state.g_batch_stats), "d_stats": grab(state.d_batch_stats),
    }


def jax_as_port(tree, critic: bool = False, stats=None) -> dict:
    """A JAX parameter (or gradient) tree under the port's state_dict
    names and layouts (the converter is linear, so grads map like
    weights)."""
    convert = jax_critic_params_to_state_dict if critic else jax_generator_params_to_state_dict
    return {k: v.numpy() for k, v in convert(tree, stats).items()}


def sgd():
    """optax.sgd(1e-2) that also keeps the gradient it was given as its
    state, so the test reads JAX's gradients exactly (read back as
    (p - p') / lr they would carry a quantum of ulp(p) / lr, 7e-7 at
    |p| ~ 0.1, above the tolerance of a leaf whose gradients are ~1e-6)."""

    def update(grads, state, params=None):
        return jax.tree.map(lambda g: -SGD_LR * g, grads), grads

    return optax.GradientTransformation(lambda p: jax.tree.map(jnp.zeros_like, p), update)


def torch_sgd(params):
    return torch.optim.SGD(params, lr=SGD_LR)


# atol of a gradient leaf, as a share of its max |grad|. The f32 noise of
# either side sets it: with L1 losses against random targets, the decoder
# leaves' gradients are sums of many terms of random sign that cancel.
# Measured against a float64 run of the port on the same weights, the
# port's f32 GlobalPathway gradients are off by up to 6e-4 of a leaf's
# max, the JAX step's f32 G gradients by up to 1.2e-3; the two f32 sides
# differ by at most 1.07e-3 beyond rtol here. 1e-3 would sit inside that
# noise, so the bar is 2e-3 (the D gradients agree to 4e-7).
GRAD_ATOL_SHARE = 2e-3


def assert_grads_match(want: dict, got: dict, label: str, atol_share: float = GRAD_ATOL_SHARE):
    """Per-leaf gradients at rtol 2e-3 with atol ``atol_share`` x the
    leaf's max |grad|."""
    assert set(got) <= set(want), sorted(set(got) - set(want))
    for name, gt in got.items():
        gj = want[name]
        assert gj.shape == gt.shape, name
        scale = float(np.abs(gj).max())
        np.testing.assert_allclose(gt, gj, rtol=2e-3, atol=atol_share * scale + 1e-12,
                                   err_msg=f"{label} grad {name}")


# The G gradients' bar on data other than the single step's. There the f32
# noise of a leaf whose gradients nearly cancel reaches past
# GRAD_ATOL_SHARE: ROADMAP C3 found the worst G leaf 1.09e-2 of its max
# from a float64 run on both sides; at batch 4 (seeds 0-2) the plain step
# differs from JAX's beyond 2e-3 on a few elements of one leaf (seed 0:
# global_pathway.deconv_8, 8.8e-3 of its max of 3.1e-6, where the port's f32
# gradient of one microbatch is 1.06e-2 of it from the port's float64 one,
# in each loss term, and JAX's 2.6e-3). So leaves are held at 1.5e-2 of
# their max element by element, and all G leaves together to 2e-3 in
# relative L2 (each f32 side is about 3e-4 from float64 there, C3).
G_ANY_DATA_ATOL_SHARE = 1.5e-2
G_REL_L2 = 2e-3


def assert_g_grads_match_any_data(want: dict, got: dict, label: str):
    """G gradient leaves at rtol 2e-3, atol G_ANY_DATA_ATOL_SHARE x the
    leaf's max, and all of them together within G_REL_L2 in relative L2."""
    assert_grads_match(want, got, label, atol_share=G_ANY_DATA_ATOL_SHARE)
    gap = np.sqrt(sum(np.sum((np.float64(g) - want[n]) ** 2) for n, g in got.items()))
    rel = gap / np.sqrt(sum(np.sum(np.float64(want[n]) ** 2) for n in got))
    assert rel <= G_REL_L2, (label, rel)


def assert_metrics_match(got: dict, want: dict):
    """The dryrun_multichip bar: |got - ref| <= 1e-3 + 1e-3 |ref|."""
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, ref in want.items():
        assert abs(got[k] - ref) <= 1e-3 + 1e-3 * abs(ref), (k, got[k], ref)
