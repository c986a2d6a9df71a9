"""The fused WGAN-GP step with the identity-preserving G-loss term on, on
the CPU at fm_multiplier 0.25, batch 2, float32 (the other step tests'
set-up, ``tests/_torch_train_parity.py``), through a ResNet18 embedder of
the configured width (128x128 input, 347 classes, fc0 256) carried from
JAX's numpy-drawn weights by ``convert.jax_embedder_variables_to_state_dict``:

* one D+G step against JAX's ``make_gan_train_step(..., identity_embed=
  make_identity_embed_fn(...))`` with the JAX noise injected and SGD on
  both sides: metrics at the ``dryrun_multichip`` bar
  (``assert_metrics_match``) with ``g_identity_preserving`` > 0 on both
  sides, the D gradients at the single step's bar and the G gradients at
  ``assert_g_grads_match_any_data``'s; the embedder frozen (no ``.grad``,
  no weight or BatchNorm statistic moved);
* the step's other forms with the term on, against the plain step from
  the same state and noise: gradient accumulation (2 microbatches of 1)
  at the metrics bar, the D gradients' bar and the G gradients' bar on
  other data (the step's own f32 noise between two summation orders puts
  one G leaf 1.2e-2 of its max apart, with the term or without), remat
  (both) to the last bits (rtol 1e-6), ``make_multi_step`` (on the CPU K
  eager steps) equal; and ``run_gan_training`` with ``identity_embed``
  for 2 steps.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpgan_tpu.models.feature_extract import FeatureExtractModel as JFeatureExtractModel
from tpgan_tpu.models.feature_extract import make_identity_embed_fn as jax_embed_fn
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import jax_embedder_variables_to_state_dict
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.models.feature_extract import FeatureExtractModel, make_identity_embed_fn
from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step, make_multi_step
from tpgan_tpu_torch.train.loop import run_gan_training
from tpgan_tpu_torch.train.metrics import MetricWriter

from _torch_port import init_numpy
from _torch_train_parity import (
    Pair,
    assert_g_grads_match_any_data,
    assert_grads_match,
    assert_metrics_match,
    jax_as_port,
    overrides,
    sgd,
    torch_sgd,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def embedder_variables():
    jmod = JFeatureExtractModel(base_model_name="resnet", num_of_output_classes=347)
    params, stats = init_numpy(jmod, jnp.zeros((1, 128, 128, 3)), seed=21)
    return jmod, {"params": params, "batch_stats": stats}


def _port_embedder(variables) -> FeatureExtractModel:
    model = FeatureExtractModel("resnet", 347, device="cpu")
    model.load_state_dict(jax_embedder_variables_to_state_dict(variables, "resnet"), strict=True)
    return model


def _assert_frozen(model, before):
    assert all(p.grad is None and not p.requires_grad for p in model.parameters())
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.fixture(scope="module")
def steps(embedder_variables):
    jmod, variables = embedder_variables
    pair = Pair(seed=0)
    jax_run = pair.jax_step(sgd, identity_embed=jax_embed_fn(jmod, variables))
    model = _port_embedder(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    port_run = pair.port_step(torch_sgd, identity_embed=make_identity_embed_fn(model))
    return jax_run, port_run, model, before


def test_identity_step_metrics_match_jax(steps):
    (_, _, want), (_, _, got), _, _ = steps
    assert want["g_identity_preserving"] > 0 and got["g_identity_preserving"] > 0
    assert np.isfinite(got["g_identity_preserving"])
    assert_metrics_match(got, want)


@pytest.mark.parametrize("model", ["d", "g"])
def test_identity_step_gradients_match_jax(steps, model):
    (_, ja, _), (_, ta, _), _, _ = steps
    critic = model == "d"
    want = jax_as_port(ja.d_opt_state if critic else ja.g_opt_state, critic)
    if critic:
        assert_grads_match(want, ta["d_grad"], "d")
    else:
        assert_g_grads_match_any_data(want, ta["g_grad"], "g")


def test_identity_step_leaves_the_embedder_frozen(steps):
    _, _, model, before = steps
    _assert_frozen(model, before)


# --------------------------------------------------------------------------
# the step's other forms, the port alone
# --------------------------------------------------------------------------

def _run(embedder_variables, train=None):
    """One port step from seed-0 models with the identity term on, the same
    batch and noise in every call: (metrics, G and D gradients)."""
    cfg = make_config(overrides(train=train))
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
    model = _port_embedder(embedder_variables[1])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, make_identity_embed_fn(model))
    generator = torch.Generator().manual_seed(3)
    noise = {"z": torch.randn((2, cfg.G.zdim), generator=generator),
             "gp_eps": torch.rand((2, 1, 1, 1), generator=generator),
             "drop_mask_d": torch.rand((2, 256), generator=generator) < 0.7,
             "drop_mask_g": torch.rand((2, 256), generator=generator) < 0.7}
    accum = int((train or {}).get("grad_accum_steps", 1))
    if accum > 1:
        noise = {k: v.reshape(accum, 2 // accum, *v.shape[1:]) for k, v in noise.items()}
    state, metrics = step(state, synthetic_gan_batch(2, seed=40), generator, noise)
    _assert_frozen(model, before)
    grads = {f"{m}.{n}": p.grad.numpy().copy()
             for m, mod in (("g", gen), ("d", disc)) for n, p in mod.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def plain(embedder_variables):
    return _run(embedder_variables)


def test_identity_term_under_gradient_accumulation(embedder_variables, plain):
    metrics, grads = _run(embedder_variables, train={"grad_accum_steps": 2})
    assert metrics["g_identity_preserving"] > 0
    assert_metrics_match(metrics, plain[0])
    g = lambda d, side: {k: v for k, v in d.items() if k.startswith(side)}
    assert_grads_match(g(plain[1], "d."), g(grads, "d."), "accum d")
    # the G leaves' f32 noise between the two summation orders is the step's
    # own, identity term or not (global_pathway.conv4_res1.conv1 at 1.2e-2 of
    # its max either way): the bar of G gradients on other data
    assert_g_grads_match_any_data(g(plain[1], "g."), g(grads, "g."), "accum g")


def test_identity_term_under_remat(embedder_variables, plain):
    metrics, grads = _run(embedder_variables, train={"remat": True, "remat_scope": "both"})
    for k, v in plain[0].items():
        assert metrics[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    for k, v in plain[1].items():
        np.testing.assert_allclose(grads[k], v, rtol=1e-6, atol=1e-6 * np.abs(v).max(),
                                   err_msg=k)


def test_identity_term_through_multi_step(embedder_variables):
    """On the CPU ``make_multi_step`` runs its K steps eagerly, drawing the
    noise from the generator as the plain step does."""
    cfg = make_config(overrides())
    runs = []
    for multi in (False, True):
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
        embed = make_identity_embed_fn(_port_embedder(embedder_variables[1]))
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, embed)
        batches = [synthetic_gan_batch(2, seed=50 + i) for i in range(2)]
        generator = torch.Generator().manual_seed(4)
        if multi:
            state, metrics = make_multi_step(step, 2)(
                state, {k: np.stack([b[k] for b in batches]) for k in batches[0]}, generator)
            history = [{k: float(v[i]) for k, v in metrics.items()} for i in range(2)]
        else:
            history = [{k: float(v) for k, v in step(state, b, generator)[1].items()}
                       for b in batches]
        assert state.step == 2
        runs.append((history, [p.detach().clone() for p in gen.parameters()]))
    (h0, p0), (h1, p1) = runs
    assert h0 == h1 and all(m["g_identity_preserving"] > 0 for m in h1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_run_gan_training_with_an_identity_embedder(embedder_variables, tmp_path):
    cfg = make_config(overrides())
    model = _port_embedder(embedder_variables[1])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    writer = MetricWriter(str(tmp_path), use_tensorboard=False)
    state = run_gan_training(cfg, (synthetic_gan_batch(2, seed=60 + i) for i in range(4)),
                             steps=2, identity_embed=make_identity_embed_fn(model),
                             writer=writer, log_every=1, device="cpu")
    writer.close()
    assert state.step == 2
    logged = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [m["step"] for m in logged] == [1, 2]
    assert all(m["g_identity_preserving"] > 0 and np.isfinite(m["g_loss"]) for m in logged)
    _assert_frozen(model, before)
