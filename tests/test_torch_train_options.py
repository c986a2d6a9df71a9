"""The train step's options in the port against the JAX package, on the
CPU at fm_multiplier 0.25, float32:

* gradient accumulation (batch 4, 2 microbatches) against JAX's
  ``accum_train_step`` with its z, per-microbatch GP eps and dropout masks
  injected (``tests/_torch_train_parity.py``): every D gradient leaf at
  the single step's tolerances (``assert_grads_match``), every G leaf at
  the bar the plain step needs on batch-4 data
  (``assert_g_grads_match_any_data``), and every metric, each the mean
  over the microbatches, at its bar (``assert_metrics_match``); one JAX
  compile;
* rematerialisation on and off, for each scope, with BatchNorm on: the
  same gradients, metrics and running statistics, bit for bit, while the
  rematerialised modules really run again in the backward pass;
* the settings both packages refuse;
* ``make_multi_step`` on the CPU: K=2 steps are bit-equal to two single
  steps, and its metrics are stacked.
"""

import numpy as np
import pytest
import torch

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.train.gan_trainer import build_models as jax_build_models
from tpgan_tpu.train.gan_trainer import make_gan_train_step as jax_make_gan_train_step
from tpgan_tpu.train.optim import adam_wgan as jax_adam_wgan
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.train.gan_trainer import (
    create_gan_state,
    make_gan_train_step,
    make_multi_step,
)

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

ACCUM = 2


@pytest.fixture(scope="module")
def accum_steps():
    pair = Pair(batch=4, train={"grad_accum_steps": ACCUM})
    return pair, pair.jax_step(sgd), pair.port_step(torch_sgd)


def test_accum_noise_has_a_microbatch_axis(accum_steps):
    pair, _, _ = accum_steps
    assert pair.noise["z"].shape == (ACCUM, 2, pair.cfg.G.zdim)
    assert pair.noise["gp_eps"].shape == (ACCUM, 2, 1, 1, 1)
    for key in ("drop_mask_d", "drop_mask_g"):
        mask = pair.noise[key]
        assert mask.shape == (ACCUM, 2, 256) and 0 < mask.sum() < mask.size
        assert not np.array_equal(mask[0], mask[1])  # each microbatch its own rng


@pytest.mark.parametrize("model", ["d", "g"])
def test_accum_gradients_match_jax_accum_train_step(accum_steps, model):
    _, (_, ja, _), (tb, ta, _) = accum_steps
    critic = model == "d"
    # sgd() keeps the gradient it was handed as its state: JAX's mean of
    # the microbatch gradients
    want = jax_as_port(ja.d_opt_state if critic else ja.g_opt_state, critic)
    got = ta[f"{model}_grad"]
    assert got.keys() == tb[model].keys()
    if critic:
        assert_grads_match(want, got, "d (accumulated)")
    else:
        # batch 4's data: the plain step needs this bar too (see its note)
        assert_g_grads_match_any_data(want, got, "g (accumulated)")
    assert max(float(np.abs(g).max()) for g in got.values()) > 0


def test_accum_metrics_are_the_mean_over_microbatches_as_in_jax(accum_steps):
    _, (_, _, want), (_, _, got) = accum_steps
    assert_metrics_match(got, want)


def _bn_config(**train):
    return make_config(overrides(use_batchnorm=True, train=train))


def _step_record(cfg, batch):
    """One seeded step: (metrics, gradients, BN running stats, forward calls
    of the generator's and of the critic's first layer, statistics moved)."""
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
    # the first layer of each: a recompute stops once it has what the
    # backward needs, so the modules' own forward hooks never fire in it
    calls = {"g": 0, "d": 0}
    gen.global_pathway.conv0_conv.register_forward_hook(
        lambda *a: calls.__setitem__("g", calls["g"] + 1))
    disc.conv0.register_forward_hook(lambda *a: calls.__setitem__("d", calls["d"] + 1))
    stats0 = {k: v.clone() for k, v in {**state.g_batch_stats, **state.d_batch_stats}.items()}
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    state, metrics = step(state, batch, torch.Generator().manual_seed(3))
    named = [*gen.named_parameters(), *(("D." + n, p) for n, p in disc.named_parameters())]
    stats = {**{"G." + k: v for k, v in state.g_batch_stats.items()},
             **{"D." + k: v for k, v in state.d_batch_stats.items()}}
    moved = sum(not torch.equal(v, stats0[k.split(".", 1)[1]]) for k, v in stats.items())
    return metrics, {n: p.grad for n, p in named}, stats, calls, moved


@pytest.fixture(scope="module")
def plain_bn_step():
    return _step_record(_bn_config(), synthetic_gan_batch(1, seed=1))


@pytest.mark.parametrize("scope", ["generator", "critic", "both"])
def test_remat_gives_the_plain_steps_gradients_and_statistics(plain_bn_step, scope):
    metrics, grads, stats, calls, moved = plain_bn_step
    r_metrics, r_grads, r_stats, r_calls, _ = _step_record(
        _bn_config(remat=True, remat_scope=scope), synthetic_gan_batch(1, seed=1))
    assert moved > 0  # the plain step advanced the running statistics
    for k, v in metrics.items():
        assert torch.equal(r_metrics[k], v), k
    for n, g in grads.items():
        assert torch.equal(r_grads[n], g), n
    for k, v in stats.items():  # the recompute advanced nothing
        assert torch.equal(r_stats[k], v), k
    # the rematerialised module ran again in the backward pass
    assert (r_calls["g"] > calls["g"]) == (scope in ("generator", "both"))
    assert (r_calls["d"] > calls["d"]) == (scope in ("critic", "both"))


def test_jax_refuses_what_the_port_refuses():
    """The refusals of tests/test_torch_train_step.py, on the JAX side."""
    cfg = jax_make_config(overrides(train={"remat": True, "remat_scope": "decoder"}))
    gen, disc = jax_build_models(cfg)
    tx = jax_adam_wgan(1e-4)
    with pytest.raises(ValueError, match="remat_scope"):
        jax_make_gan_train_step(cfg, gen, disc, tx, tx)
    cfg = jax_make_config(overrides(train={"grad_accum_steps": 2}))
    step = jax_make_gan_train_step(cfg, gen, disc, tx, tx)
    with pytest.raises(ValueError, match="must divide the batch size 3"):
        step(None, synthetic_gan_batch(3, seed=1), None)


def test_multi_step_on_the_cpu_equals_single_steps():
    cfg = make_config(overrides())
    batches = [synthetic_gan_batch(1, seed=s) for s in (1, 2)]
    runs = []
    for k in (1, 2):
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
        generator = torch.Generator().manual_seed(7)
        if k == 1:
            history = []
            for b in batches:
                state, m = step(state, b, generator)
                history.append(m)
            metrics = {n: torch.stack([m[n] for m in history]) for n in history[0]}
        else:
            multi = make_multi_step(step, 2)
            super_batch = {n: np.stack([b[n] for b in batches]) for n in batches[0]}
            state, metrics = multi(state, super_batch, generator)
            assert multi.launches() is None  # nothing captured on the CPU
        opt_state = [v for opt in (g_opt, d_opt) for s in opt.state.values() for v in s.values()]
        runs.append((state.step, metrics, [p.detach() for p in state.gen.parameters()]
                     + [p.detach() for p in state.disc.parameters()]
                     + list(state.g_ema_params.values()), opt_state))
    (step1, m1, p1, o1), (step2, m2, p2, o2) = runs
    assert step1 == step2 == 2
    assert m1.keys() == m2.keys()
    for n in m1:
        assert m2[n].shape == (2,) and torch.equal(m1[n], m2[n]), n
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert len(o1) == len(o2) and all(torch.equal(a, b) for a, b in zip(o1, o2))
    with pytest.raises(ValueError, match="leading axes"):
        make_multi_step(step, 3)(state, super_batch, generator)
