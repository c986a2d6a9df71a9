"""The port's fused WGAN-GP train step against the JAX package's
``make_gan_train_step`` on the CPU, at fm_multiplier 0.25
(local_feature_layer_dim 16), batch 2, float32, with the JAX step's z, GP
eps and dropout masks injected (``tests/_torch_train_parity.py``):

* one step with SGD(1e-2) on both sides: every D and G gradient leaf at
  rtol 2e-3, atol 2e-3 x the leaf's max |grad| (the f32 noise of both
  sides, measured against a float64 run: see GRAD_ATOL_SHARE), and each
  side's update is p' = p - 1e-2 g;
* one step with the default Adam: every metric within 1e-3 + 1e-3 |ref|
  (the ``dryrun_multichip`` bar, ``__graft_entry__.py:143``), the G
  gradients at the SGD step's tolerance, and the EMA's movement in the
  step (~1e-6 per element) to a few ulp of the weights, beyond what the
  two sides' gradients set apart;
* the optimizer alone, and the step's small cases.

The BatchNorm variant of the step is in tests/test_torch_train_step_bn.py
(one JAX compile per file, so the xdist workers share the cost).
"""

import numpy as np
import optax
import pytest
import torch

from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.train.gan_trainer import (
    create_gan_state,
    decode_u8_batch,
    eval_g_params,
    make_gan_train_step,
    make_multi_step,
)
from tpgan_tpu_torch.train.optim import adam_wgan

from _torch_train_parity import (
    SGD_LR,
    Pair,
    assert_grads_match,
    assert_metrics_match,
    jax_as_port,
    sgd,
    torch_sgd,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pair():
    return Pair(use_batchnorm=False, seed=0)


@pytest.fixture(scope="module")
def sgd_steps(pair):
    return pair.jax_step(sgd), pair.port_step(torch_sgd)


@pytest.fixture(scope="module")
def adam_steps(pair):
    cfg = pair.cfg.train
    return (
        pair.jax_step(lambda: optax.adam(cfg.learning_rate, b1=cfg.beta1, b2=cfg.beta2)),
        pair.port_step(lambda ps: adam_wgan(ps, cfg.learning_rate, cfg.beta1, cfg.beta2)),
    )


def test_injected_dropout_masks_are_jax_draws(pair):
    for key in ("drop_mask_d", "drop_mask_g"):
        mask = pair.noise[key]
        assert mask.shape == (2, 256) and mask.dtype == np.bool_
        # keep probability 0.7: both masks keep some and drop some
        assert 0 < mask.sum() < mask.size
    assert not np.array_equal(pair.noise["drop_mask_d"], pair.noise["drop_mask_g"])


@pytest.mark.parametrize("model", ["d", "g"])
def test_sgd_step_gradients_match_jax(pair, sgd_steps, model):
    (jb, ja, _), (tb, ta, _) = sgd_steps
    critic = model == "d"
    opt_state = ja.d_opt_state if critic else ja.g_opt_state  # the recorded grads
    want = jax_as_port(opt_state, critic)
    got = ta[f"{model}_grad"]
    assert got.keys() == tb[model].keys()
    assert_grads_match(want, got, model)
    for name, g in got.items():
        np.testing.assert_allclose(ta[model][name], tb[model][name] - SGD_LR * g,
                                   rtol=1e-6, atol=1e-9, err_msg=name)
    assert max(float(np.abs(g).max()) for g in got.values()) > 0


def test_sgd_step_metrics_match_jax(sgd_steps):
    (_, _, want), (_, _, got) = sgd_steps
    assert_metrics_match(got, want)
    assert got["g_identity_preserving"] == 0.0


def _adam_first_step(g):
    """Adam's first update over -lr, bias-corrected: g / (|g| + eps)."""
    g = g.astype(np.float64)
    return g / (np.abs(g) + 1e-8)


def test_adam_step_metrics_and_ema_match_jax(pair, adam_steps):
    (_, ja, want), (tb, ta, got) = adam_steps
    assert_metrics_match(got, want)
    cfg = pair.cfg.train
    # the G gradients of the Adam step (taken against the Adam-updated
    # critic), from JAX's first moment (1 - b1) g
    g_j = {k: v / (1 - cfg.beta1)
           for k, v in jax_as_port(ja.g_opt_state[0].mu).items()}
    assert_grads_match(g_j, ta["g_grad"], "g (Adam step)")
    # The EMA starts at p0 and moves by 0.01 (p' - p0) = -0.01 lr g/(|g|+eps):
    # about 1e-6, as close as p0 alone is to the EMA. So the movement is
    # held: the two sides' moves differ by no more than Adam's first step
    # on their two gradients (held above) does, plus a few ulp of the
    # weights (~1e-8). Where a gradient is within its f32 noise of 0 the
    # two steps may take opposite signs; that is the spread allowed there.
    step = 0.01 * cfg.learning_rate
    ema_j = jax_as_port(ja.g_ema_params)
    n_held = n_total = 0
    for name, ema in ta["ema"].items():
        p0, p1 = tb["g"][name], ta["g"][name]
        ulp = np.spacing(np.maximum(np.abs(p0), np.abs(ema)))
        # the port's EMA is the lerp of its own update, to rounding
        lerp = 0.99 * p0.astype(np.float64) + 0.01 * p1.astype(np.float64)
        assert np.all(np.abs(ema - lerp) <= 2 * ulp), name
        spread = step * np.abs(_adam_first_step(ta["g_grad"][name])
                               - _adam_first_step(g_j[name]))
        err = np.abs((ema - p0) - (ema_j[name] - p0))
        assert np.all(err <= spread + 1e-3 * step + 4 * ulp), name
        n_held += int((spread < 0.1 * step).sum())
        n_total += ema.size
    # nearly every element's move is held to within a tenth of its size
    assert n_held >= 0.9 * n_total, (n_held, n_total)


def test_adam_matches_optax_adam_alone():
    rng = np.random.RandomState(0)
    shapes = [(4, 3, 3, 3), (7,), (5, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes] for _ in range(3)]
    tx = optax.adam(1e-4, b1=0.5, b2=0.9)
    pj, sj = list(p0), tx.init(list(p0))
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = adam_wgan(params, 1e-4, 0.5, 0.9)
    for g in grads:
        upd, sj = tx.update(g, sj, pj)
        pj = optax.apply_updates(pj, upd)
        for p, gi in zip(params, g):
            p.grad = torch.from_numpy(gi)
        opt.step()
    for p, want in zip(params, pj):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)


def test_decode_u8_batch_is_endpoint_exact():
    v = np.array([[0, 1, 127, 128, 254, 255]], np.uint8)
    out = decode_u8_batch({"img": v, "label": np.array([3], np.int32)})
    got = out["img"].numpy()
    assert out["img"].dtype == torch.float32
    assert got[0, 0] == -1.0 and got[0, -1] == 1.0
    np.testing.assert_array_equal(got, ((2.0 * v.astype(np.float32) - 255.0) / 255.0))
    assert out["label"].dtype == np.int32  # other leaves pass through


SMALL = {"G": {"fm_multiplier": 0.25, "local_feature_layer_dim": 16},
         "D": {"fm_multiplier": 0.25}, "compute_dtype": "float32"}


def _bad_remat_scope():
    cfg = make_config(dict(SMALL, train={"remat": True, "remat_scope": "decoder"}))
    _state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
    make_gan_train_step(cfg, gen, disc, g_opt, d_opt)


def _accum_not_dividing_the_batch():
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch

    cfg = make_config(dict(SMALL, train={"grad_accum_steps": 2}))
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    step(state, synthetic_gan_batch(3, seed=1), torch.Generator().manual_seed(0))


@pytest.mark.parametrize("refused,match", [
    (_bad_remat_scope, "remat_scope"),
    (_accum_not_dividing_the_batch, "must divide the batch size 3"),
    (lambda: make_multi_step(None, 0), "num_steps >= 1"),
    (lambda: make_multi_step(None, -2), "num_steps >= 1"),
], ids=["bad_remat_scope", "accum_not_dividing_batch", "zero_steps", "negative_steps"])
def test_the_step_options_refuse_bad_settings(refused, match):
    with pytest.raises(ValueError, match=match):
        refused()


def test_eval_g_params_selects_ema_or_live():
    state, *_ = create_gan_state(make_config(SMALL), 0, "cpu")
    assert eval_g_params(state) is state.g_ema_params
    assert eval_g_params(state, "live").keys() == state.g_ema_params.keys()
    no_ema, *_ = create_gan_state(make_config(dict(SMALL, train={"ema_decay": 0.0})), 0, "cpu")
    assert eval_g_params(no_ema).keys() == no_ema.g_params.keys()
    with pytest.raises(ValueError, match="no EMA"):
        eval_g_params(no_ema, "ema")
    with pytest.raises(ValueError, match="auto|ema|live"):
        eval_g_params(state, "best")


def test_seeded_steps_are_reproducible_and_draw_from_the_generator():
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch

    cfg = make_config(SMALL)
    batch = synthetic_gan_batch(2, seed=1)
    runs = []
    for seed in (5, 5, 6):
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, 0, "cpu")
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
        _, metrics = step(state, batch, torch.Generator().manual_seed(seed))
        runs.append({k: float(v) for k, v in metrics.items()})
    assert runs[0] == runs[1]
    assert runs[0]["d_gradient_penalty"] != runs[2]["d_gradient_penalty"]
    assert all(np.isfinite(v) for v in runs[0].values())
    assert state.step == 1
