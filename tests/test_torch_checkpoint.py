"""The port's checkpoints (``tpgan_tpu_torch/train/checkpoint.py``), its
reference ``.pth`` import and its import of a whole JAX train state
(``tpgan_tpu_torch/convert.py::load_jax_gan_state``), on the CPU at
fm_multiplier 0.25 (the ``.pth`` import at full size, as the reference
names it):

* a save / restore round trip is bit-equal in every tensor of the state
  (parameters, BatchNorm statistics, both Adam states, the EMA) and the
  step, and the restored state then takes the same step as the original;
* ``latest_step``, ``max_to_keep``, asynchronous saves joined by
  ``finalize_checkpoints``, and the refusals;
* ``train.ema_decay`` switched on or off across a checkpoint, both ways,
  as ``tpgan_tpu``'s ``restore_gan_checkpoint`` documents it;
* ``import_generator_pth`` / ``import_discriminator_pth`` equal the JAX
  importers' trees carried through ``convert.py``, exactly, 72->75
  zero-extension included;
* a JAX state after one optax-Adam step, carried across, takes one more
  step beside JAX's (noise injected): metrics and the critic's Adam moments
  at the single step's tolerances, the generator's at the bar for data
  other than the single step's (``assert_g_grads_match_any_data``), the
  EMA, and the step count carried (one JAX compile).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.train.checkpoint import (
    import_discriminator_pth as jax_import_discriminator_pth,
    import_generator_pth as jax_import_generator_pth,
)
from tpgan_tpu.train.gan_trainer import GANTrainState as JGANTrainState
from tpgan_tpu.train.gan_trainer import make_gan_train_step as jax_make_gan_train_step
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import (
    jax_critic_params_to_state_dict,
    jax_generator_params_to_state_dict,
    load_jax_gan_state,
)
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.models.discriminator import Discriminator
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.train.checkpoint import (
    finalize_checkpoints,
    import_discriminator_pth,
    import_generator_pth,
    latest_step,
    restore_checkpoint,
    restore_gan_checkpoint,
    save_checkpoint,
)
from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

from _torch_train_parity import (
    Pair,
    assert_g_grads_match_any_data,
    assert_grads_match,
    assert_metrics_match,
    jax_as_port,
    overrides,
    tree_np,
)
from test_reference_checkpoint_import import RefDiscriminator, RefGenerator

torch.set_num_threads(1)


def _tensors(state) -> dict:
    """Every tensor of a port state, by name, and the step."""
    out = {"step": torch.tensor(state.step)}
    out.update({f"G.{k}": v for k, v in state.gen.state_dict().items()})
    out.update({f"D.{k}": v for k, v in state.disc.state_dict().items()})
    out.update({f"ema.{k}": v for k, v in state.g_ema_params.items()})
    for tag, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for i, per_param in opt.state_dict()["state"].items():
            out.update({f"{tag}.{i}.{k}": v for k, v in per_param.items()})
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _stepped_state(cfg, seed=0, steps=1):
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed, "cpu")
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    generator = torch.Generator().manual_seed(seed + 11)
    for i in range(steps):
        state, _ = step(state, synthetic_gan_batch(1, seed=i), generator)
    return state, step


def test_round_trip_is_bit_equal_and_steps_on_alike(tmp_path):
    cfg = make_config(overrides(use_batchnorm=True))
    state, step = _stepped_state(cfg)
    save_checkpoint(str(tmp_path), state.step, state)
    other, other_step = _stepped_state(cfg, seed=5, steps=0)
    assert restore_checkpoint(str(tmp_path), other) is other
    _assert_same(_tensors(other), _tensors(state))
    assert other.step == 1 and other.g_batch_stats and other.g_opt.state
    batch = synthetic_gan_batch(1, seed=9)
    state, m1 = step(state, batch, torch.Generator().manual_seed(4))
    other, m2 = other_step(other, batch, torch.Generator().manual_seed(4))
    _assert_same(_tensors(other), _tensors(state))
    _assert_same(m2, m1)


def test_latest_step_max_to_keep_and_async_saves(tmp_path):
    cfg = make_config(overrides())
    state, *_ = create_gan_state(cfg, 0, "cpu")
    d = str(tmp_path / "ckpt")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, state)
    for step in range(1, 8):
        save_checkpoint(d, step, state, block=step % 2 == 0)
    finalize_checkpoints(d)
    assert sorted(int(p.name) for p in (tmp_path / "ckpt").iterdir()) == [3, 4, 5, 6, 7]
    assert latest_step(d) == 7
    with pytest.raises(FileExistsError):
        save_checkpoint(d, 7, state)
    finalize_checkpoints(d)  # nothing left to join
    with torch.no_grad():
        next(state.gen.parameters()).add_(1.0)
    save_checkpoint(d, 8, state, block=False)
    finalize_checkpoints()  # every directory
    assert latest_step(d) == 8
    fresh, *_ = create_gan_state(cfg, 0, "cpu")
    restore_checkpoint(d, fresh, step=4)
    assert not torch.equal(next(fresh.gen.parameters()), next(state.gen.parameters()))
    restore_checkpoint(d, fresh)
    _assert_same(_tensors(fresh), _tensors(state))


def test_ema_switched_on_across_a_checkpoint(tmp_path):
    no_ema = make_config(overrides(train={"ema_decay": 0.0}))
    state, _ = _stepped_state(no_ema, steps=0)
    state.step = 1
    assert state.g_ema_params == {}
    save_checkpoint(str(tmp_path), 1, state)
    target, *_ = create_gan_state(make_config(overrides()), 5, "cpu")
    with pytest.raises(ValueError, match="EMA"):
        restore_checkpoint(str(tmp_path), target)
    restore_gan_checkpoint(str(tmp_path), target)
    _assert_same(target.gen.state_dict(), state.gen.state_dict())
    # the EMA starts from the restored live weights
    _assert_same(target.g_ema_params, dict(target.gen.named_parameters()))
    assert target.step == 1


def test_ema_switched_off_across_a_checkpoint(tmp_path):
    state, _ = _stepped_state(make_config(overrides()), steps=0)
    for t in state.g_ema_params.values():  # EMA weights apart from the live ones
        t.mul_(0.5)
    save_checkpoint(str(tmp_path), 1, state)
    target, *_ = create_gan_state(make_config(overrides(train={"ema_decay": 0.0})), 5, "cpu")
    with pytest.raises(ValueError, match="EMA"):
        restore_checkpoint(str(tmp_path), target)
    restore_gan_checkpoint(str(tmp_path), target)
    assert target.g_ema_params == {}  # dropped: evaluation scores the live weights
    _assert_same(target.gen.state_dict(), state.gen.state_dict())
    _assert_same(_tensors(target), {k: v for k, v in _tensors(state).items()
                                    if not k.startswith("ema.")})


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


@pytest.mark.parametrize("model", ["generator", "discriminator"])
def test_pth_import_equals_jax_import_carried_across(tmp_path, model):
    torch.manual_seed(0)
    ref = RefGenerator() if model == "generator" else RefDiscriminator()
    path = str(tmp_path / f"{model}.pth")
    torch.save(ref.state_dict(), path)
    g, d = make_config({}).G, make_config({}).D  # the GAN config: no BatchNorm
    if model == "generator":
        got = import_generator_pth(path)
        want = jax_generator_params_to_state_dict(jax_import_generator_pth(path)["params"])
        port = Generator(g.zdim, g.num_classes, use_batchnorm=g.use_batchnorm, device="meta")
    else:
        got = import_discriminator_pth(path)
        want = jax_critic_params_to_state_dict(jax_import_discriminator_pth(path)["params"])
        port = Discriminator(use_batchnorm=d.use_batchnorm, device="meta")
    got_np, want_np = _numpy(got), _numpy(want)
    assert got_np.keys() == want_np.keys()
    for k in want_np:
        assert got_np[k].dtype == want_np[k].dtype and np.array_equal(got_np[k], want_np[k]), k
    port.load_state_dict(got, strict=True, assign=True)  # every name and shape of the port
    if model == "generator":  # the 72 -> 75 healing: dead inputs and outputs
        w = got_np["global_pathway.add_128.conv0.conv.weight"]
        assert w.shape[:2] == (75, 75)
        assert not w[:, 72:75].any() and not w[72:75].any()
        assert not got_np["global_pathway.conv5_conv.conv.weight"][:, 136:139].any()


def _export(jstate) -> dict:
    """A JAX GANTrainState as the npz ``load_jax_gan_state`` reads."""
    def adam(opt_state):
        s = opt_state[0]  # optax.adam: (ScaleByAdamState, EmptyState)
        return {"mu": s.mu, "nu": s.nu, "count": s.count}

    tree = tree_np({
        "step": jstate.step, "g_params": jstate.g_params, "d_params": jstate.d_params,
        "g_batch_stats": jstate.g_batch_stats, "d_batch_stats": jstate.d_batch_stats,
        "g_ema_params": jstate.g_ema_params,
        "g_opt_state": adam(jstate.g_opt_state), "d_opt_state": adam(jstate.d_opt_state),
    })
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat["/".join(path)] = np.asarray(node)

    walk(tree, ())
    return flat


def test_jax_state_carried_across_steps_on_as_jax_does(tmp_path):
    pair = Pair(seed=4)
    t = pair.cfg.train
    tx = optax.adam(t.learning_rate, b1=t.beta1, b2=t.beta2)
    gp, dp = pair.g_params, pair.d_params
    s0 = JGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=gp, d_params=dp,
        g_opt_state=tx.init(gp), d_opt_state=tx.init(dp),
        g_ema_params=jax.tree.map(jnp.copy, gp),
    )
    step = jax.jit(jax_make_gan_train_step(pair.jcfg, pair.jgen, pair.jdisc, tx, tx))
    s1, _ = step(s0, pair.batch, jax.random.PRNGKey(99))
    s2, jax_metrics = step(s1, pair.batch, pair.rng)  # the rng of pair.noise
    s1_np, s2_np = tree_np(s1), tree_np(s2)

    np.savez(tmp_path / "jax_state.npz", **_export(s1))
    state, gen, disc, g_opt, d_opt = create_gan_state(pair.cfg, 0, "cpu")
    with np.load(tmp_path / "jax_state.npz") as arrays:
        load_jax_gan_state(arrays, state)
    assert state.step == 1
    # carried exactly: weights, EMA, Adam moments and count
    for side, model, opt, critic in (("g", gen, g_opt, False), ("d", disc, d_opt, True)):
        params = jax_as_port(getattr(s1_np, f"{side}_params"), critic)
        adam = getattr(s1_np, f"{side}_opt_state")[0]
        mu, nu = jax_as_port(adam.mu, critic), jax_as_port(adam.nu, critic)
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), params[n], err_msg=n)
            st = opt.state[p]
            assert float(st["step"]) == float(adam.count) == 1.0
            np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[n], err_msg=n)
            np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[n], err_msg=n)
    ema1 = jax_as_port(s1_np.g_ema_params)
    for n, e in state.g_ema_params.items():
        np.testing.assert_array_equal(e.numpy(), ema1[n], err_msg=n)

    port_step = make_gan_train_step(pair.cfg, gen, disc, g_opt, d_opt)
    state, metrics = port_step(state, pair.batch, torch.Generator().manual_seed(0), pair.noise)
    assert state.step == int(s2_np.step) == 2
    assert_metrics_match({k: float(v) for k, v in metrics.items()}, jax_metrics_host(jax_metrics))
    for side, model, opt, critic in (("g", gen, g_opt, False), ("d", disc, d_opt, True)):
        adam = getattr(s2_np, f"{side}_opt_state")[0]
        assert int(adam.count) == 2
        want_mu = jax_as_port(adam.mu, critic)
        want_rms = {k: np.sqrt(v) for k, v in jax_as_port(adam.nu, critic).items()}
        got_mu = {n: opt.state[p]["exp_avg"].numpy() for n, p in model.named_parameters()}
        got_rms = {n: opt.state[p]["exp_avg_sq"].sqrt().numpy()
                   for n, p in model.named_parameters()}
        assert all(float(opt.state[p]["step"]) == 2.0 for p in model.parameters())
        # step 2's moments: b1 m1 + (1 - b1) g2 and b2 v1 + (1 - b2) g2^2,
        # held as gradients are (sqrt of the second)
        check = assert_grads_match if critic else assert_g_grads_match_any_data
        check(want_mu, got_mu, f"{side} exp_avg")
        check(want_rms, got_rms, f"{side} sqrt(exp_avg_sq)")
    # the EMA moved by 0.01 of the updated weights, which differ by at most
    # two Adam steps of lr where a gradient sits within its f32 noise of 0
    ema2 = jax_as_port(s2_np.g_ema_params)
    for n, e in state.g_ema_params.items():
        np.testing.assert_allclose(e.numpy(), ema2[n], rtol=0,
                                   atol=0.02 * t.learning_rate + 1e-7, err_msg=n)


def jax_metrics_host(metrics) -> dict:
    return {k: float(v) for k, v in metrics.items()}
