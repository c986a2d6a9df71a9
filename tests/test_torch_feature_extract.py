"""The port's embedder training (``tpgan_tpu_torch.train.feature_extract``)
and optimizer factory (``train.optim.get_optimizer``, ``multistep_lr``)
against the JAX package on the CPU:

* every optimizer name (and the SGD fallback) against its optax
  transform over 3 steps with weight decay, on gradients from 1e-5 to 1
  (small enough that eps inside or outside the square root tells apart):
  parameters at rtol 1e-5, atol 3e-6 (3e-5 of the learning rate: optax
  rounds Adam's bias correction 1 - 0.999^t in f32, 1.3e-5 off, which
  moves its update by ~6e-7 per step; eps inside the square root or
  outside, or Adagrad's accumulator starting at 0, moves these
  parameters by 1e-2 and more);
* ``multistep_lr`` against ``optax.piecewise_constant_schedule``: the
  rate of each update, exactly up to f32;
* ``augment_batch`` with JAX's draws injected: within 1e-6;
* two ``make_feature_extract_step`` steps of each backbone against JAX's
  jitted step, with JAX's augmentation draws and (MobileNetV2) dropout
  masks injected: loss and accuracy, the parameters' movement and the
  BatchNorm statistics, under the bars of ``STEP_CASES`` (set from a
  float64 run, below);
* ``evaluate_embedder_identity`` against JAX's: within 1e-4;
* ``held_out_subject_split`` + ``load_val_data`` against the split that
  ``cmd_train_embedder`` makes: equal lists, labels and images;
* ``run_feature_extract_training``: metrics written, validation, and a
  checkpoint that reloads bit for bit.
"""

import argparse
import os
from unittest import mock

import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

from tpgan_tpu.config import OptimizerConfig as JOptimizerConfig
from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.models.feature_extract import FeatureExtractModel as JFeatureExtractModel
from tpgan_tpu.train import feature_extract as jfx
from tpgan_tpu.train.optim import get_optimizer as jax_get_optimizer
from tpgan_tpu.train.optim import multistep_lr as jax_multistep_lr
from tpgan_tpu_torch.config import OptimizerConfig, make_config
from tpgan_tpu_torch.convert import jax_embedder_variables_to_state_dict
from tpgan_tpu_torch.data.imageio import write_png
from tpgan_tpu_torch.models.feature_extract import FeatureExtractModel
from tpgan_tpu_torch.models.feature_extract import build_feature_extract_model
from tpgan_tpu_torch.train.checkpoint import restore_model_variables
from tpgan_tpu_torch.train.feature_extract import (
    FeatureExtractState,
    augment_batch,
    draw_augment,
    evaluate_embedder_identity,
    held_out_subject_split,
    load_val_data,
    make_feature_extract_step,
    run_feature_extract_training,
)
from tpgan_tpu_torch.train.optim import OptaxAdagrad, OptaxRMSprop, get_optimizer, multistep_lr

from _torch_port import init_numpy, nchw

torch.set_num_threads(1)


def _images(shape, seed):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(np.float32)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,kind", [
    ("sgd", torch.optim.SGD), ("adam", torch.optim.Adam), ("rmsprop", OptaxRMSprop),
    ("adagrad", OptaxAdagrad), ("adadelta", torch.optim.Adadelta), ("nadam", torch.optim.SGD),
])
def test_get_optimizer_matches_optax_over_three_steps(name, kind):
    rng = np.random.RandomState(0)
    shapes = [(4, 3, 3, 3), (7,), (5, 2)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[(rng.standard_normal(s) * 10.0 ** rng.uniform(-5, 0, s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    hp = dict(learning_rate=0.1, momentum=0.9, nesterov=True, weight_decay=0.05)
    tx = jax_get_optimizer(name, JOptimizerConfig(**hp))
    params = [jnp.asarray(p) for p in p0]
    state = tx.init(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = get_optimizer(name, tparams, OptimizerConfig(**hp))
    assert type(opt) is kind
    for g in grads:
        updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
        params = optax.apply_updates(params, updates)
        for p, x in zip(tparams, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    for got, want, start in zip(tparams, params, p0):
        want = np.asarray(want)
        assert not np.allclose(want, start)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=3e-6)


@pytest.mark.parametrize("milestones", [(1, 3), (3, 3, 2)])
def test_multistep_lr_matches_optax_schedule(milestones):
    base, gamma, per_epoch = 0.5, 0.1, 2
    schedule = jax_multistep_lr(base, milestones, gamma, per_epoch)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=base)
    sched = multistep_lr(opt, milestones, gamma, per_epoch)
    for count in range(10):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(schedule(count)), rtol=1e-6)
        opt.step()
        sched.step()


# --------------------------------------------------------------------------
# augmentation
# --------------------------------------------------------------------------

def _jax_draws(rng, b):
    """``jfx.augment_batch``'s draws from ``rng``, in its order."""
    flip_rng, shift_rng, bright_rng, contrast_rng = jax.random.split(rng, 4)
    return {  # np.array: writable copies for torch
        "flip": np.array(jax.random.bernoulli(flip_rng, 0.5, (b, 1, 1, 1))).reshape(b),
        "offsets": np.array(jax.random.randint(shift_rng, (b, 2), 0, 9)),
        "brightness": np.array(jax.random.uniform(
            bright_rng, (b, 1, 1, 1), minval=-0.1, maxval=0.1)).reshape(b),
        "contrast": np.array(jax.random.uniform(
            contrast_rng, (b, 1, 1, 1), minval=0.9, maxval=1.1)).reshape(b),
    }


def test_augment_batch_with_jax_draws_matches_jax():
    x = _images((6, 20, 24, 3), 0)
    rng = jax.random.PRNGKey(3)
    draws = _jax_draws(rng, 6)
    assert 0 < draws["flip"].sum() < 6 and len(set(map(tuple, draws["offsets"]))) > 1
    want = np.asarray(jfx.augment_batch(rng, jnp.asarray(x)))
    got = augment_batch(torch.from_numpy(nchw(x)), draws).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_draw_augment_ranges():
    d = draw_augment(4096, torch.Generator().manual_seed(0))
    assert d["flip"].dtype == torch.bool and 0.45 < d["flip"].float().mean() < 0.55
    assert int(d["offsets"].min()) == 0 and int(d["offsets"].max()) == 8
    assert -0.1 <= float(d["brightness"].min()) and float(d["brightness"].max()) < 0.1
    assert 0.9 <= float(d["contrast"].min()) and float(d["contrast"].max()) < 1.1


# --------------------------------------------------------------------------
# the step
# --------------------------------------------------------------------------

def _jax_dropout_mask(jmod, variables, images, rng):
    """The keep-mask JAX's Dropout draws from ``rng`` in a train-mode apply
    (``y != 0``; the pooled RELU6 features it drops are never negative, and
    where one is 0 keeping or dropping it gives the same 0)."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            seen["y"] = out
        return out

    @jax.jit
    def keep(variables, images, rng):
        with fnn.intercept_methods(grab):
            jmod.apply(variables, images, use_dropout=True, train=True,
                       mutable=["batch_stats"], rngs={"dropout": rng})
        return seen["y"] != 0

    return np.array(keep(variables, images, rng))


# Per backbone: input size, learning rate, the steps after which the
# parameters' movement is held, its bars, and each step's loss and
# accuracy bars. The bars come from a float64 run of the port on the same
# weights, batches, draws and masks (BatchNorm and the input cast taken to
# float64). After two ResNet18 steps the port's f32 movement is 1.0e-3
# from it in relative L2 over all leaves (worst element 1.4e-2 of its
# leaf's max), JAX's 5.3e-3 (worst element 4.6e-2, beyond 7e-2 with other
# labels: its train-mode BatchNorm takes E[x^2] - E[x]^2 over 4 items at
# the fc0), so leaves are held in relative L2, not element by element. The
# seeded MobileNetV2 is ill-conditioned in f32 on both sides: one step
# leaves both 1.5-1.7e-2 from float64 in relative L2 (worst leaf 0.19), and
# a second step at lr 1e-2 amplifies that to 0.56 (its second loss 5% off
# float64 on both sides). So its movement is held after one step; at lr
# 1e-4 its second loss is 5e-4 (port) and 1.0e-3 (JAX) relative from
# float64, and its second accuracy may differ by one of the 4 items (an
# argmax at a near-tie).
STEP_CASES = {
    "resnet": dict(size=32, lr=1e-2, held_after=2, rel_l2=1e-2, leaf_rel_l2=5e-2,
                   loss_tol=(1e-4, 1e-4), acc_tol=(0.0, 0.0)),
    "mobilenetv2": dict(size=64, lr=1e-4, held_after=1, rel_l2=3e-2, leaf_rel_l2=None,
                        loss_tol=(1e-4, 2e-3), acc_tol=(0.0, 0.25)),
}


def _rel_l2(got, want) -> float:
    den = float(np.sum(np.float64(want) ** 2))
    return float(np.sqrt(np.sum((np.float64(got) - want) ** 2) / den)) if den else 0.0


def _movement_gap(got: dict, want: dict, p0: dict, case: dict) -> None:
    """The parameters' movement from ``p0``: all leaves together, and
    (``leaf_rel_l2``) each leaf alone, in relative L2."""
    moves = {n: (got[n] - p0[n], want[n] - p0[n]) for n in p0}
    total = _rel_l2(np.concatenate([g.ravel() for g, _ in moves.values()]),
                    np.concatenate([w.ravel() for _, w in moves.values()]))
    assert total <= case["rel_l2"], total
    if case["leaf_rel_l2"] is not None:
        for name, (g, w) in moves.items():
            assert _rel_l2(g, w) <= case["leaf_rel_l2"], (name, _rel_l2(g, w))


@pytest.mark.parametrize("base", sorted(STEP_CASES))
def test_two_feature_extract_steps_match_jax(base):
    case = STEP_CASES[base]
    size = case["size"]
    ov = {"feature_extract_model": {"base_model_name": base, "num_of_output_classes": 6},
          "optimizer_param": {"learning_rate": case["lr"]}}
    jcfg, cfg = jax_make_config(ov), make_config(ov)
    jmod = JFeatureExtractModel(base_model_name=base, num_of_output_classes=6, accum_f32=False)
    x = _images((2, 4, size, size, 3), 1)
    labels = np.asarray([[0, 3, 5, 3], [1, 1, 4, 2]], np.int32)
    params, stats = init_numpy(jmod, jnp.asarray(x[0, :1]), seed=2)
    tx = jax_get_optimizer(jcfg.pretrain.optimizer, jcfg.optimizer_param)
    jstate = jfx.FeatureExtractState(step=jnp.zeros((), jnp.int32), params=params,
                                     batch_stats=stats, opt_state=tx.init(params))
    jstep = jax.jit(jfx.make_feature_extract_step(jmod, tx))

    model = FeatureExtractModel(base, 6, device="cpu")
    model.load_state_dict(jax_embedder_variables_to_state_dict(
        {"params": params, "batch_stats": stats}, base), strict=True)
    opt = get_optimizer(cfg.pretrain.optimizer, model.parameters(), cfg.optimizer_param)
    state = FeatureExtractState(0, model, opt)
    step = make_feature_extract_step(model, opt)
    p0 = {k: v.detach().clone().numpy() for k, v in model.named_parameters()}

    rng = jax.random.PRNGKey(7)
    for i in range(2):
        rng, srng = jax.random.split(rng)
        aug_rng, drop_rng = jax.random.split(srng)
        draws = _jax_draws(aug_rng, 4)
        mask = None
        if base == "mobilenetv2":
            aug = jfx.augment_batch(aug_rng, jnp.asarray(x[i]))
            mask = torch.from_numpy(_jax_dropout_mask(
                jmod, {"params": jstate.params, "batch_stats": jstate.batch_stats}, aug,
                drop_rng))
            assert 0 < int(mask.sum()) < mask.numel()
        jstate, jm = jstep(jstate, x[i], labels[i], srng)
        state, m = step(state, x[i], labels[i], torch.Generator(), draws=draws, drop_mask=mask)
        ref = float(jm["loss"])
        assert abs(float(m["loss"]) - ref) <= case["loss_tol"][i] * abs(ref) + 1e-5, (i, ref)
        acc = float(jm["accuracy"])
        assert abs(float(m["accuracy"]) - acc) <= case["acc_tol"][i] + 1e-6, (i, acc)
        if i + 1 != case["held_after"]:
            continue
        want = {k: v.numpy() for k, v in jax_embedder_variables_to_state_dict(
            jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats}),
            base).items()}
        _movement_gap({k: v.detach().numpy() for k, v in model.named_parameters()}, want, p0,
                      case)
        for name, buf in model.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                scale = float(np.abs(want[name]).max())
                np.testing.assert_allclose(buf.numpy(), want[name], rtol=2e-3,
                                           atol=2e-4 * scale, err_msg=name)
    assert state.step == 2 and int(jstate.step) == 2


def test_evaluate_embedder_identity_matches_jax():
    jmod = JFeatureExtractModel(base_model_name="resnet", num_of_output_classes=6)
    probes, gallery = _images((5, 32, 32, 3), 3), _images((3, 32, 32, 3), 4)
    probes[1] = gallery[2]  # one exact hit
    p_lbl, g_lbl = np.asarray([7, 9, 8, 7, 4], np.int32), np.asarray([7, 8, 9], np.int32)
    params, stats = init_numpy(jmod, jnp.asarray(probes[:1]), seed=5)
    jstate = jfx.FeatureExtractState(step=jnp.zeros((), jnp.int32), params=params,
                                     batch_stats=stats, opt_state=None)
    want = jfx.evaluate_embedder_identity(jmod, jstate, probes, p_lbl, gallery, g_lbl, chunk=2)
    model = FeatureExtractModel("resnet", 6, device="cpu")
    model.load_state_dict(jax_embedder_variables_to_state_dict(
        {"params": params, "batch_stats": stats}, "resnet"), strict=True)
    model.train()
    got = evaluate_embedder_identity(model, probes, p_lbl, gallery, g_lbl, chunk=2)
    assert model.training  # the mode is put back
    assert got["val_probes"] == want["val_probes"] == 5
    assert got["val_rank1"] == pytest.approx(want["val_rank1"], abs=1e-6)
    assert got["val_identity_sim"] == pytest.approx(want["val_identity_sim"], abs=1e-4)


# --------------------------------------------------------------------------
# the split and the run
# --------------------------------------------------------------------------

def _identity_tree(root, subjects=5, cameras=("050", "051", "041")):
    rng = np.random.RandomState(0)
    paths = []
    for s in subjects if isinstance(subjects, list) else range(subjects):
        for cam in cameras:
            path = os.path.join(root, f"{s:03d}_01_{cam}_00.png")
            write_png(path, rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
            paths.append(path)
    return paths


def test_held_out_subject_split_matches_cmd_train_embedder(tmp_path):
    from tpgan_tpu import cli as jcli

    paths = _identity_tree(str(tmp_path), subjects=[3, 11, 0, 7, 5])
    paths.append(paths.pop(4))  # an order that is not sorted
    list_file = tmp_path / "img.list"
    list_file.write_text("\n".join(paths) + "\n")
    seen = {}

    def fake_iterator(ds, *a, **kw):
        seen["train"] = list(ds.img_list)
        return iter(())

    args = argparse.Namespace(set=[], checkpoint=str(tmp_path / "ck"), img_list=str(list_file),
                              steps=1, batch_size=2, log_dir=str(tmp_path / "log"),
                              val_subjects=2, val_every=500, no_augment=False)
    with mock.patch("tpgan_tpu.data.pipeline.batch_iterator", fake_iterator), \
            mock.patch("tpgan_tpu.train.metrics.MetricWriter"), \
            mock.patch("tpgan_tpu.train.feature_extract.run_feature_extract_training",
                       lambda *a, **kw: seen.update(val=kw["val_data"])):
        assert jcli.cmd_train_embedder(args) == 0
    train, split = held_out_subject_split(paths, 2)
    assert train == seen["train"]
    assert [os.path.basename(p)[:3] for p in split["gallery_paths"]] == ["007", "011"]
    got = load_val_data(split)
    for k, want in seen["val"].items():
        np.testing.assert_array_equal(got[k], want, err_msg=k)
    with pytest.raises(ValueError, match="n >= 1"):
        held_out_subject_split(paths, 0)


class _Writer:
    def __init__(self):
        self.lines = []

    def write(self, step, metrics):
        self.lines.append((step, {k: float(v) for k, v in metrics.items()}))


def test_run_feature_extract_training_and_checkpoint_round_trip(tmp_path):
    cfg = make_config({"feature_extract_model": {"num_of_output_classes": 6}})
    rng = np.random.RandomState(0)
    batches = iter([(_images((4, 32, 32, 3), i), rng.randint(0, 6, 4).astype(np.int32))
                    for i in range(12)])
    val = {"probe_images": _images((4, 32, 32, 3), 20), "probe_labels": np.asarray([0, 1, 2, 0]),
           "gallery_images": _images((3, 32, 32, 3), 21), "gallery_labels": np.asarray([0, 1, 2])}
    writer = _Writer()
    state = run_feature_extract_training(cfg, batches, steps=10, writer=writer, seed=3,
                                         checkpoint_dir=str(tmp_path / "ck"), val_data=val,
                                         val_every=5, device="cpu")
    assert state.step == 10
    assert [s for s, _ in writer.lines] == [5, 10, 10, 10]
    assert all(np.isfinite(v) for _, m in writer.lines for v in m.values())
    assert set(writer.lines[1][1]) == {"loss", "accuracy"}
    assert set(writer.lines[-1][1]) == {"val_rank1", "val_identity_sim", "val_probes"}
    fresh = build_feature_extract_model(cfg, "cpu", seed=4)
    assert restore_model_variables(str(tmp_path / "ck"), fresh) == 10
    want = state.model.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in fresh.state_dict().items())
    moved = build_feature_extract_model(cfg, "cpu", seed=3).state_dict()
    assert not torch.equal(moved["base.fc.weight"], want["base.fc.weight"])
    assert not torch.equal(moved["base.conv1.bn.running_mean"], want["base.conv1.bn.running_mean"])
