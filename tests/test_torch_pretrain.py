"""The port's landmark pretraining (``tpgan_tpu_torch/train/pretrain.py``,
the pretrain state in ``train/checkpoint.py``, ``entry.pretrain_entry``)
against the JAX package on the CPU:

* one pretrain step against JAX's jitted step and against the port's
  float64 step (BatchNorm and the loss in float64: the truth of both f32
  sides), both head modes, f32 and uint8 batches (128x128, batch 4, the
  same numpy weights, JAX's uniforms injected). The loss's assignment
  and background subsample first: the port's equal the float64 run's,
  and JAX's differ from them only where JAX's own f32 forward leaves the
  truth (its train-mode BatchNorm takes E[x^2] - E[x]^2: on the rendered
  corpus its forward is 4.9e-4 off the float64 one where the port's is
  2.6e-5, and one anchor at label 1's threshold flips). Then the loss
  and its parts within rtol 1e-5 of the float64 run and of JAX's by
  twice JAX's own distance from it, the accuracy within 1e-6, the
  BatchNorm statistics within rtol 2e-3, atol 2e-4 x each one's largest
  of JAX's, and the parameters' movement in relative L2 over all leaves:
  the port's within 2.5e-2 of the float64 run's (measured 1.8e-4 -
  1.24e-2: the seeded MobileNetV2 is ill-conditioned in f32), JAX's
  within 0.15 of it (measured 1.69e-2 - 7.07e-2), the port the nearer
  of the two in every case, and the port within the sum of both of
  JAX's;
* the eval step's metrics (val loss, banded accuracy, per-part error
  and 5-px rate) within rtol 1e-5;
* ``fit_nose_prior``, the ``detector_meta.json`` sidecar read both ways,
  and the learning rate at each step against optax's schedule;
* ``run_pretrain``: validation, per-epoch checkpoints, ``best/``, the
  bar in ``best_acc.json``, a resume that continues the step count and
  the schedule and keeps a better bar, and a checkpoint that reloads bit
  for bit; two buckets through the device-resident batches;
* the slice whole: a corpus written by the port -> ``CelebALandmarkDataset``
  -> ``load_pretrain_to_device`` -> ``device_bucketed_batch_iterator`` ->
  one step, against JAX's dataset, batches and step on the same tree.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.data import celeba as jceleba
from tpgan_tpu.data import packing as jpacking
from tpgan_tpu.models.mobilenet_v2 import anchor_centres as jax_anchor_centres
from tpgan_tpu.train import pretrain as jpretrain
from tpgan_tpu.train.optim import get_optimizer as jax_get_optimizer
from tpgan_tpu.train.optim import multistep_lr as jax_multistep_lr
from tpgan_tpu_torch.config import make_config
from tpgan_tpu_torch.convert import jax_detector_variables_to_state_dict
from tpgan_tpu_torch.data import celeba, packing
from tpgan_tpu_torch.data.synthetic_faces import generate_pretrain_protocol
from tpgan_tpu_torch.entry import pretrain_entry
from tpgan_tpu_torch.models.mobilenet_v2 import MobileNetV2
from tpgan_tpu_torch.ops import blocks
from tpgan_tpu_torch.train import pretrain
from tpgan_tpu_torch.train.checkpoint import (
    latest_step,
    restore_checkpoint,
    restore_model_variables,
)
from tpgan_tpu_torch.train.optim import get_optimizer

from _torch_detector import SIZE, detector_pair, images, jax_assignment, jax_uniforms, labels

torch.set_num_threads(1)

BATCH = 4
N = 394
# the movement's bars (relative L2 over all leaves): the port's f32 step
# from its float64 one, and JAX's from the same float64 one
F64_MOVE_REL_L2 = 2.5e-2
MOVE_REL_L2 = 0.15


def _rel_l2(got, want) -> float:
    den = float(np.sum(np.float64(want) ** 2))
    return float(np.sqrt(np.sum((np.float64(got) - want) ** 2) / den))


@pytest.fixture(scope="module", params=["absolute", "anchor_offset"])
def jax_side(request):
    """(head mode, JAX model, numpy variables, the jitted JAX step)."""
    head_mode = request.param
    jmod, variables, _ = detector_pair(head_mode, seed=2)
    jcfg = jax_make_config({"pretrain": {"head_mode": head_mode}})
    tx = jax_get_optimizer("sgd", jcfg.optimizer_param)
    step = jax.jit(jpretrain.make_pretrain_step(jcfg, jmod, tx))
    return head_mode, jmod, variables, tx, step


def _jax_state(variables, tx):
    return jpretrain.PretrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                                   batch_stats=variables["batch_stats"],
                                   opt_state=tx.init(variables["params"]))


def _port_side(head_mode, variables, dtype=torch.float32):
    cfg = make_config({"pretrain": {"head_mode": head_mode}})
    model = MobileNetV2(head_mode=head_mode, device="cpu")
    model.load_state_dict(jax_detector_variables_to_state_dict(variables), strict=True)
    model.to(dtype)
    opt = get_optimizer("sgd", model.parameters(), cfg.optimizer_param)
    return cfg, model, opt, pretrain.make_pretrain_step(cfg, model, opt)


def _jax_assigned(jmod, variables, x, lbl, u, head_mode):
    x = x.astype(np.float32) / 255.0 if x.dtype == np.uint8 else x
    (loc, _cls), _ = jax.jit(lambda v, x: jmod.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, x)
    anchors = np.asarray(jax_anchor_centres((SIZE, SIZE))) if head_mode == "anchor_offset" \
        else None
    return jax_assignment(np.asarray(loc), lbl, u, assign_points=anchors)


def _params(model):
    return {k: v.detach().double().numpy().copy() for k, v in model.state_dict().items()}


@contextlib.contextmanager
def _f64_batchnorm():
    """The port's BatchNorm normalises in float32 whatever its input; for
    the float64 run it keeps its input's dtype."""
    orig = blocks.BatchNorm2d.forward
    blocks.BatchNorm2d.forward = lambda self, h: torch.nn.BatchNorm2d.forward(self, h)
    try:
        yield
    finally:
        blocks.BatchNorm2d.forward = orig


def _check_step(head_mode, jmod, variables, jstate, jm, model, pm, aux, x, lbl, u):
    """The port's step (``model`` after it, metrics ``pm``, the loss's
    ``aux``) against JAX's (``jstate``, ``jm``) and against the port's
    float64 step on the same inputs, the truth of both f32 sides."""
    with _f64_batchnorm():
        _cfg, m64, opt64, step64 = _port_side(head_mode, variables, torch.float64)
        x64 = x.astype(np.float64) / (255.0 if x.dtype == np.uint8 else 1.0)
        _s, pm64, aux64 = step64(pretrain.PretrainState(0, m64, opt64), x64, lbl,
                                 u=torch.from_numpy(u), return_aux=True)
    # the assignment first: the port's is the float64 run's, and JAX's
    # differs from it only where JAX's own f32 forward leaves the truth
    a, k = _jax_assigned(jmod, variables, x, lbl, u, head_mode)
    for name, want in (("assigned", a), ("keep_bg", k)):
        np.testing.assert_array_equal(aux[name].numpy(), aux64[name].numpy())
        flips = aux[name].numpy() != want
        assert (flips <= (aux64[name].numpy() != want)).all()
        assert flips.sum() <= 8, (name, int(flips.sum()))
    flipped = bool((aux["assigned"].numpy() != a).any())

    def near(got, want64, jax_value, rtol, label):
        # within rtol of the truth, and of JAX by JAX's own distance from it
        np.testing.assert_allclose(got, want64, rtol=rtol, err_msg=label)
        jgap = abs(jax_value - want64) / abs(want64)
        np.testing.assert_allclose(got, jax_value, rtol=max(rtol, 2 * jgap), err_msg=label)

    for name in ("loss", "location_loss", "classification_loss"):
        near(float(pm[name]), float(pm64[name]), float(jm[name]), 1e-5, name)
    if not flipped:
        assert float(pm["num_positives"]) == float(jm["num_positives"])
    assert abs(float(pm["accuracy"]) - float(pm64["accuracy"])) <= 1e-6
    old = {k: v.double().numpy() for k, v in jax_detector_variables_to_state_dict(
        variables).items()}
    new = {k: v.double().numpy() for k, v in jax_detector_variables_to_state_dict(
        jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})).items()}
    got, truth = _params(model), _params(m64)
    for n in (n for n in old if n.endswith(("running_mean", "running_var"))):
        np.testing.assert_allclose(got[n], new[n], rtol=2e-3,
                                   atol=2e-4 * float(np.abs(new[n]).max()), err_msg=n)
    leaves = [n for n, _ in model.named_parameters()]
    move = lambda d: np.concatenate([(d[n] - old[n]).ravel() for n in leaves])  # noqa: E731
    to_truth = _rel_l2(move(got), move(truth))
    jax_to_truth = _rel_l2(move(new), move(truth))
    assert to_truth <= F64_MOVE_REL_L2 and jax_to_truth <= MOVE_REL_L2
    assert to_truth <= jax_to_truth  # the port is the nearer side
    assert _rel_l2(move(got), move(new)) <= jax_to_truth + to_truth


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_pretrain_step_matches_jax(jax_side, dtype):
    head_mode, jmod, variables, tx, jstep = jax_side
    x, lbl = images(BATCH, 3), labels(BATCH, 4)
    if dtype == "uint8":
        x = (x * 255).astype(np.uint8)
    rng = jax.random.PRNGKey(5)
    u = jax_uniforms(rng, BATCH, N)
    jstate, jm = jstep(_jax_state(variables, tx), jnp.asarray(x), jnp.asarray(lbl), rng)
    _cfg, model, opt, step = _port_side(head_mode, variables)
    state = pretrain.PretrainState(0, model, opt)
    state, pm, aux = step(state, x, lbl, u=torch.from_numpy(u), return_aux=True)
    assert state.step == 1 and int(jstate.step) == 1
    _check_step(head_mode, jmod, variables, jstate, jm, model, pm, aux, x, lbl, u)


def test_uint8_batches_decode_correctly_rounded():
    v = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, axis=3)
    got = pretrain.decode_images(v, torch.device("cpu"))
    assert got.shape == (1, 3, 16, 16)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  v.astype(np.float32) / np.float32(255.0))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(jnp.asarray(v).astype(jnp.float32) / 255.0))


def test_eval_step_matches_jax(jax_side):
    head_mode, jmod, variables, _tx, _jstep = jax_side
    x, lbl = images(BATCH, 8), labels(BATCH, 9)
    rng = jax.random.PRNGKey(3)
    jcfg = jax_make_config({"pretrain": {"head_mode": head_mode}})
    jstate = _jax_state(variables, _tx)
    jm = jax.jit(jpretrain.make_eval_step(jcfg, jmod))(jstate, jnp.asarray(x), jnp.asarray(lbl),
                                                       rng)
    cfg, model, opt, _step = _port_side(head_mode, variables)
    model.train()
    pm = pretrain.make_eval_step(cfg, model)(pretrain.PretrainState(0, model, opt), x, lbl,
                                             u=torch.from_numpy(jax_uniforms(rng, BATCH, N)))
    assert model.training  # the mode is put back
    assert set(pm) == set(jm)
    for k, v in jm.items():
        np.testing.assert_allclose(float(pm[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_nose_prior_and_detector_meta_match_jax(tmp_path):
    lbl = np.random.RandomState(0).uniform(40, 200, (50, 8)).astype(np.float32)
    w = pretrain.fit_nose_prior(lbl)
    np.testing.assert_array_equal(w, jpretrain.fit_nose_prior(lbl))
    assert w.shape == (7, 2) and w.dtype == np.float32
    cfg = make_config({"pretrain": {"head_mode": "anchor_offset", "model_name": "mobilenetv2"}})
    pretrain.write_detector_meta(str(tmp_path / "a"), cfg, nose_prior=w)
    jpretrain.write_detector_meta(str(tmp_path / "b"), jax_make_config(
        {"pretrain": {"head_mode": "anchor_offset", "model_name": "mobilenetv2"}}), nose_prior=w)
    with open(tmp_path / "a" / "detector_meta.json") as f, \
            open(tmp_path / "b" / "detector_meta.json") as g:
        assert json.load(f) == json.load(g)
    for d in ("a", "b", "a/best"):
        path = str(tmp_path / d)
        np.testing.assert_array_equal(pretrain.load_nose_prior(path), w)
        np.testing.assert_array_equal(jpretrain.load_nose_prior(path), w)
        got = pretrain.apply_detector_meta(make_config(), path).pretrain
        assert (got.head_mode, got.model_name) == ("anchor_offset", "mobilenetv2")
    assert pretrain.load_nose_prior(str(tmp_path / "none")) is None
    assert pretrain.apply_detector_meta(make_config(), str(tmp_path / "none")) == make_config()


def test_learning_rate_follows_the_jax_schedule():
    ov = {"pretrain": {"learning_rate_scheduler_milestone": (1, 2, 2),
                       "learning_rate_scheduler_gamma": 0.5}}
    state, model, opt = pretrain.create_pretrain_state(make_config(ov), 0, "cpu",
                                                       steps_per_epoch=3)
    sched = jax_multistep_lr(5e-4, (1, 2, 2), 0.5, steps_per_epoch=3)
    for count in range(9):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(sched(count)), rtol=1e-6)
        opt.step()
        state.scheduler.step()
    off = pretrain.create_pretrain_state(
        make_config({"pretrain": {"use_learning_rate_scheduler": False}}), 0, "cpu")[0]
    assert off.scheduler is None


def _tiny_batches(n, size, seed, batch=2):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        yield ((rng.uniform(0, 1, (batch, size, size, 3)) * 255).astype(np.uint8),
               rng.uniform(0.3 * size, 0.7 * size, (batch, 8)).astype(np.float32))


def test_run_pretrain_resume_and_best_bar(tmp_path):
    ov = {"pretrain": {"num_epochs": 2, "log_step_of_batchs": 2,
                       "learning_rate_scheduler_milestone": (1, 3)}}
    ck = str(tmp_path / "ck")
    val = list(_tiny_batches(2, 64, 99))

    class Writer:
        lines = []

        def write(self, step, metrics):
            self.lines.append((step, {k: float(v) for k, v in metrics.items()}))

    w = Writer()
    state = pretrain.run_pretrain(make_config(ov), _tiny_batches(100, 64, 1),
                                  val_batches_fn=lambda: iter(val), steps_per_epoch=3,
                                  writer=w, checkpoint_dir=ck, device="cpu",
                                  nose_prior=np.ones((7, 2), np.float32))
    assert state.step == 6 and latest_step(ck) == 6
    assert sorted(os.listdir(ck)) == ["3", "6", "best", "best_acc.json", "detector_meta.json"]
    val_lines = [m for s, m in w.lines if "val_accuracy" in m]
    assert [s for s, m in w.lines if "val_accuracy" in m] == [2, 4, 6]
    assert all(np.isfinite(list(m.values())).all() for _s, m in w.lines)
    with open(os.path.join(ck, "best_acc.json")) as f:
        best = json.load(f)
    assert best["best_acc"] == max(m["val_accuracy"] for m in val_lines)
    assert latest_step(os.path.join(ck, "best")) == best["step"]
    # the schedule stepped 6 times: one milestone (epoch 1 = step 3) passed,
    # the resume passes the second (epoch 3 = step 9)
    assert state.scheduler.last_epoch == 6
    np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"], 5e-5, rtol=1e-6)

    # a checkpoint reloads bit for bit
    fresh = pretrain.create_pretrain_state(make_config(ov), 5, "cpu", steps_per_epoch=3)[0]
    restore_checkpoint(ck, fresh)
    assert fresh.step == 6 and fresh.scheduler.last_epoch == 6
    for (n, a), (_n, b) in zip(state.model.state_dict().items(),
                               fresh.model.state_dict().items()):
        assert torch.equal(a, b), n
    sa, sb = state.optimizer.state_dict(), fresh.optimizer.state_dict()
    for i in sa["state"]:
        assert torch.equal(sa["state"][i]["momentum_buffer"], sb["state"][i]["momentum_buffer"])
    assert fresh.optimizer.param_groups[0]["lr"] == state.optimizer.param_groups[0]["lr"]
    with pytest.raises(ValueError, match="holds a train state"):
        restore_model_variables(ck, MobileNetV2(device="cpu"))

    # resume to 3 epochs with a bar no validation can pass: no new best
    with open(os.path.join(ck, "best_acc.json"), "w") as f:
        json.dump({"best_acc": 2.0, "step": 0}, f)
    ov["pretrain"]["num_epochs"] = 3
    resumed = pretrain.run_pretrain(make_config(ov), _tiny_batches(100, 64, 2),
                                    val_batches_fn=lambda: iter(val), steps_per_epoch=3,
                                    checkpoint_dir=ck, device="cpu", resume=True)
    assert resumed.step == 9 and latest_step(ck) == 9
    assert resumed.scheduler.last_epoch == 9
    np.testing.assert_allclose(resumed.optimizer.param_groups[0]["lr"], 5e-6, rtol=1e-6)
    assert latest_step(os.path.join(ck, "best")) == best["step"]
    with open(os.path.join(ck, "best_acc.json")) as f:
        assert json.load(f)["best_acc"] == 2.0


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A CelebA-layout corpus written by the port: 14 images of 48-140 px."""
    root = str(tmp_path_factory.mktemp("celeba"))
    txt = generate_pretrain_protocol(root, 14, sizes=(48, 140), num_subjects=6, seed=3)
    return root, txt


def test_two_buckets_through_device_batches(corpus):
    root, txt = corpus
    ds = celeba.CelebALandmarkDataset(txt, root, buckets=(96, 160))
    jds = jceleba.CelebALandmarkDataset(txt, root, buckets=(96, 160))
    idx = list(range(len(ds)))
    groups = packing.load_pretrain_to_device(ds, idx, device="cpu")
    jgroups = jpacking.load_pretrain_to_device(jds, idx)
    assert list(groups) == list(jgroups) == [(96, 96, 3), (160, 160, 3)]
    for k in groups:
        for f in ("img", "label"):
            np.testing.assert_array_equal(groups[k][f].numpy(), np.asarray(jgroups[k][f]))
    batch_for = packing.pixel_budget_batches(groups, 4)
    assert batch_for == jpacking.pixel_budget_batches(jgroups, 4) == {
        (96, 96, 3): 4, (160, 160, 3): 1}
    it = packing.device_bucketed_batch_iterator(groups, 4, seed=2, batch_for=batch_for)
    jit_ = jpacking.device_bucketed_batch_iterator(jgroups, 4, seed=2, batch_for=batch_for)
    for _ in range(6):
        (a, b), (ja, jb) = next(it), next(jit_)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    ev = list(packing.device_bucketed_eval_batches(groups, 4, batch_for))
    jev = list(jpacking.device_bucketed_eval_batches(jgroups, 4, batch_for))
    assert [e[0].shape[0] for e in ev] == [int(j[0].shape[0]) for j in jev]
    for (a, b), (ja, jb) in zip(ev, jev):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    # one step function serves both buckets
    cfg = make_config({"pretrain": {"num_epochs": 1, "log_step_of_batchs": 2}})
    state = pretrain.run_pretrain(cfg, it, val_batches_fn=lambda: iter(ev), steps_per_epoch=4,
                                  device="cpu")
    assert state.step == 4


def test_the_slice_whole_matches_jax(corpus, jax_side):
    head_mode, jmod, variables, tx, jstep = jax_side
    root, txt = corpus
    ds = celeba.CelebALandmarkDataset(txt, root, image_size=SIZE)
    jds = jceleba.CelebALandmarkDataset(txt, root, image_size=SIZE)
    assert ds.image_paths == jds.image_paths and len(ds) == 14
    train_idx, val_idx, _ = ds.split(0.8, 0.1)
    assert (train_idx, val_idx) == tuple(jds.split(0.8, 0.1)[:2])
    groups = packing.load_pretrain_to_device(ds, train_idx, device="cpu")
    jgroups = jpacking.load_pretrain_to_device(jds, train_idx)
    (x, lbl), (jx, jlbl) = (next(packing.device_bucketed_batch_iterator(groups, BATCH, seed=1)),
                            next(jpacking.device_bucketed_batch_iterator(jgroups, BATCH, seed=1)))
    assert x.dtype == torch.uint8 and x.shape == (BATCH, SIZE, SIZE, 3)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(jlbl))
    rng = jax.random.PRNGKey(6)
    u = jax_uniforms(rng, BATCH, N)
    jstate, jm = jstep(_jax_state(variables, tx), jx, jlbl, rng)
    _cfg, model, opt, step = _port_side(head_mode, variables)
    _state, pm, aux = step(pretrain.PretrainState(0, model, opt), x, lbl,
                           u=torch.from_numpy(u), return_aux=True)
    _check_step(head_mode, jmod, variables, jstate, jm, model, pm, aux, x.numpy(),
                lbl.numpy(), u)


def test_pretrain_entry_on_the_cpu():
    step_fn, (state, images_, labels_, gen) = pretrain_entry("cpu", "anchor_offset", batch_size=1)
    assert images_.shape == (1, 256, 256, 3) and labels_.shape == (1, 8)
    assert state.model.head_mode == "anchor_offset"
    state, metrics = step_fn(state, images_, labels_, gen)
    assert state.step == 1 and all(torch.isfinite(v) for v in metrics.values())
