"""The port's data axis (``tpgan_tpu_torch/parallel/``, the synced
BatchNorm, the data-parallel steps, loop and pretraining) against the
JAX package's ``parallel/`` on the CPU.

Two gloo ranks run in one spawn for the whole file (a module fixture,
``tests/_torch_parallel_ranks.py``), started before the JAX work so the
two overlap; each comparison below is its own case:

* the layout (``mesh_shape`` / ``make_mesh``) and its errors against
  JAX's ``make_mesh`` on the same device counts, and the rows of each
  rank against the ``addressable_shards`` of a JAX array on a ``data=2``
  mesh;
* the synced ``BatchNorm2d`` against JAX's ``BatchNorm2d(axis_name=
  "data")`` under ``shard_map``: outputs and gradients at 2e-5 (the JAX
  test's bar for the output), running mean at 1e-5 and running variance
  at 1e-4 (its bars); its double backward against the port's plain
  BatchNorm at the global batch at 1e-4 of each leaf's max;
* the fm 0.25 f32 GAN step at batch 2 x 2 against JAX's step jitted on a
  ``data=2`` mesh (``make_mesh`` / ``shard_gan_state`` /
  ``batch_shardings``, as ``tpgan_tpu/train/loop.py:78-107``) from the
  same weights with JAX's noise, with the bars of
  ``tests/_torch_train_parity.py``;
* the BatchNorm GAN step (the GP through the synced critic), the detector
  step at 128 and ``run_gan_training`` / ``run_pretrain`` over the mesh
  against the port in one process at the global batch (the bars are
  stated at each);
* the refusals: a mesh the ranks do not cover (a model axis too), a
  global batch the ranks do not divide, ``make_multi_step`` over gloo, a
  ``maybe_initialize`` that cannot reach its coordinator.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from tpgan_tpu.config import MeshConfig as JMeshConfig
from tpgan_tpu.ops.blocks import BatchNorm2d as JBatchNorm2d
from tpgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tpgan_tpu.parallel.sharding import batch_shardings as jax_batch_shardings
from tpgan_tpu.parallel.sharding import shard_gan_state
from tpgan_tpu.train.gan_trainer import GANTrainState as JGANTrainState
from tpgan_tpu.train.gan_trainer import make_gan_train_step as jax_make_gan_train_step
from tpgan_tpu_torch.config import MeshConfig, make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch, synthetic_pretrain_batch
from tpgan_tpu_torch.models.mobilenet_v2 import anchor_centres
from tpgan_tpu_torch.ops.blocks import BatchNorm2d
from tpgan_tpu_torch.parallel import batch_shardings, make_mesh, mesh_shape, place
from tpgan_tpu_torch.parallel.distributed import (
    free_port,
    maybe_initialize,
    process_batch_slice,
    spawn,
)
from tpgan_tpu_torch.parallel.mesh import Mesh
from tpgan_tpu_torch.train.gan_trainer import (
    GANTrainState,
    build_models,
    create_gan_state,
    make_gan_train_step,
)
from tpgan_tpu_torch.train.pretrain import (
    build_detector,
    create_pretrain_state,
    make_eval_step,
    make_pretrain_step,
)

import _torch_parallel_ranks as ranks_side
from _torch_train_parity import (
    Pair,
    assert_g_grads_match_any_data,
    assert_grads_match,
    assert_metrics_match,
    jax_as_port,
    overrides,
    sgd,
    tree_np,
)

torch.set_num_threads(2)
RANKS = 2
GAN_BATCH = 4  # 2 rows per rank
DETECTOR = {"pretrain": {"image_size": 128, "batch_size": 4, "num_epochs": 1,
                         "log_step_of_batchs": 2}}


def _bn_case(seed=0, c=4):
    rng = np.random.RandomState(seed)
    bn = BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, c).astype(np.float32)))
        bn.bias.copy_(torch.as_tensor(rng.uniform(-0.5, 0.5, c).astype(np.float32)))
        bn.running_mean.copy_(torch.as_tensor(rng.uniform(-0.5, 0.5, c).astype(np.float32)))
        bn.running_var.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, c).astype(np.float32)))
    return {"x": rng.randn(16, c, 4, 4).astype(np.float32) * 2 + 0.5,
            "cot": rng.randn(16, c, 4, 4).astype(np.float32),
            "state": {k: v.clone() for k, v in bn.state_dict().items()}}


def _noise(batch, seed):
    rng = np.random.RandomState(seed)
    return {"z": rng.standard_normal((batch, 64)).astype(np.float32),
            "gp_eps": rng.uniform(0, 1, (batch, 1, 1, 1)).astype(np.float32),
            "drop_mask_d": rng.uniform(0, 1, (batch, 256)) < 0.7,
            "drop_mask_g": rng.uniform(0, 1, (batch, 256)) < 0.7}


def _gan_bn_case():
    ov = overrides(use_batchnorm=True)
    gen, disc = build_models(make_config(ov), "cpu", seed=5)
    with torch.no_grad():  # running statistics away from their initial 0 / 1
        rng = np.random.RandomState(6)
        for name, buf in [*gen.named_buffers(), *disc.named_buffers()]:
            if "running" in name:
                buf.copy_(torch.as_tensor(rng.uniform(0.5, 1.5, buf.shape).astype(np.float32)))
    return {"overrides": ov, "gen": gen.state_dict(), "disc": disc.state_dict(),
            "batch": synthetic_gan_batch(GAN_BATCH, seed=7), "noise": _noise(GAN_BATCH, 8)}


def _detector_case():
    cfg = make_config(DETECTOR)
    batch = synthetic_pretrain_batch(4, 128, seed=9)
    n = anchor_centres((128, 128)).shape[0]
    return {"overrides": DETECTOR, "model": build_detector(cfg, "cpu", seed=3).state_dict(),
            "images": batch["image"], "labels": batch["label"],
            "u": np.random.RandomState(10).uniform(0, 1, (4, n)).astype(np.float32)}


def _loop_overrides():
    ov = overrides()
    ov["train"] = {"batch_size": GAN_BATCH, "checkpoint_every_steps": 2, "seed": 0}
    return ov


def _pretrain_data():
    train = [synthetic_pretrain_batch(4, 128, seed=20 + i) for i in range(2)]
    val = [synthetic_pretrain_batch(4, 128, seed=30), synthetic_pretrain_batch(3, 128, seed=31)]
    return ([(b["image"], b["label"]) for b in train], [(b["image"], b["label"]) for b in val])


@pytest.fixture(scope="module")
def pair():
    return Pair(use_batchnorm=False, seed=0, batch=GAN_BATCH)


@pytest.fixture(scope="module")
def cases(pair, tmp_path_factory):
    gen, disc = pair.port_models()
    train, val = _pretrain_data()
    root = tmp_path_factory.mktemp("ranks")
    gan_bn, detector = _gan_bn_case(), _detector_case()
    return {
        "batch_norm": _bn_case(),
        "gan:jax": {"overrides": overrides(), "gen": gen.state_dict(),
                    "disc": disc.state_dict(), "batch": pair.batch, "noise": pair.noise},
        "gan:bn32": gan_bn,
        "gan:bn64": {**gan_bn, "dtype": "float64"},
        "multi_step": {"overrides": overrides()},
        "detector:32": detector,
        "detector:64": {**detector, "dtype": "float64"},
        "loop": {"overrides": _loop_overrides(),
                 "batches": [synthetic_gan_batch(GAN_BATCH, seed=40 + i) for i in range(3)],
                 "checkpoint_dir": str(root / "gan_ck"), "log_dir": str(root / "gan_logs")},
        "pretrain": {"overrides": DETECTOR, "batches": train, "val": val,
                     "checkpoint_dir": str(root / "pre_ck")},
    }


@pytest.fixture(scope="module")
def spawned(cases):
    """The two ranks, started at once."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(spawn, ranks_side.run, RANKS, backend="gloo", device="cpu",
                         args=(cases,), timeout_s=300)
    try:
        yield future
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(spawned, jax_bn, jax_mesh_step, gan_bn_truth, detector_truth, loop_single):
    """The two ranks' results, by rank, read once this process has made
    its references (the JAX compiles, the float64 steps), which it does
    while the ranks run."""
    return spawned.result(timeout=300)


# --------------------------------------------------------------------------
# the layout


@pytest.mark.parametrize("data,model,n", [(-1, 2, 8), (8, 1, 8), (3, 2, 8), (-1, 1, 8),
                                          (2, 1, 1), (4, 3, 8)])
def test_mesh_shape_matches_jax(data, model, n):
    devices = jax.devices()[:n]
    try:
        want = jax_make_mesh(JMeshConfig(data=data, model=model), devices).shape
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape(MeshConfig(data=data, model=model), n)
        # the same refusal: divisibility, or a layout that does not cover n
        assert ("not divisible" in str(e)) == ("not divisible" in str(got.value))
        assert str(got.value) == str(e)
        return
    assert dict(zip(("data", "model"), mesh_shape(MeshConfig(data=data, model=model), n))) \
        == dict(want)


def test_make_mesh_one_process():
    mesh = make_mesh(MeshConfig())
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group is None
    assert mesh.data_shard == (0, 1) and mesh.backend is None
    with pytest.raises(ValueError, match="mesh 2x1 does not cover 1 devices"):
        make_mesh(MeshConfig(data=2))
    # a model axis over ranks the world does not have: JAX's refusal of a
    # one-chip host (the model axis runs in tests/test_torch_tensor_parallel.py)
    with pytest.raises(ValueError, match="^1 devices not divisible by model=2$"):
        make_mesh(MeshConfig(data=-1, model=2))
    with pytest.raises(ValueError, match="does not cover the world's 1 ranks"):
        make_mesh(MeshConfig(data=-1, model=2), devices=[0, 1])
    with pytest.raises(ValueError, match="does not cover the world"):
        make_mesh(MeshConfig(data=2), devices=[0, 1])


def test_process_batch_slice_and_rows():
    assert process_batch_slice(128) == 128
    mesh = Mesh({"data": 2, "model": 1}, ("data", "model"), None)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rows(5)


@pytest.mark.parametrize("rank", [0, 1])
def test_batch_rows_match_jax_addressable_shards(rank):
    jmesh = jax_make_mesh(JMeshConfig(data=2, model=1), jax.devices()[:2])
    batch = {k: np.asarray(v) for k, v in synthetic_gan_batch(6, seed=1).items()}
    placed = jax.tree.map(jax.device_put, batch, jax_batch_shardings(jmesh, batch))
    mesh = Mesh({"data": 2, "model": 1}, ("data", "model"), None)
    mesh.rank = rank
    got = place(batch, batch_shardings(mesh, batch))
    for k, arr in placed.items():
        shard = [s for s in arr.addressable_shards if s.device == jmesh.devices[rank, 0]][0]
        np.testing.assert_array_equal(got[k], np.asarray(shard.data), err_msg=k)
        assert got[k].base is batch[k]  # a view: nothing copied


def test_maybe_initialize():
    assert maybe_initialize() is False  # no launcher environment, no address
    # rank 1 of 2 whose coordinator never answers: raises, no lone rank
    with pytest.raises(Exception):
        maybe_initialize(f"127.0.0.1:{free_port()}", 2, 1, device="cpu", timeout_s=2)
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------------------------
# the synced BatchNorm


@pytest.fixture(scope="module")
def jax_bn(cases):
    """JAX's BatchNorm2d(axis_name="data") under shard_map on a data=2
    mesh (tests/test_numerics_and_syncbn.py:49-90's set-up): output,
    batch_stats, and the gradients of sum(y * cot)."""
    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    case = cases["batch_norm"]
    mesh = jax_make_mesh(JMeshConfig(data=2, model=1), jax.devices()[:2])
    x = jnp.asarray(np.transpose(case["x"], (0, 2, 3, 1)))
    cot = jnp.asarray(np.transpose(case["cot"], (0, 2, 3, 1)))
    # copies: JAX may alias a numpy buffer, and the spawn moves the case's
    # tensors to shared memory (freeing what their .numpy() views pointed at)
    sd = {k: np.array(v.numpy()) for k, v in case["state"].items()}
    variables = {"params": {"scale": sd["weight"], "bias": sd["bias"]},
                 "batch_stats": {"mean": sd["running_mean"], "var": sd["running_var"]}}
    bn = JBatchNorm2d(x.shape[-1], axis_name="data")

    @partial(shard_map, mesh=mesh, in_specs=(P(), P("data")), out_specs=(P("data"), P()))
    def run(variables, xs):
        out, mutated = bn.apply(variables, xs, train=True, mutable=["batch_stats"])
        return out, mutated["batch_stats"]

    def loss(params, x):
        y, _ = run({"params": params, "batch_stats": variables["batch_stats"]}, x)
        return jnp.sum(y * cot)

    y, stats = jax.jit(run)(variables, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], x)
    to_nchw = lambda a: np.transpose(np.asarray(a), (0, 3, 1, 2))
    return {"y": to_nchw(y), "mean": np.asarray(stats["mean"]), "var": np.asarray(stats["var"]),
            "gx": to_nchw(gx), "gw": np.asarray(gp["scale"]), "gb": np.asarray(gp["bias"])}


@pytest.mark.parametrize("key,rtol,atol", [("y", 2e-5, 2e-5), ("gx", 2e-5, 2e-5),
                                           ("gw", 2e-5, 2e-5), ("gb", 2e-5, 2e-5),
                                           ("mean", 1e-5, 0.0), ("var", 1e-4, 0.0)])
def test_synced_batch_norm_matches_jax_axis_name(ranks, jax_bn, key, rtol, atol):
    got = ranks
    if key in ("y", "gx"):  # each rank holds its rows
        value = np.concatenate([r["batch_norm"][key] for r in got])
    else:  # the same on both ranks
        np.testing.assert_array_equal(got[0]["batch_norm"][key], got[1]["batch_norm"][key])
        value = got[0]["batch_norm"][key]
    np.testing.assert_allclose(value, jax_bn[key], rtol=rtol, atol=atol, err_msg=key)


def test_synced_batch_norm_double_backward_matches_plain(ranks, cases):
    """The double backward (the WGAN-GP's path through a BatchNorm
    critic) of two synced ranks against the plain BatchNorm at the global
    batch: each leaf within 1e-4 of its largest element (f32 sums in
    another order: the plain forward's variance is torch's, the synced
    one's E[x^2] - E[x]^2)."""
    got = ranks
    case = cases["batch_norm"]
    bn = BatchNorm2d(case["x"].shape[1])
    bn.load_state_dict(case["state"])
    bn.train()
    x = torch.tensor(case["x"], requires_grad=True)
    y = bn(x)
    gx = torch.autograd.grad((y * torch.as_tensor(case["cot"])).sum(), x, create_graph=True)[0]
    want = dict(zip(("g2x", "g2w"), torch.autograd.grad((gx * gx).sum(), (x, bn.weight))))
    for key, w in want.items():
        w = w.numpy()
        value = (np.concatenate([r["batch_norm"][key] for r in got]) if key == "g2x"
                 else got[0]["batch_norm"][key])
        np.testing.assert_allclose(value, w, rtol=0, atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=key)
    assert float(want["g2w"].abs().max()) > 0


# --------------------------------------------------------------------------
# the GAN step


@pytest.fixture(scope="module")
def jax_mesh_step(pair):
    """JAX's SGD step jitted on a data=2 mesh, as its loop shards it, from
    the pair's weights: (state before, after, metrics)."""
    mesh = jax_make_mesh(JMeshConfig(data=2, model=1), jax.devices()[:2])
    g_tx, d_tx = sgd(), sgd()
    gp, dp = pair.g_params, pair.d_params
    state = JGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=gp, d_params=dp,
        g_opt_state=g_tx.init(gp), d_opt_state=d_tx.init(dp),
        g_batch_stats=pair.g_stats or {}, d_batch_stats=pair.d_stats or {},
        g_ema_params=jax.tree.map(jnp.copy, gp))
    state_sh = shard_gan_state(mesh, state)
    batch_sh = jax_batch_shardings(mesh, pair.batch, "data")
    step = jax.jit(jax_make_gan_train_step(pair.jcfg, pair.jgen, pair.jdisc, g_tx, d_tx),
                   in_shardings=(state_sh, batch_sh, None), out_shardings=(state_sh, None))
    new, metrics = step(jax.tree.map(jax.device_put, state, state_sh),
                        jax.tree.map(jax.device_put, pair.batch, batch_sh), pair.rng)
    return tree_np(state), tree_np(new), {k: float(v) for k, v in metrics.items()}


def test_gan_step_metrics_match_jax_mesh(ranks, jax_mesh_step):
    got = ranks
    assert got[0]["gan:jax"]["metrics"] == got[1]["gan:jax"]["metrics"]  # global means
    assert_metrics_match(got[0]["gan:jax"]["metrics"], jax_mesh_step[2])
    assert [r["gan:jax"]["rows"] for r in got] == [(0, 2), (2, 4)]


@pytest.mark.parametrize("model", ["d", "g"])
def test_gan_step_gradients_match_jax_mesh(ranks, jax_mesh_step, model):
    got = ranks
    critic = model == "d"
    new = jax_mesh_step[1]
    want = jax_as_port(new.d_opt_state if critic else new.g_opt_state, critic)
    for name, g in got[0]["gan:jax"][f"{model}_grad"].items():  # all-reduced: one mean
        np.testing.assert_array_equal(g, got[1]["gan:jax"][f"{model}_grad"][name])
    check = assert_grads_match if critic else assert_g_grads_match_any_data  # batch 4: see it
    check(want, got[0]["gan:jax"][f"{model}_grad"], f"{model} (data=2)")


# The BatchNorm step (the GP's double backward through the synced critic)
# and the detector step (BatchNorm throughout): two ranks against the port
# in one process at the global batch, held against a float64 run of both.
# In float64 the two agree to 1e-14 (GAN) and 3e-13 (detector) in relative
# L2: held at 1e-10; each metric at 1e-6 of itself (the pixel and
# cross-entropy losses cast to float32, so the G loss sums float32 means,
# there 6e-8 apart). In float32 the synced statistics (each rank's mean
# and variance in f32, merged) are further from the float64 truth than the
# one-process BatchNorm (torch's CPU kernel accumulates in double): the
# ranks' D gradient 1.9e-3, G 1.2e-4 and the detector's 8.7e-3 off in
# relative L2, where the one-process f32 step is 1.8e-6, 5.4e-4 and 3.2e-3
# off. The seeded models are ill-conditioned there (ROADMAP C3; the
# detector's bar in tests/test_torch_pretrain.py, F64_MOVE_REL_L2 =
# 2.5e-2, and the BN step's in tests/test_torch_train_step_bn.py): the f32
# ranks are held to 1e-2 (GAN) and 2.5e-2 (detector) of the truth, the
# metrics before the D update at the dryrun bar, those after it (g_adv_G
# and the G loss, against the updated critic: 0.6% off) at 1e-2.
F64_REL_L2 = 1e-10
F64_METRIC_RTOL = 1e-6
GAN_F32_REL_L2 = 1e-2
DETECTOR_F32_REL_L2 = 2.5e-2
LOOP_MOVE_REL_L2 = 1e-2


def _rel_l2(got: dict, want: dict) -> float:
    assert got.keys() == want.keys() and want
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    num = sum(float(np.sum((f64(got[k]) - f64(want[k])) ** 2)) for k in want)
    return float(np.sqrt(num / sum(float(np.sum(f64(want[k]) ** 2)) for k in want)))


@pytest.fixture(scope="module")
def gan_bn_truth(cases):
    return one_process_gan_step(cases["gan:bn64"])


def one_process_gan_step(case):
    """The port's SGD step in one process at the global batch."""
    cfg = make_config(case["overrides"])
    gen, disc = ranks_side.gan_models(cfg, case)
    g_opt = torch.optim.SGD(gen.parameters(), lr=ranks_side.SGD_LR)
    d_opt = torch.optim.SGD(disc.parameters(), lr=ranks_side.SGD_LR)
    state = GANTrainState(0, gen, disc, g_opt, d_opt, {})
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    _, metrics = step(state, ranks_side.as_dtype(case["batch"], case),
                      torch.Generator().manual_seed(0), ranks_side.as_dtype(case["noise"], case))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g_grad": ranks_side._grads(gen), "d_grad": ranks_side._grads(disc),
            "g_stats": ranks_side._stats(gen), "d_stats": ranks_side._stats(disc)}


def _assert_close_metrics(got, want, rtol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert abs(got[k] - w) <= rtol * abs(w) + 1e-30, (k, got[k], w)


def test_bn_gan_step_float64_equals_one_process(ranks, gan_bn_truth):
    got = ranks
    for r in got:
        for key in ("d_grad", "g_grad", "d_stats", "g_stats"):
            assert _rel_l2(r["gan:bn64"][key], gan_bn_truth[key]) <= F64_REL_L2, key
        _assert_close_metrics(r["gan:bn64"]["metrics"], gan_bn_truth["metrics"], F64_METRIC_RTOL)


def test_bn_gan_step_float32_near_truth(ranks, gan_bn_truth):
    got = ranks[0]["gan:bn32"]
    for key in ("d_grad", "g_grad"):
        assert _rel_l2(got[key], gan_bn_truth[key]) <= GAN_F32_REL_L2, key
    for key in ("d_stats", "g_stats"):
        for name, want in gan_bn_truth[key].items():
            np.testing.assert_allclose(got[key][name], want, rtol=1e-5, atol=1e-6, err_msg=name)
    after_d_update = {"g_adv_G", "g_loss"}
    _assert_close_metrics({k: v for k, v in got["metrics"].items() if k in after_d_update},
                          {k: v for k, v in gan_bn_truth["metrics"].items()
                           if k in after_d_update}, 1e-2)
    assert_metrics_match({k: v for k, v in got["metrics"].items() if k not in after_d_update},
                         {k: v for k, v in gan_bn_truth["metrics"].items()
                          if k not in after_d_update})


def test_multi_step_refuses_gloo(ranks):
    for r in ranks:
        assert r["multi_step"] is not None and "gloo" in r["multi_step"]
        assert r["shape"] == {"data": 2, "model": 1} and r["backend"] == "gloo"


# --------------------------------------------------------------------------
# the detector step, the loop and the pretraining run


@pytest.fixture(scope="module")
def detector_truth(cases):
    return one_process_detector_step(cases["detector:64"])


def one_process_detector_step(case):
    """The port's detector step in one process at the global batch."""
    cfg = make_config(case["overrides"])
    state, model, opt = create_pretrain_state(cfg, seed=0, device="cpu")
    model.load_state_dict(case["model"])
    if case.get("dtype") == "float64":
        model.double()
    step = make_pretrain_step(cfg, model, opt)
    images = case["images"].astype(case.get("dtype", "float32"))
    _, metrics, aux = step(state, images, case["labels"], u=case["u"], return_aux=True)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "assigned": aux["assigned"].numpy(), "keep_bg": aux["keep_bg"].numpy(),
            "grad": ranks_side._grads(model), "stats": ranks_side._stats(model)}


@pytest.mark.parametrize("dtype", ["64", "32"])
def test_detector_step_matches_one_process(ranks, detector_truth, dtype):
    """The detector's step at 128, 2 x 2 rows against one process at 4 in
    float64: the loss's assignment first (a discrete choice), then the
    metrics, gradients and statistics (bars above)."""
    got = [r[f"detector:{dtype}"] for r in ranks]
    for key in ("assigned", "keep_bg"):
        np.testing.assert_array_equal(np.concatenate([r[key] for r in got]), detector_truth[key])
    if dtype == "64":
        _assert_close_metrics(got[0]["metrics"], detector_truth["metrics"], F64_METRIC_RTOL)
        assert _rel_l2(got[0]["grad"], detector_truth["grad"]) <= F64_REL_L2
        assert _rel_l2(got[0]["stats"], detector_truth["stats"]) <= F64_REL_L2
        return
    assert_metrics_match(got[0]["metrics"], detector_truth["metrics"])
    assert _rel_l2(got[0]["grad"], detector_truth["grad"]) <= DETECTOR_F32_REL_L2
    for name, want in detector_truth["stats"].items():
        np.testing.assert_allclose(got[0]["stats"][name], want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def loop_single(cases, tmp_path_factory):
    """The loop in one process: its log lines and final generator."""
    from tpgan_tpu_torch.train.loop import run_gan_training
    from tpgan_tpu_torch.train.metrics import MetricWriter

    case = cases["loop"]
    cfg = make_config(case["overrides"])
    root = tmp_path_factory.mktemp("loop")
    for steps, resume in ((2, False), (3, True)):
        writer = MetricWriter(str(root / "logs"), use_tensorboard=False)
        try:
            state = run_gan_training(cfg, iter(case["batches"]), steps=steps,
                                     checkpoint_dir=str(root / "ck"), resume=resume,
                                     writer=writer, log_every=1, device="cpu")
        finally:
            writer.close()
    return _jsonl(root / "logs" / "metrics.jsonl"), state


def test_gan_loop_over_mesh(ranks, cases, loop_single):
    """run_gan_training(mesh=) for 2 steps (rank 0 writes exactly one
    checkpoint, at step 2), then resumed to 3, against the loop in one
    process: each logged step's metrics at the dryrun bar, and the
    generator's movement over the 3 steps within 1e-2 in relative L2
    (measured 3.6e-3: Adam's g / (|g| + eps) turns the f32 gradient
    noise of an element near 0 into a step of either sign)."""
    got = ranks
    case = cases["loop"]
    for r in got:
        assert r["loop"]["ckpts_2"] == ["2"] and r["loop"]["ckpts_3"] == ["2", "3"]
    cfg = make_config(case["overrides"])
    want, state = loop_single
    lines = _jsonl(os.path.join(case["log_dir"], "metrics.jsonl"))  # rank 0's lines only
    assert [w["step"] for w in want] == [line["step"] for line in lines] == [1, 2, 3]
    for w, line in zip(want, lines):
        w.pop("imgs_per_sec"), line.pop("imgs_per_sec")
        assert_metrics_match(line, w)
    start = dict(create_gan_state(cfg, cfg.train.seed, "cpu")[0].gen.named_parameters())
    move = lambda g: {n: g[n] - start[n].detach().numpy() for n in start}  # noqa: E731
    gap = _rel_l2(move(got[0]["loop"]["g"]),
                  move({n: p.detach().numpy() for n, p in state.gen.named_parameters()}))
    assert gap <= LOOP_MOVE_REL_L2


def test_run_pretrain_over_mesh(ranks, cases):
    """run_pretrain(mesh=) for one epoch of two steps, validation at step 2
    over a batch of 4 and one of 3 (1 and 2 rows on the ranks): rank 0
    alone logs and writes (the sidecar, best/, its bar, the epoch's
    checkpoint), both ranks end with the same state, and the validation
    metrics are the global batch's: those of one process evaluating that
    state on the same batches with the same draws, at 1e-5 of each."""
    got = [r["pretrain"] for r in ranks]
    case = cases["pretrain"]
    assert got[0]["files"] == ["2", "best", "best_acc.json", "detector_meta.json"]
    assert got[1]["lines"] == []
    for name, value in got[0]["state"].items():
        np.testing.assert_array_equal(got[1]["state"][name], value, err_msg=name)
    cfg = make_config(case["overrides"])
    model = build_detector(cfg, "cpu")
    model.load_state_dict({k: torch.from_numpy(v) for k, v in got[0]["state"].items()})
    generator = torch.Generator().manual_seed(0)
    for images, _labels in case["batches"]:  # the train steps' global draws
        torch.rand((len(images), anchor_centres((128, 128)).shape[0]), generator=generator)
    eval_step = make_eval_step(cfg, model)
    sums = {}
    for images, labels in case["val"]:
        for k, v in eval_step(None, images, labels, generator).items():
            sums.setdefault(k, []).append(float(v))
    (step, logged), = got[0]["lines"]
    assert step == 2
    _assert_close_metrics(logged, {k: float(np.mean(v)) for k, v in sums.items()}, 1e-5)


def test_global_batch_not_divisible_raises():
    """Every rank's rows: a global batch the data axis does not divide is
    refused, by the loop before it builds its step."""
    from tpgan_tpu_torch.train.loop import run_gan_training

    mesh = Mesh({"data": 2, "model": 1}, ("data", "model"), None)
    cfg = make_config({**overrides(), "train": {"batch_size": 3}})
    with pytest.raises(ValueError, match="not divisible"):
        run_gan_training(cfg, iter([]), steps=1, mesh=mesh, device="cpu")
