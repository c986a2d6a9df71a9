"""The port's model axis (``tpgan_tpu_torch/parallel/``: the (data, model)
mesh, ``infer_param_shardings`` / ``shard_gan_state`` /
``per_device_bytes``, the column- and row-parallel layers of
``parallel.tensor_parallel``, and the step, checkpoints, detector and
loop on a model axis) against the JAX package's ``parallel/`` on the CPU.

Four gloo ranks run in one spawn for the whole file (a module fixture,
``tests/_torch_tensor_parallel_ranks.py``), started before the JAX work
so the two overlap; the ranks form the ``{data: 2, model: 2}`` mesh of
the world and two ``{data: 1, model: 2}`` meshes of pairs, which run
their cases side by side. Each comparison below is its own case:

* (a) the rule at full width: every leaf of the fm 1.0 generator and
  critic and of the detector's pretrain state (on ``device="meta"``)
  against JAX's ``infer_param_shardings`` on the ``jax.eval_shape``
  trees, and JAX's six small cases (``tests/test_parallel.py:28-45``) in
  torch layouts;
* (b) the column- and row-parallel conv (reflect-padded and strided too,
  and depthwise), deconv and linear: forward, gradient and the gradient
  of a gradient against the unsharded layer, float64 at 1e-12 and
  float32 at 1e-5 of each result's largest element;
* (c) the fm 0.25 step at ``min_shard_dim`` 16 on ``{data: 2, model:
  2}`` against JAX's step on a ``{data: 4, model: 2}`` mesh of its 8 CPU
  devices with the same noise (the bars of ``tests/_torch_train_parity.py``),
  two float64 Adam steps against the port in one process (1e-12), and
  the replicated leaves bit-equal on every rank;
* (d) the full-size f32 synthesis on ``{data: 1, model: 2}`` against
  JAX's ``make_synthesize_fn`` on the same weights (5e-4,
  ``__graft_entry__.py:192``);
* (e) the parameters and Adam moments per rank at full width on a model
  axis of 2 below 0.8 of one device's (``tests/test_parallel.py:181``);
* (f) checkpoints in both directions: a tensor-parallel run's resumes in
  one process, a one-process run's on the mesh, each to the same next
  step in float64, and the file is a single device's;
* (g) the detector's step on ``{data: 1, model: 2}`` against one process
  (the bars of ``tests/test_torch_parallel.py``);
* ``run_gan_training`` over ``{data: 2, model: 2}`` with a sample grid
  and a checkpoint; the mesh's layout; the int8 path's refusal.
"""

from __future__ import annotations

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpgan_tpu.config import MeshConfig as JMeshConfig
from tpgan_tpu.config import make_config as jax_make_config
from tpgan_tpu.parallel.mesh import make_mesh as jax_make_mesh
from tpgan_tpu.parallel.sharding import batch_shardings as jax_batch_shardings
from tpgan_tpu.parallel.sharding import infer_param_shardings as jax_infer_param_shardings
from tpgan_tpu.parallel.sharding import shard_gan_state as jax_shard_gan_state
from tpgan_tpu.train.gan_trainer import GANTrainState as JGANTrainState
from tpgan_tpu.train.gan_trainer import build_models as jax_build_models
from tpgan_tpu.train.gan_trainer import example_batch as jax_example_batch
from tpgan_tpu.train.gan_trainer import make_gan_train_step as jax_make_gan_train_step
from tpgan_tpu.train.gan_trainer import make_synthesize_fn as jax_make_synthesize_fn
from tpgan_tpu.train.pretrain import create_pretrain_state as jax_create_pretrain_state
from tpgan_tpu_torch.config import MeshConfig, make_config
from tpgan_tpu_torch.convert import jax_generator_params_to_state_dict
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch, synthetic_pretrain_batch
from tpgan_tpu_torch.models.discriminator import Discriminator
from tpgan_tpu_torch.models.generator import Generator
from tpgan_tpu_torch.models.mobilenet_v2 import anchor_centres
from tpgan_tpu_torch.models.registry import get_model
from tpgan_tpu_torch.ops import quant
from tpgan_tpu_torch.ops.blocks import Conv2d, ConvTranspose2d, LinearBlock
from tpgan_tpu_torch.parallel import (
    Replicated,
    ShardDim,
    infer_param_shardings,
    make_mesh,
    per_device_bytes,
    place,
    shard_gan_state,
)
from tpgan_tpu_torch.parallel.distributed import spawn
from tpgan_tpu_torch.parallel.mesh import Mesh
from tpgan_tpu_torch.parallel.sharding import _leaves
from tpgan_tpu_torch.parallel.tensor_parallel import weight_dims
from tpgan_tpu_torch.train.checkpoint import restore_gan_checkpoint
from tpgan_tpu_torch.train.gan_trainer import GANTrainState, create_gan_state, make_gan_train_step
from tpgan_tpu_torch.train.optim import adam_wgan, get_optimizer
from tpgan_tpu_torch.train.pretrain import PretrainState, build_detector

import _torch_tensor_parallel_ranks as ranks_side
from _torch_port import init_numpy
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

torch.set_num_threads(1)
RANKS = 4
GAN_BATCH = ranks_side.GAN_BATCH
KEYS = ranks_side.PATCH_KEYS
ADAM_SEEDS = (50, 51)
DETECTOR = {"pretrain": {"image_size": 128, "batch_size": 4, "num_epochs": 1}}
F64_REL_L2 = 1e-12
# the detector's bars, tests/test_torch_parallel.py's: float64 to 1e-10 in
# relative L2 and 1e-6 of each metric; float32 at the dryrun bar and
# 2.5e-2 of the float64 truth's gradients (the seeded detector is
# ill-conditioned there: F64_MOVE_REL_L2 of tests/test_torch_pretrain.py)
DETECTOR_F64_REL_L2 = 1e-10
F64_METRIC_RTOL = 1e-6
DETECTOR_F32_REL_L2 = 2.5e-2


def _rel_l2(got: dict, want: dict) -> float:
    assert got.keys() == want.keys() and want
    f64 = lambda x: np.asarray(x, np.float64)  # noqa: E731
    num = sum(float(np.sum((f64(got[k]) - f64(want[k])) ** 2)) for k in want)
    return float(np.sqrt(num / sum(float(np.sum(f64(want[k]) ** 2)) for k in want)))


def _close_metrics(got, want, rtol):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert abs(got[k] - w) <= rtol * abs(w) + 1e-30, (k, got[k], w)


# --------------------------------------------------------------------------
# the cases and the spawn


def _detector_case():
    cfg = make_config(DETECTOR)
    batch = synthetic_pretrain_batch(4, 128, seed=9)
    n = anchor_centres((128, 128)).shape[0]
    return {"overrides": DETECTOR, "model": build_detector(cfg, "cpu", seed=3).state_dict(),
            "images": batch["image"], "labels": batch["label"],
            "u": np.random.RandomState(10).uniform(0, 1, (4, n)).astype(np.float32)}


@pytest.fixture(scope="module")
def pair():
    return Pair(use_batchnorm=False, seed=0, batch=GAN_BATCH)


@pytest.fixture(scope="module")
def full_size(tmp_path_factory):
    """Full-size (fm 1.0) generator weights drawn with numpy over JAX's
    tree, the port's state_dict of them in a file, a batch of 1 and z."""
    jcfg = jax_make_config({"compute_dtype": "float32"})
    jgen, _ = jax_build_models(jcfg)
    batch = {k: v for k, v in synthetic_gan_batch(1, seed=11).items() if k in KEYS}
    z = np.random.RandomState(12).standard_normal((1, jcfg.G.zdim)).astype(np.float32)
    params, _stats = init_numpy(jgen, *(batch[k] for k in KEYS), z, seed=13)
    path = str(tmp_path_factory.mktemp("full") / "gen.pt")
    torch.save(jax_generator_params_to_state_dict(params), path)
    return {"jcfg": jcfg, "jgen": jgen, "params": params, "batch": batch, "z": z, "path": path}


@pytest.fixture(scope="module")
def cases(pair, full_size, tmp_path_factory):
    gen, disc = pair.port_models()
    root = tmp_path_factory.mktemp("tp")
    detector = _detector_case()
    return {
        "gan_sgd": {"mesh": "2x2", "overrides": overrides(), "gen": gen.state_dict(),
                    "disc": disc.state_dict(), "batch": pair.batch, "noise": pair.noise},
        "gan_adam": {"mesh": "2x2", "overrides": overrides(), "seeds": ADAM_SEEDS},
        "loop": {"mesh": "2x2", "overrides": {**overrides(), "train": {
                     "batch_size": GAN_BATCH, "checkpoint_every_steps": 2, "seed": 0}},
                 "batches": [synthetic_gan_batch(GAN_BATCH, seed=40 + i) for i in range(2)],
                 "checkpoint_dir": str(root / "loop_ck")},
        "synthesis": {"mesh": "pair0", "weights": full_size["path"],
                      "batch": full_size["batch"], "z": full_size["z"]},
        "products:float64": {"mesh": "pair0", "dtype": "float64"},
        "products:float32": {"mesh": "pair0", "dtype": "float32"},
        "resume_on_mesh": {"mesh": "pair0", "overrides": overrides(), "seeds": ADAM_SEEDS,
                           "directory": str(root / "one")},
        "tp_checkpoint": {"mesh": "pair1", "overrides": overrides(), "seeds": ADAM_SEEDS,
                          "directory": str(root / "tp")},
        "detector:64": {"mesh": "pair1", **detector, "dtype": "float64"},
        "detector:32": {"mesh": "pair1", **detector},
    }


@pytest.fixture(scope="module")
def spawned(cases):
    """The four ranks, started at once."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    future = pool.submit(spawn, ranks_side.run, RANKS, backend="gloo", device="cpu",
                         args=(cases,), timeout_s=400)
    try:
        yield future
    finally:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def ranks(spawned, jax_mesh_step, adam_truth, jax_full_synthesis, detector_truth,
          resume_truth):
    """The four ranks' results, by rank, read once this process has made
    its references (the JAX compiles, the one-process steps), which it
    does while the ranks run."""
    return spawned.result(timeout=400)


# --------------------------------------------------------------------------
# the layout


def test_mesh_layout_is_jax_reshape(ranks):
    """Global rank d * model + m sits at (d, m), JAX's reshape(data,
    model), with a group per axis (``data_group`` / ``model_group``);
    each pair is a {data: 1, model: 2} mesh of its own."""
    for r, out in enumerate(ranks):
        assert out["grid"] == (r // 2, r % 2, {"data": 2, "model": 2}, "gloo")
        assert out["pair"] == (0, r % 2, {"data": 1, "model": 2})
        # (index, ranks) on each axis: a pair has no data group to run over
        assert out["groups"] == ((r // 2, 2), (r % 2, 2), (0, 1), (r % 2, 2))


def test_make_mesh_one_process_refuses_a_model_axis():
    """One process is a world of one: JAX's refusals, as its mesh refuses
    a one-chip host (the model axis itself runs on the ranks above)."""
    with pytest.raises(ValueError, match="^1 devices not divisible by model=2$"):
        make_mesh(MeshConfig(data=-1, model=2))
    with pytest.raises(ValueError, match="^mesh 2x2 does not cover 2 devices$"):
        make_mesh(MeshConfig(data=2, model=2), devices=[0, 1])
    with pytest.raises(ValueError, match="does not cover the world's 1 ranks"):
        make_mesh(MeshConfig(data=1, model=2), devices=[0, 1])


# --------------------------------------------------------------------------
# (a) the rule


def _jax_mesh():
    return jax_make_mesh(JMeshConfig(data=4, model=2), jax.devices()[:8])


def _port_mesh(index: int = 0):
    """A {data: 4, model: 2} layout with no process group: the rule and
    the placement need only its shape and this rank's model index."""
    return Mesh({"data": 4, "model": 2}, ("data", "model"), None, index=index)


def _jax_decisions(tree, prefix=""):
    """{port-style name: ("column" | "row" | None, leaf shape)} of JAX's
    rule on a tree of shapes (kernel -> weight, scale -> weight)."""
    specs = jax_infer_param_shardings(_jax_mesh(), tree)
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(specs):
        keys = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
        leaf = {"kernel": "weight", "scale": "weight"}.get(keys[-1], keys[-1])
        spec = tuple(spec.spec)
        kind = None
        if spec and spec[-1] == "model":
            kind = "column"
        elif len(spec) >= 2 and spec[-2] == "model":
            kind = "row"
        out[prefix + ".".join(map(str, keys[:-1] + [leaf]))] = kind
    return out


def _port_decisions(shardings, tree):
    """{name: kind} of the port's placements: column on the weight's
    output dim, row on its input dim."""
    leaves = _leaves(tree)
    out = {}
    for name, s in shardings.items():
        if isinstance(s, ShardDim):
            out_dim, in_dim = weight_dims(leaves[name].layer)
            out[name] = {out_dim: "column", in_dim: "row"}[s.dim]
        else:
            assert isinstance(s, Replicated)
            out[name] = None
    return out


def _meta_models(cfg):
    gen = Generator(zdim=cfg.G.zdim, num_classes=cfg.G.num_classes,
                    use_batchnorm=cfg.G.use_batchnorm,
                    use_residual_block=cfg.G.use_residual_block,
                    fm_multiplier=cfg.G.fm_multiplier,
                    local_feature_layer_dim=cfg.G.local_feature_layer_dim,
                    upsample_mode=cfg.G.upsample_mode, device="meta")
    disc = Discriminator(use_batchnorm=cfg.D.use_batchnorm, fm_multiplier=cfg.D.fm_multiplier,
                         device="meta")
    return gen, disc


def _counts(decisions):
    kinds = list(decisions.values())
    return kinds.count("column"), kinds.count("row")


@pytest.fixture(scope="module")
def full_width_trees():
    jcfg = jax_make_config({})
    jgen, jdisc = jax_build_models(jcfg)
    b = jax_example_batch(1, jnp.float32)
    g = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), *(b[k] for k in KEYS),
                       jnp.zeros((1, jcfg.G.zdim)))["params"]
    d = jax.eval_shape(jdisc.init, jax.random.PRNGKey(1), b["img"])["params"]
    pre = jax.eval_shape(lambda r: jax_create_pretrain_state(jcfg, r)[0], jax.random.PRNGKey(2))
    return {"generator": g, "critic": d, "detector": pre}


def _port_detector_state(cfg):
    """The detector's pretrain state on meta, SGD's momentum made by one
    step of zero gradients (JAX's ``tx.init`` holds it from the start)."""
    model = get_model(cfg.pretrain.model_name, head_mode=cfg.pretrain.head_mode, device="meta")
    opt = get_optimizer(cfg.pretrain.optimizer, model.parameters(), cfg.optimizer_param)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    return PretrainState(0, model, opt)


@pytest.mark.parametrize("tree,column,row", [("generator", 71, 11), ("critic", 7, 1),
                                             ("detector", 54, 36)])
def test_rule_matches_jax_at_full_width(full_width_trees, tree, column, row):
    """Every leaf's decision equals JAX's on the jax.eval_shape tree,
    mapped through the converter's names; the counts are JAX's (the
    detector's: its parameters, SGD's momentum and BatchNorm statistics)."""
    cfg = make_config({})
    mesh = _port_mesh()
    if tree == "detector":
        state = _port_detector_state(cfg)
        port = _port_decisions(infer_param_shardings(mesh, state), state)
        jax_tree = full_width_trees["detector"]
        want = _jax_decisions(jax_tree.params, "model.")
        # SGD's trace: JAX's opt-state leaves with the parameters' shapes
        want.update({f"optimizer.{k[len('model.'):]}.momentum_buffer": v
                     for k, v in want.items()})
        want_all = _jax_decisions(jax_tree)
        assert _counts(want_all) == (column, row)
        got = {k: v for k, v in port.items() if k.startswith(("model.", "optimizer."))
               and not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
        assert got == want
        assert _counts(port) == (column, row)
        return
    gen, disc = _meta_models(cfg)
    module = gen if tree == "generator" else disc
    port = _port_decisions(infer_param_shardings(mesh, module), module)
    port = {k: v for k, v in port.items()
            if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))}
    want = _jax_decisions(full_width_trees[tree])
    assert port == want
    assert _counts(port) == (column, row)


def _scalar():
    module = torch.nn.Module()
    module.register_buffer("weight", torch.zeros((), device="meta"))
    return module


@pytest.mark.parametrize("name,layer,kind,dim", [
    ("wide", lambda: Conv2d(64, 512, 3, device="meta"), "column", 0),
    ("narrow", lambda: Conv2d(8, 16, 3, device="meta"), None, None),
    ("scalar", lambda: _scalar(), None, None),
    ("fc1", lambda: LinearBlock(32768, 512, device="meta"), "column", 0),
    ("deconv_head", lambda: ConvTranspose2d(512, 64, 4, device="meta"), "row", 0),
    ("odd_out", lambda: Conv2d(512, 255, 3, device="meta"), "row", 1),
])
def test_rule_small_cases_as_jax(name, layer, kind, dim):
    """tests/test_parallel.py:28-45 in torch layouts: (3,3,64,512) column
    on OIHW's O; (3,3,8,16) and a scalar (a layer the rule does not know)
    replicated; fc1 (32768, 512) column on (out, in)'s out; the deconv
    (4,4,512,64) row on IOHW's I; (3,3,512,255) row on OIHW's I."""
    module = layer()
    sh = infer_param_shardings(_port_mesh(), module, min_shard_dim=256)
    weight = sh["weight"]
    if kind is None:
        assert isinstance(weight, Replicated)
    else:
        assert weight == ShardDim(weight.mesh, dim)
        assert _port_decisions({"weight": weight}, module) == {"weight": kind}
    assert all(isinstance(s, Replicated) for k, s in sh.items() if k != "weight")


# --------------------------------------------------------------------------
# (b) the products


def _unsharded_products(name, dtype):
    layer, x = ranks_side.layer_case(name, getattr(torch, dtype))
    return ranks_side.layer_products(layer, x), layer


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
@pytest.mark.parametrize("name", list(ranks_side.LAYERS))
def test_parallel_layer_products(ranks, name, dtype, tol):
    """Each rank of pair 0: its placement (row-parallel where the output
    dim is too narrow), its slice of the weight, then the forward, dL/dx
    and the penalty's gradients in x, the weight and the bias against the
    unsharded layer, at ``tol`` of each result's largest element."""
    want, layer = _unsharded_products(name, dtype)
    kind = "row" if name.endswith("_row") else "column"
    for r in (0, 1):
        got = ranks[r][f"products:{dtype}"][name]
        assert got["kind"] == kind
        local = list(layer.weight.shape)
        local[weight_dims(layer)[0 if kind == "column" else 1]] //= 2
        assert got["local"] == tuple(local)
        for key, w in want.items():
            assert got[key].shape == w.shape and got[key].dtype == w.dtype, key
            scale = float(np.abs(w).max())
            assert scale > 0, key
            np.testing.assert_allclose(got[key], w, rtol=0, atol=tol * scale,
                                       err_msg=f"{name} {dtype} {key} rank {r}")


# --------------------------------------------------------------------------
# (c) the step


@pytest.fixture(scope="module")
def jax_mesh_step(pair):
    """JAX's SGD step jitted on a {data: 4, model: 2} mesh, the state
    placed by shard_gan_state at min_shard_dim 16: (state after, metrics)."""
    mesh = _jax_mesh()
    g_tx, d_tx = sgd(), sgd()
    gp, dp = pair.g_params, pair.d_params
    state = JGANTrainState(
        step=jnp.zeros((), jnp.int32), g_params=gp, d_params=dp,
        g_opt_state=g_tx.init(gp), d_opt_state=d_tx.init(dp),
        g_batch_stats={}, d_batch_stats={}, g_ema_params=jax.tree.map(jnp.copy, gp))
    state_sh = jax_shard_gan_state(mesh, state, min_shard_dim=ranks_side.MIN_SHARD_DIM)
    batch_sh = jax_batch_shardings(mesh, pair.batch, "data")
    step = jax.jit(jax_make_gan_train_step(pair.jcfg, pair.jgen, pair.jdisc, g_tx, d_tx),
                   in_shardings=(state_sh, batch_sh, None), out_shardings=(state_sh, None))
    new, metrics = step(jax.tree.map(jax.device_put, state, state_sh),
                        jax.tree.map(jax.device_put, pair.batch, batch_sh), pair.rng)
    return tree_np(new), {k: float(v) for k, v in metrics.items()}


def test_gan_step_metrics_match_jax_mesh(ranks, jax_mesh_step):
    got = [r["gan_sgd"] for r in ranks]
    for r in got[1:]:
        assert r["metrics"] == got[0]["metrics"]  # global means, the same on every rank
    assert_metrics_match(got[0]["metrics"], jax_mesh_step[1])
    # the narrow rule shards both models: column- and row-parallel layers
    assert got[0]["kinds"]["column"] > 0 and got[0]["kinds"]["row"] > 0


@pytest.mark.parametrize("model", ["d", "g"])
def test_gan_step_gradients_match_jax_mesh(ranks, jax_mesh_step, model):
    """Every rank's gathered gradients are one mean (bit for bit across
    the ranks), held against JAX's at the parity helper's bars."""
    critic = model == "d"
    new = jax_mesh_step[0]
    want = jax_as_port(new.d_opt_state if critic else new.g_opt_state, critic)
    got = [r["gan_sgd"][f"{model}_grad"] for r in ranks]
    for other in got[1:]:
        for name, g in got[0].items():
            np.testing.assert_array_equal(other[name], g, err_msg=name)
    check = assert_grads_match if critic else assert_g_grads_match_any_data
    check(want, got[0], f"{model} (data=2, model=2)")


@pytest.mark.parametrize("case", ["gan_sgd", "gan_adam"])
def test_replicated_leaves_bit_equal_across_ranks(ranks, case):
    """The leaves the placement keeps whole (biases, narrow weights)
    after the step(s): the same bits on both model ranks of each data
    index, and on both data indices."""
    first = ranks[0][case]["replicated"]
    assert first
    for r in ranks[1:]:
        assert r[case]["replicated"].keys() == first.keys()
        for name, v in first.items():
            np.testing.assert_array_equal(r[case]["replicated"][name], v, err_msg=name)


@pytest.fixture(scope="module")
def adam_truth():
    """Two float64 Adam steps of the port in one process at the global
    batch."""
    cfg = make_config(overrides())
    state, gen, disc, g_opt, d_opt = ranks_side.f64_state(cfg)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    metrics = ranks_side.run_steps(state, step, ADAM_SEEDS)
    return {"metrics": metrics, "state": ranks_side.state_np(state)}


def _groups(state: dict) -> dict:
    """A state's leaves by what they are: weights and statistics of each
    model, the EMA weights, each optimizer's state."""
    out = {}
    for k, v in state.items():
        out.setdefault(k.split(".")[0], {})[k] = v
    return out


def test_gan_step_float64_equals_one_process(ranks, adam_truth):
    """Two Adam steps (EMA on) on {data: 2, model: 2}: every rank's
    gathered state (both models, EMA, both Adam states) within 1e-12 of
    one process in relative L2, group by group; metrics at 1e-6 (the
    pixel and cross-entropy losses cast to float32)."""
    want = _groups(adam_truth["state"])
    for r in ranks:
        got = _groups(r["gan_adam"]["state"])
        assert got.keys() == want.keys() == {"gen", "disc", "ema", "g_opt", "d_opt"}
        for group, leaves in want.items():
            assert _rel_l2(got[group], leaves) <= F64_REL_L2, group
        _close_metrics(r["gan_adam"]["metrics"], adam_truth["metrics"], F64_METRIC_RTOL)


# --------------------------------------------------------------------------
# (d) the full-size synthesis, (e) memory


@pytest.fixture(scope="module")
def jax_full_synthesis(full_size):
    fs = full_size
    fn = jax.jit(jax_make_synthesize_fn(fs["jcfg"], fs["jgen"]))
    return np.asarray(fn(fs["params"], {k: jnp.asarray(v) for k, v in fs["batch"].items()},
                         jnp.asarray(fs["z"])))


def test_full_size_synthesis_matches_jax(ranks, jax_full_synthesis):
    """The fm 1.0 f32 synthesis on pair 0 ({data: 1, model: 2}, JAX's
    default rule: the generator's 71 column- and 11 row-parallel weights)
    within 5e-4 of JAX's on the same weights, on both ranks; each rank
    holds under 0.6 of the weights' bytes."""
    want = jax_full_synthesis
    assert np.isfinite(want).all() and np.abs(want).max() > 1e-3
    for r in (0, 1):
        got = ranks[r]["synthesis"]
        assert got["kinds"] == {"column": 71, "row": 11}
        assert got["out"].shape == want.shape == (1, 128, 128, 3)
        assert float(np.max(np.abs(got["out"] - want))) <= 5e-4
        before, after = got["bytes"]
        assert after < 0.6 * before, (after, before)


@pytest.mark.parametrize("model_rank", [0, 1])
def test_params_and_adam_per_rank_below_0_8_at_full_width(model_rank):
    """Parameters + Adam moments of both full-size models (on meta) on a
    model axis of 2, each rank's slice of every sharded leaf: under 0.8 of
    one device's (tests/test_parallel.py:181); measured 0.535."""
    cfg = make_config({})
    gen, disc = _meta_models(cfg)
    opts = []
    for m in (gen, disc):
        opt = adam_wgan(m.parameters(), 1e-4, 0.5, 0.9)
        for p in m.parameters():
            p.grad = torch.zeros_like(p)
        opt.step()  # Adam's moments, as optax's init holds them
        opts.append(opt)
    state = GANTrainState(0, gen, disc, *opts, {})
    tree = lambda: (list(gen.parameters()), list(disc.parameters()), *opts)  # noqa: E731
    whole_bytes = per_device_bytes(tree())
    place(state, shard_gan_state(_port_mesh(model_rank), state))
    share = per_device_bytes(tree()) / whole_bytes
    assert share < 0.8, share
    assert 0.5 < share < 0.56, share


# --------------------------------------------------------------------------
# (f) checkpoints


@pytest.fixture(scope="module")
def resume_truth():
    """The one-process run the mesh resumes, both of its steps in this
    process (a checkpoint's write and read are exact)."""
    cfg = make_config(overrides())
    return ranks_side.state_np(ranks_side.one_process_steps(cfg, ADAM_SEEDS))


def _shapes(payload):
    out = {part: {k: tuple(v.shape) for k, v in payload[part].items()}
           for part in ("gen", "disc", "g_ema")}
    for part in ("g_opt", "d_opt"):
        out[part] = {(i, k): tuple(v.shape) for i, per in payload[part]["state"].items()
                     for k, v in per.items()}
    return out


def test_checkpoint_of_a_tp_run_resumes_in_one_process(ranks, cases):
    """Pair 1 took a step on its mesh, saved it, took a second step; the
    file holds a single device's keys and whole shapes (those of the
    one-process file pair 0 resumed), and one process that restores it
    and takes the same second step reaches the mesh's state within 1e-12,
    group by group."""
    directory = cases["tp_checkpoint"]["directory"]
    load = lambda d: torch.load(os.path.join(d, "1", "state.pt"), weights_only=True)  # noqa
    assert _shapes(load(directory)) == _shapes(load(cases["resume_on_mesh"]["directory"]))
    cfg = make_config(overrides())
    state, gen, disc, g_opt, d_opt = ranks_side.f64_state(cfg, seed=7)
    state = restore_gan_checkpoint(directory, state)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    state, _ = step(state, ranks_side.f64_batch(ADAM_SEEDS[1]), torch.Generator().manual_seed(1))
    want = _groups(ranks_side.state_np(state))
    for r in (2, 3):
        got = _groups(ranks[r]["tp_checkpoint"])
        for group, leaves in want.items():
            assert _rel_l2(got[group], leaves) <= F64_REL_L2, (r, group)


def test_checkpoint_of_one_process_resumes_on_the_mesh(ranks, resume_truth):
    """A one-process checkpoint restored into pair 0's sharded state (each
    rank its slices of the whole tensors) and the second step on the
    mesh, against the same two steps in one process."""
    want = _groups(resume_truth)
    for r in (0, 1):
        got = _groups(ranks[r]["resume_on_mesh"]["state"])
        for group, leaves in want.items():
            assert _rel_l2(got[group], leaves) <= F64_REL_L2, (r, group)
        shapes = ranks[r]["resume_on_mesh"]["local_shapes"]
        assert shapes["global_pathway.fc1.weight"][0] == 256  # column-parallel: 512 / 2


# --------------------------------------------------------------------------
# (g) the detector


@pytest.fixture(scope="module")
def detector_truth(cases):
    """The port's detector step in one process, float64 and float32."""
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    out = {}
    for dtype in ("64", "32"):
        case = cases[f"detector:{dtype}"]
        cfg = make_config(case["overrides"])
        state, model, opt = create_pretrain_state(cfg, seed=0, device="cpu")
        model.load_state_dict(case["model"])
        if case.get("dtype") == "float64":
            model.double()
        step = make_pretrain_step(cfg, model, opt)
        images = case["images"].astype(case.get("dtype", "float32"))
        _, metrics = step(state, images, case["labels"], u=case["u"])
        out[dtype] = {"metrics": {k: float(v) for k, v in metrics.items()},
                      "grad": ranks_side._grads(model),
                      "stats": {k: v.numpy().copy() for k, v in model.state_dict().items()
                                if "running" in k}}
    return out


@pytest.mark.parametrize("dtype", ["64", "32"])
def test_detector_step_matches_one_process(ranks, detector_truth, dtype):
    """The detector's step at 128 on pair 1 ({data: 1, model: 2}, JAX's
    default rule: the depthwise convs column-parallel among its sharded
    layers) against one process: float64 at 1e-10 (gradients and
    statistics) and 1e-6 (metrics), float32 at the dryrun bar and 2.5e-2
    of the float64 truth's gradients."""
    truth = detector_truth["64"]
    for r in (2, 3):
        got = ranks[r][f"detector:{dtype}"]
        assert got["sharded"] == 45  # 27 column- and 18 row-parallel weights
        if dtype == "64":
            _close_metrics(got["metrics"], truth["metrics"], F64_METRIC_RTOL)
            assert _rel_l2(got["grad"], truth["grad"]) <= DETECTOR_F64_REL_L2
            assert _rel_l2(got["stats"], truth["stats"]) <= DETECTOR_F64_REL_L2
            continue
        assert_metrics_match(got["metrics"], detector_truth["32"]["metrics"])
        assert _rel_l2(got["grad"], truth["grad"]) <= DETECTOR_F32_REL_L2
        for name, want in detector_truth["32"]["stats"].items():
            np.testing.assert_allclose(got["stats"][name], want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


# --------------------------------------------------------------------------
# the loop, the int8 refusal


def test_gan_loop_over_the_2x2_mesh(ranks, cases):
    """run_gan_training(mesh=) on {data: 2, model: 2} for 2 steps at fm
    0.25 under JAX's default rule: rank 0 alone samples, from a whole copy
    of the generator (no layer sharded) that every rank helped gather; one
    checkpoint, at step 2, in the single-device format; every rank ends
    with the same whole generator."""
    for r, out in enumerate(ranks):
        assert out["loop"]["samples"] == ([(2, 0)] if r == 0 else [])
        assert out["loop"]["files"] == ["2"]
        assert out["loop"]["sharded"] > 0
        for name, v in ranks[0]["loop"]["g"].items():
            np.testing.assert_array_equal(out["loop"]["g"][name], v, err_msg=name)
    cfg = make_config(cases["loop"]["overrides"])
    state = create_gan_state(cfg, 0, "cpu")[0]
    restore_gan_checkpoint(cases["loop"]["checkpoint_dir"], state)
    for name, p in state.gen.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), ranks[0]["loop"]["g"][name])


def test_int8_refuses_a_sharded_layer():
    """JAX's serving takes no mesh: quantizing a sharded layer raises."""
    layer = Conv2d(8, 512, 3)
    place(layer, infer_param_shardings(_port_mesh(), layer))
    assert layer.tp is not None and layer.weight.shape[0] == 256
    with pytest.raises(ValueError, match="model axis"):
        quant.prepare_int8(layer)
