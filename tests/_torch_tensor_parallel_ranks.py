"""The rank side of ``tests/test_torch_tensor_parallel.py``: what each of
four gloo ranks on the CPU runs, in one spawned process per rank
(``parallel.distributed.spawn``). Each rank builds the ``{data: 2, model:
2}`` mesh of the world and the ``{data: 1, model: 2}`` mesh of its pair
(ranks 0-1, ranks 2-3); a case runs on the mesh it names, and the pairs
run their cases side by side. It imports the port only (no JAX) and
returns numpy results that the test holds against JAX and against the
port in one process."""

from __future__ import annotations

import os

import numpy as np
import torch

from tpgan_tpu_torch.config import MeshConfig, make_config
from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
from tpgan_tpu_torch.ops.blocks import Conv2d, ConvTranspose2d, LinearBlock, set_compute_dtype
from tpgan_tpu_torch.parallel import (
    infer_param_shardings,
    make_mesh,
    per_device_bytes,
    place,
    shard_gan_state,
    whole,
)
from tpgan_tpu_torch.parallel.collectives import gather_tensor
from tpgan_tpu_torch.parallel.distributed import barrier
from tpgan_tpu_torch.parallel.mesh import data_group, model_group
from tpgan_tpu_torch.parallel.tensor_parallel import shard_module, sharded_layers
from tpgan_tpu_torch.train.checkpoint import restore_gan_checkpoint, save_checkpoint
from tpgan_tpu_torch.train.gan_trainer import (
    GANTrainState,
    build_generator,
    build_models,
    create_gan_state,
    make_gan_train_step,
    make_synthesize_fn,
)
from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

SGD_LR = 1e-2
MIN_SHARD_DIM = 16  # the narrow step's rule, as tests/test_parallel.py:286
GAN_BATCH = 4
F64_BATCH = 2  # the float64 steps' global batch: one row per data index
PATCH_KEYS = ("img", "left_eye", "right_eye", "nose", "mouth")

# (name, layer factory, input shape): the column- and row-parallel layers
# at min_shard_dim 8 on two model ranks
LAYERS = {
    "conv_column": (lambda: Conv2d(6, 8, 3, 1, 1), (3, 6, 6, 6)),
    "conv_column_reflect_stride2": (lambda: Conv2d(6, 8, 4, 2, (1, 2, 1, 2)), (3, 6, 7, 7)),
    "conv_row": (lambda: Conv2d(8, 5, 3, 1, 1), (3, 8, 6, 6)),
    "conv_depthwise": (lambda: Conv2d(8, 8, 3, 2, 1, groups=8), (3, 8, 7, 7)),
    "deconv_column": (lambda: ConvTranspose2d(6, 8, 3, 2, 1, 1), (3, 6, 4, 4)),
    "deconv_row": (lambda: ConvTranspose2d(8, 5, 4, 2, 1), (3, 8, 4, 4)),
    "linear_column": (lambda: LinearBlock(6, 8), (3, 6)),
    "linear_row": (lambda: LinearBlock(8, 5), (3, 8)),
}
LAYER_MIN_SHARD_DIM = 8


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().copy()


def layer_case(name: str, dtype: torch.dtype, seed: int = 0):
    """(layer, x, cot) of a ``LAYERS`` case, seeded, in ``dtype``."""
    make, shape = LAYERS[name]
    torch.manual_seed(seed)
    layer = make().to(dtype)
    rng = np.random.RandomState(seed + 1)
    x = torch.tensor(rng.standard_normal(shape), dtype=dtype, requires_grad=True)
    return layer, x


def layer_products(layer, x):
    """y; dL/dx of L = sum(y^2) / 2 + sum(y) taken with create_graph; then
    the gradients of the penalty sum((dL/dx)^2) (the GP's double backward)
    in x, the weight and the bias: numpy, the weight's whole."""
    y = layer(x)
    gx, = torch.autograd.grad((y * y).sum() / 2 + y.sum(), x, create_graph=True)
    g2 = torch.autograd.grad((gx * gx).sum() + y.sum(), (x, layer.weight, layer.bias))
    gw = g2[1]
    if layer.tp is not None:
        gw = gather_tensor(gw, layer.tp.dim, layer.tp.mesh.model_group)
    return {"y": _np(y), "gx": _np(gx), "g2x": _np(g2[0]), "g2w": _np(gw), "g2b": _np(g2[2])}


def products(mesh, case):
    """Every ``LAYERS`` case in ``case["dtype"]``, sharded by the rule at
    LAYER_MIN_SHARD_DIM (``shard_module``): its placement and products."""
    dtype = getattr(torch, case["dtype"])
    out = {}
    for name in LAYERS:
        layer, x = layer_case(name, dtype)
        placed = shard_module(layer, mesh, LAYER_MIN_SHARD_DIM)
        assert placed == {"weight": layer.tp}
        out[name] = {"kind": layer.tp.kind, "local": tuple(layer.weight.shape),
                     **layer_products(layer, x)}
    return out


def case_models(cfg, case):
    gen, disc = build_models(cfg, "cpu")
    gen.load_state_dict(case["gen"], strict=True)
    disc.load_state_dict(case["disc"], strict=True)
    return gen, disc


def _grads(module) -> dict:
    """{name: the whole gradient} of a module's parameters (gathered where
    the weight is sharded)."""
    sharded = {f"{n}.weight": layer.tp for n, layer in sharded_layers(module) if layer.tp}
    out = {}
    for name, p in module.named_parameters():
        g = p.grad
        if name in sharded:
            g = gather_tensor(g, sharded[name].dim, sharded[name].mesh.model_group)
        out[name] = _np(g)
    return out


def _replicated(state) -> dict:
    """This rank's copies of every leaf the placement keeps whole."""
    sharded = {f"gen.{n}.weight" for n, layer in sharded_layers(state.gen) if layer.tp}
    sharded |= {f"disc.{n}.weight" for n, layer in sharded_layers(state.disc) if layer.tp}
    leaves = {f"gen.{n}": p for n, p in state.gen.named_parameters()}
    leaves.update({f"disc.{n}": p for n, p in state.disc.named_parameters()})
    return {k: _np(v) for k, v in leaves.items() if k not in sharded}


def gan_sgd(mesh, case):
    """One SGD step of the fm 0.25 f32 GAN on this rank's rows, from the
    case's weights, with the given global noise, the weights placed by the
    rule at MIN_SHARD_DIM: metrics, whole gradients, the replicated leaves,
    the bytes this rank holds and the placement's counts."""
    cfg = make_config(case["overrides"])
    gen, disc = case_models(cfg, case)
    g_opt = torch.optim.SGD(gen.parameters(), lr=SGD_LR)
    d_opt = torch.optim.SGD(disc.parameters(), lr=SGD_LR)
    state = GANTrainState(0, gen, disc, g_opt, d_opt, {})
    sh = shard_gan_state(mesh, state, min_shard_dim=MIN_SHARD_DIM)
    before = per_device_bytes([gen, disc])
    place(state, sh)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    rows = mesh.rows(len(case["batch"]["img"]))
    batch = {k: v[rows] for k, v in case["batch"].items()}
    state, metrics = step(state, batch, torch.Generator().manual_seed(0), case["noise"])
    kinds = [layer.tp.kind for m in (gen, disc) for _n, layer in sharded_layers(m) if layer.tp]
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g_grad": _grads(gen), "d_grad": _grads(disc), "replicated": _replicated(state),
            "bytes": (before, per_device_bytes([gen, disc])),
            "kinds": {k: kinds.count(k) for k in ("column", "row")}}


def f64_state(cfg, seed: int = 0):
    """``create_gan_state`` (Adam, EMA) in float64."""
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=seed, device="cpu")
    for m in (gen, disc):
        set_compute_dtype(m.double(), torch.float64)
    for name, t in state.g_ema_params.items():
        state.g_ema_params[name] = t.double()
    return state, gen, disc, g_opt, d_opt


def f64_batch(seed: int):
    return {k: v.astype("float64") if v.dtype.kind == "f" else v
            for k, v in synthetic_gan_batch(F64_BATCH, seed=seed).items()}


def state_np(state) -> dict:
    """The state's whole tensors as numpy: both models' ``state_dict``, the
    EMA weights and both optimizers' per-parameter state."""
    with whole(state):
        out = {f"gen.{k}": _np(v) for k, v in state.gen.state_dict().items()}
        out.update({f"disc.{k}": _np(v) for k, v in state.disc.state_dict().items()})
        out.update({f"ema.{k}": _np(v) for k, v in state.g_ema_params.items()})
        for tag, opt, model in (("g_opt", state.g_opt, state.gen),
                                ("d_opt", state.d_opt, state.disc)):
            names = {id(p): n for n, p in model.named_parameters()}
            for p, per in opt.state.items():
                for k, v in per.items():
                    out[f"{tag}.{names[id(p)]}.{k}"] = _np(v)
    return out


def run_steps(state, step, seeds, mesh=None):
    """One step per batch seed, the step generator seeded 0 once; returns
    the last metrics."""
    generator = torch.Generator().manual_seed(0)
    metrics = None
    for seed in seeds:
        batch = f64_batch(seed)
        if mesh is not None:
            batch = {k: v[mesh.rows(F64_BATCH)] for k, v in batch.items()}
        state, metrics = step(state, batch, generator)
    return {k: float(v) for k, v in metrics.items()}


def gan_adam(mesh, case):
    """Two float64 Adam steps (EMA on) of the fm 0.25 GAN from seed 0 on
    this rank's rows, placed by the rule at MIN_SHARD_DIM: metrics, the
    gathered state, the replicated leaves."""
    cfg = make_config(case["overrides"])
    state, gen, disc, g_opt, d_opt = f64_state(cfg)
    place(state, shard_gan_state(mesh, state, min_shard_dim=MIN_SHARD_DIM))
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    metrics = run_steps(state, step, case["seeds"], mesh)
    return {"metrics": metrics, "state": state_np(state), "replicated": _replicated(state)}


def tp_checkpoint(mesh, case):
    """On this mesh, float64, fm 0.25, the rule at MIN_SHARD_DIM: a step
    from seed 0's weights, a checkpoint of the sharded state (read back in
    one process by the test), a second step with draws from a generator
    seeded 1. Returns the gathered state after it."""
    cfg = make_config(case["overrides"])
    state, gen, disc, g_opt, d_opt = f64_state(cfg)
    place(state, shard_gan_state(mesh, state, min_shard_dim=MIN_SHARD_DIM))
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    state, _ = step(state, f64_batch(case["seeds"][0]), torch.Generator().manual_seed(0))
    save_checkpoint(case["directory"], 1, state, mesh=mesh)
    state, _ = step(state, f64_batch(case["seeds"][1]), torch.Generator().manual_seed(1))
    return state_np(state)


def one_process_steps(cfg, seeds, directory=None):
    """Seed 3's float64 weights, one step per batch seed (the i-th step's
    draws from a generator seeded i) in one process, the state saved as
    step 1 after the first when a ``directory`` is given; returns the
    state."""
    state, gen, disc, g_opt, d_opt = f64_state(cfg, seed=3)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    for i, seed in enumerate(seeds):
        state, _ = step(state, f64_batch(seed), torch.Generator().manual_seed(i))
        if i == 0 and directory is not None:
            save_checkpoint(directory, 1, state)
    return state


def resume_on_mesh(mesh, case):
    """The mesh's first rank saves a one-process state after one step
    (``one_process_steps``); every rank restores it into a sharded state
    of other weights (each its slices of the whole tensors) and takes the
    second step on the mesh. Returns the gathered state and the
    generator's local shapes."""
    cfg = make_config(case["overrides"])
    if mesh.is_main:
        one_process_steps(cfg, case["seeds"][:1], case["directory"])
    barrier(mesh.world)
    state, gen, disc, g_opt, d_opt = f64_state(cfg, seed=7)
    place(state, shard_gan_state(mesh, state, min_shard_dim=MIN_SHARD_DIM))
    state = restore_gan_checkpoint(case["directory"], state)
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    state, _ = step(state, f64_batch(case["seeds"][1]), torch.Generator().manual_seed(1))
    return {"state": state_np(state),
            "local_shapes": {n: tuple(p.shape) for n, p in state.gen.named_parameters()}}


def synthesis(mesh, case):
    """The full-size (fm 1.0) f32 synthesis of the case's batch, the
    generator from the case's file placed by JAX's default rule: the
    output, the placement's counts and this rank's bytes."""
    cfg = make_config({"compute_dtype": "float32"})
    gen = build_generator(cfg, "cpu")
    gen.load_state_dict(torch.load(case["weights"], weights_only=True), strict=True)
    whole_bytes = per_device_bytes(gen)
    place(gen, infer_param_shardings(mesh, gen))
    kinds = [layer.tp.kind for _n, layer in sharded_layers(gen) if layer.tp]
    got = make_synthesize_fn(cfg, gen)(case["batch"], case["z"])
    return {"out": _np(got), "kinds": {k: kinds.count(k) for k in ("column", "row")},
            "bytes": (whole_bytes, per_device_bytes(gen))}


def detector(mesh, case):
    """One detector SGD step at 128 on the pair (every row on each rank),
    placed by JAX's default rule: metrics, whole gradients, statistics."""
    cfg = make_config(case["overrides"])
    state, model, opt = create_pretrain_state(cfg, seed=0, device="cpu")
    model.load_state_dict(case["model"], strict=True)
    if case.get("dtype") == "float64":
        model.double()
    place(state, infer_param_shardings(mesh, state))
    step = make_pretrain_step(cfg, model, opt, mesh=mesh)
    images = case["images"].astype(case.get("dtype", "float32"))
    state, metrics = step(state, images, case["labels"], u=case["u"])
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "grad": _grads(model),
            "stats": {k: _np(v) for k, v in model.state_dict().items() if "running" in k},
            "sharded": sum(1 for _n, layer in sharded_layers(model) if layer.tp)}


def gan_loop(mesh, case):
    """run_gan_training(mesh=) for 2 steps with a sample grid at step 2 and
    a checkpoint, the default rule: the files each rank sees, the
    generator's whole weights at the end."""
    from tpgan_tpu_torch.train.loop import run_gan_training

    cfg = make_config(case["overrides"])
    seen = []
    state = run_gan_training(cfg, iter(case["batches"]), steps=2,
                             checkpoint_dir=case["checkpoint_dir"], mesh=mesh, device="cpu",
                             sample_fn=lambda i, s: seen.append(
                                 (i, sum(1 for _n, l in sharded_layers(s.gen) if l.tp))),
                             sample_every=2)
    with whole(state.gen):
        g = {k: _np(v) for k, v in state.gen.named_parameters()}
    return {"samples": seen, "files": sorted(os.listdir(case["checkpoint_dir"])), "g": g,
            "sharded": sum(1 for _n, layer in sharded_layers(state.gen) if layer.tp)}


STEPS = {"products": products, "gan_sgd": gan_sgd, "gan_adam": gan_adam,
         "tp_checkpoint": tp_checkpoint, "resume_on_mesh": resume_on_mesh,
         "synthesis": synthesis, "detector": detector, "loop": gan_loop}


def run(rank: int, cases: dict) -> dict:
    """Every case on the mesh it names (``2x2``: all four ranks; ``pair0``
    / ``pair1``: ranks 0-1 / 2-3), in one process group of four."""
    torch.set_num_threads(1)
    grid = make_mesh(MeshConfig(data=2, model=2))
    pair = make_mesh(MeshConfig(data=1, model=2), devices=[0, 1] if rank < 2 else [2, 3])
    meshes = {"2x2": grid, f"pair{rank // 2}": pair}
    out = {"grid": (grid.rank, grid.model_rank, grid.shape, grid.backend),
           "pair": (pair.rank, pair.model_rank, pair.shape),
           "groups": (data_group(grid)[1:], model_group(grid)[1:], data_group(pair)[1:],
                      model_group(pair)[1:])}
    for name, case in cases.items():
        mesh = meshes.get(case["mesh"])
        if mesh is not None:
            out[name] = STEPS[name.split(":")[0]](mesh, case)
    return out
