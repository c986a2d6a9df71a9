"""The rank side of ``tests/test_torch_parallel.py``: what each of two
gloo ranks on the CPU runs, in one spawned process per rank
(``parallel.distributed.spawn``). It imports the port only (no JAX), and
returns numpy results that the test holds against JAX and against the
port in one process at the global batch."""

from __future__ import annotations

import os

import torch

from tpgan_tpu_torch.config import MeshConfig, make_config
from tpgan_tpu_torch.ops.blocks import BatchNorm2d, set_compute_dtype, sync_batch_stats
from tpgan_tpu_torch.parallel import make_mesh
from tpgan_tpu_torch.parallel.collectives import all_reduce_sum
from tpgan_tpu_torch.train.gan_trainer import (
    GANTrainState,
    build_models,
    make_gan_train_step,
    make_multi_step,
)
from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

SGD_LR = 1e-2


def _np(d):
    return {k: v.detach().numpy().copy() for k, v in d.items()}


def _grads(module):
    return {k: p.grad.numpy().copy() for k, p in module.named_parameters() if p.grad is not None}


def _stats(module):
    return {k: v.numpy().copy() for k, v in module.state_dict().items() if "running" in k}


def gan_models(cfg, case):
    """(generator, critic) with the case's weights, in its ``dtype``
    (float32 unless float64 is named: a float64 model computes in
    float64 but for the losses' float32 casts)."""
    gen, disc = build_models(cfg, "cpu")
    gen.load_state_dict(case["gen"], strict=True)
    disc.load_state_dict(case["disc"], strict=True)
    if case.get("dtype") == "float64":
        for m in (gen, disc):
            set_compute_dtype(m.double(), torch.float64)
    return gen, disc


def as_dtype(tree, case):
    """Float arrays of a batch or noise dict in the case's dtype."""
    if case.get("dtype") != "float64":
        return tree
    return {k: v.astype("float64") if v.dtype.kind == "f" else v for k, v in tree.items()}


def gan_step(mesh, case):
    """One SGD step on this rank's rows from the given weights, with the
    given global noise: metrics, gradients, running statistics, weights."""
    cfg = make_config(case["overrides"])
    gen, disc = gan_models(cfg, case)
    g_opt = torch.optim.SGD(gen.parameters(), lr=SGD_LR)
    d_opt = torch.optim.SGD(disc.parameters(), lr=SGD_LR)
    state = GANTrainState(0, gen, disc, g_opt, d_opt,
                          {n: p.detach().clone() for n, p in gen.named_parameters()})
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    rows = mesh.rows(len(case["batch"]["img"]))
    batch = {k: v[rows] for k, v in as_dtype(case["batch"], case).items()}
    state, metrics = step(state, batch, torch.Generator().manual_seed(0),
                          as_dtype(case["noise"], case))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g_grad": _grads(gen), "d_grad": _grads(disc),
            "g_stats": _stats(gen), "d_stats": _stats(disc),
            "g": _np(dict(gen.named_parameters())), "rows": (rows.start, rows.stop)}


def multi_step_refusal(mesh, case):
    cfg = make_config(case["overrides"])
    gen, disc = build_models(cfg, "cpu")
    opts = [torch.optim.SGD(m.parameters(), lr=SGD_LR) for m in (gen, disc)]
    try:
        make_multi_step(make_gan_train_step(cfg, gen, disc, *opts, mesh=mesh), 2)
    except RuntimeError as e:
        return str(e)
    return None


def batch_norm(mesh, case):
    """The synced BatchNorm on this rank's rows: train-mode output,
    running statistics, and the gradients of sum(y * cot) in x, scale and
    bias; then the double backward of sum((dL/dx)^2). Parameter gradients
    are summed over the ranks (each rank holds its rows' part)."""
    x_all, cot_all = case["x"], case["cot"]
    rows = mesh.rows(len(x_all))
    bn = BatchNorm2d(x_all.shape[1])
    bn.load_state_dict(case["state"])
    sync_batch_stats(bn, mesh)
    bn.train()
    x = torch.tensor(x_all[rows], requires_grad=True)
    y = bn(x)
    loss = (y * torch.as_tensor(cot_all[rows])).sum()
    gx, gw, gb = torch.autograd.grad(loss, (x, bn.weight, bn.bias), create_graph=True)
    out = {"y": y.detach().numpy(), "gx": gx.detach().numpy(),
           "gw": all_reduce_sum(gw.detach(), mesh.group).numpy(),
           "gb": all_reduce_sum(gb.detach(), mesh.group).numpy(),
           "mean": bn.running_mean.numpy().copy(), "var": bn.running_var.numpy().copy()}
    g2x, g2w = torch.autograd.grad((gx * gx).sum(), (x, bn.weight))  # dL/dx holds no bias
    out.update(g2x=g2x.numpy(), g2w=all_reduce_sum(g2w, mesh.group).numpy())
    return out


def detector_step(mesh, case):
    """One detector SGD step on this rank's rows with the global uniforms:
    metrics, the loss's assignment on its rows, gradients, statistics."""
    cfg = make_config(case["overrides"])
    state, model, opt = create_pretrain_state(cfg, seed=0, device="cpu")
    model.load_state_dict(case["model"], strict=True)
    if case.get("dtype") == "float64":
        model.double()
    step = make_pretrain_step(cfg, model, opt, mesh=mesh)
    rows = mesh.rows(len(case["images"]))
    images = case["images"].astype(case.get("dtype", "float32"))
    state, metrics, aux = step(state, images[rows], case["labels"][rows], u=case["u"],
                               return_aux=True)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "assigned": aux["assigned"].numpy(), "keep_bg": aux["keep_bg"].numpy(),
            "grad": _grads(model), "stats": _stats(model)}


def gan_loop(mesh, case):
    """run_gan_training(mesh=) for 2 steps with a checkpoint, then a resume
    to 3: what rank 0's writer logged, the checkpoints on disk after each
    run, the final generator weights."""
    from tpgan_tpu_torch.train.loop import run_gan_training
    from tpgan_tpu_torch.train.metrics import MetricWriter

    cfg = make_config(case["overrides"])
    ck, logs = case["checkpoint_dir"], case["log_dir"]
    out = {}
    for steps, resume in ((2, False), (3, True)):
        writer = MetricWriter(logs, use_tensorboard=False)
        try:
            state = run_gan_training(cfg, iter(case["batches"]), steps=steps, checkpoint_dir=ck,
                                     resume=resume, writer=writer, log_every=1, mesh=mesh,
                                     device="cpu")
        finally:
            writer.close()
        out[f"ckpts_{steps}"] = sorted(os.listdir(ck))
    out["g"] = _np(dict(state.gen.named_parameters()))
    return out


class _Writer:
    def __init__(self):
        self.lines = []

    def write(self, step, metrics):
        self.lines.append((int(step), {k: float(v) for k, v in metrics.items()}))


def pretrain_run(mesh, case):
    """run_pretrain(mesh=) for one epoch with validation: the logged
    metrics, the files written, the final weights and statistics."""
    from tpgan_tpu_torch.train.pretrain import run_pretrain

    cfg = make_config(case["overrides"])
    writer = _Writer()
    state = run_pretrain(cfg, iter(case["batches"]), val_batches_fn=lambda: iter(case["val"]),
                         steps_per_epoch=len(case["batches"]), writer=writer,
                         checkpoint_dir=case["checkpoint_dir"], mesh=mesh, device="cpu")
    return {"lines": writer.lines, "files": sorted(os.listdir(case["checkpoint_dir"])),
            "state": {k: v.numpy().copy() for k, v in state.model.state_dict().items()}}


def run(rank: int, cases: dict) -> dict:
    """Every case on this rank, in one process group of two."""
    torch.set_num_threads(2)
    mesh = make_mesh(MeshConfig(data=2))
    out = {"rank": mesh.rank, "shape": mesh.shape, "backend": mesh.backend}
    steps = {"batch_norm": batch_norm, "gan": gan_step, "multi_step": multi_step_refusal,
             "detector": detector_step, "loop": gan_loop, "pretrain": pretrain_run}
    for name, case in cases.items():
        out[name] = steps[name.split(":")[0]](mesh, case)
    return out
