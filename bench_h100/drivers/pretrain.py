"""Driver ``pretrain``: landmark-detector pretraining through the port's
eager step (``train/pretrain.make_pretrain_step``), as its ``run_pretrain``
runs it.

Set-up makes the detector's weights on the card from the seed, builds the
port's pretrain state (SGD with Nesterov momentum and weight decay, the
epoch schedule), ``pool`` synthetic uint8 images at ``image_size`` with
four landmarks each on the card, and the port's device sampler over them
(``device_bucketed_batch_iterator``, batches of ``batch``). Its first
``checked_steps`` steps go through the same step the window calls; the
window then runs steps until ``--seconds`` have passed.

``correct``: the loss's assignment of positives is a discrete choice made
from the predictions, and at random weights rounding flips it (the
absolute head's clamped predictions tie at the origin), which moves the
loss and every gradient by more than the precision does. So the
reference checks the first step's forward by itself and then follows the
program's assignment: it derives each step's assignment from the
program's returned predictions (and counts where the program's own
assignment differs from it), and computes its own step with it.
Past the first step rounding grows even under a fixed assignment
(a float32 perturbation of 1e-7 of the weights moves the third step's
loss by 7% on the CPU), so what is compared comes from the first step:
its forward's predictions (relative L2), the assignment mismatches, and
the worst convolution kernel's (4-D leaf's) first gradient and change.
The BatchNorm scales and shifts are left out of the worst leaf: their
gradients, per-channel sums over the batch and the image, are
ill-conditioned at random weights (on the CPU at batch 8, the reference
with its conv inputs and weights cut to TF32's 10-bit mantissa reads
0.17-0.32 against itself there, and 0.06-0.09 on the kernels).
The worst of all leaves, the median leaf's change, the change after the
last checked step and each step's loss are kept as readings.
"""

from __future__ import annotations

import statistics
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from bench_h100 import harness, port, weights
from bench_h100.counts import flops
from bench_h100.reference import detector as ref

# a frontal face's eye, eye, nose and mouth in a 256-px crop, (x, y)
FACE = np.array([[90.0, 100.0], [166.0, 100.0], [128.0, 150.0], [128.0, 190.0]])


def make_pool(n: int, size: int, seed: int, device):
    """``n`` uint8 NHWC images drawn on the card and their (n, 8) landmark
    labels, each landmark drawn around ``FACE`` (scaled to ``size``) with a
    12-px spread."""
    g = torch.Generator(device=device).manual_seed(seed)
    images = torch.randint(0, 256, (n, size, size, 3), generator=g, device=device,
                           dtype=torch.uint8)
    centre = torch.as_tensor(FACE * size / 256.0, dtype=torch.float32, device=device)
    labels = (centre[None] + 12.0 * torch.randn((n, 4, 2), generator=g, device=device))
    return images, labels.clamp(0.0, size - 1.0).reshape(n, 8)


class Judge:
    """The reference's side of ``correct``: the checked steps' batches and
    the program's predictions of each, kept by the benchmark."""

    def __init__(self, conf, host: Dict[str, torch.Tensor], batches: List, prog_loc: List,
                 noise_seed: int, device):
        self.conf, self.host, self.batches, self.prog_loc = conf, host, batches, prog_loc
        self.noise_seed, self.device = noise_seed, device

    def follow(self, rounding: Optional[Callable] = None, half_batch: bool = False,
               own_assignment: bool = False, tf32: bool = False) -> Dict[str, Any]:
        """The reference's readings over the checked steps, each step's
        assignment derived from the program's predictions (from its own
        with ``own_assignment``); with ``rounding`` or ``half_batch`` the
        control or a planted fault in the program's place; with ``tf32``
        its products in TF32, as the configuration runs the convs."""
        dev, o = self.device, self.conf["optimizer"]
        w = port.to_device(self.host, dev)
        params = {k: v.clone().requires_grad_(True) for k, v in w.items()
                  if v.dtype.is_floating_point and "running" not in k}
        buffers = {k: v for k, v in w.items() if k not in params}
        opt = ref.SGD(params, o["learning_rate"], o["momentum"], o["weight_decay"])
        g = torch.Generator(device=dev).manual_seed(self.noise_seed)
        out: Dict[str, Any] = {"losses": [], "locs": []}
        with harness.tf32_off(not tf32):
            for i, (images, labels) in enumerate(self.batches):
                n_anchors = self.prog_loc[i].shape[1]
                u = torch.rand((images.shape[0], n_anchors), generator=g, device=dev)
                # predictions for other rows than the batch's cannot be followed
                follow = (not own_assignment
                          and self.prog_loc[i].shape[0] == images.shape[0])
                loss, loc, cls = ref.pretrain_step(
                    params, buffers, opt, images, labels, u, self.conf["loss"],
                    assign_from=self.prog_loc[i] if follow else None,
                    rounding=rounding, half_batch=half_batch)
                out["losses"].append(loss)
                out["locs"].append(loc)
                if i == 0:
                    out["pred"] = (loc, cls)
                    out["kernels"] = [k for k, v in params.items() if v.dim() == 4]
                    out["grad"] = {k: float((opt.buf[k] - o["weight_decay"] * w[k]).norm())
                                   for k in params}
                    out["change1"] = {k: float((params[k].detach() - w[k]).norm()) for k in params}
            out["change"] = {k: float((params[k].detach() - w[k]).norm()) for k in params}
        return out

    def assignment_mismatch(self, prog_assigned: List[torch.Tensor]) -> float:
        """Anchors, over the checked steps, where the program's assignment
        differs from the one the reference derives from the program's own
        predictions."""
        ratio = self.conf["loss"]["distance_threshold_ratio"]
        bad = 0
        for (images, labels), loc, assigned in zip(self.batches, self.prog_loc, prog_assigned):
            if loc.shape[0] != labels.shape[0]:
                return float("inf")
            mine = ref.assignment(loc.float(), labels.float(), ratio)
            bad += int((mine != assigned).sum())
        return float(bad)


def rel_l2(prog, reference) -> float:
    """Relative L2 gap of the (loc, cls) predictions, over the rows both
    hold."""
    rows = min(prog[0].shape[0], reference[0].shape[0])
    a = torch.cat([t[:rows].float().flatten() for t in prog])
    b = torch.cat([t[:rows].float().flatten() for t in reference])
    return float((a - b).norm() / b.norm())


def compare(prog: Dict[str, Any], reading: Dict[str, Any], mismatch: float) -> Dict[str, Any]:
    """``pred_gap``: the first forward's predictions; ``assign_mismatch``;
    ``grad1_conv_gap`` and ``change1_conv_gap``: the worst convolution
    kernel's first gradient and change over the first step, against the
    larger of its and the median kernel's reference norm. Readings: the
    median leaf's change, the worst of all leaves' first gradient and
    change (after the first and after the last checked step), each step's
    loss, and the worst leaves' names."""
    med_p = statistics.median(prog["change1"].values())
    med_r = statistics.median(reading["change1"].values())
    out: Dict[str, Any] = {
        "pred_gap": rel_l2(prog["pred"], reading["pred"]),
        "assign_mismatch": mismatch,
        "median_change_gap": abs(med_p - med_r) / med_r,
        "loss_gaps": [harness.rel_gap(a, b) for a, b in zip(prog["losses"], reading["losses"])],
    }
    for name, key, leaves in (("grad1_conv_gap", "grad", reading["kernels"]),
                              ("change1_conv_gap", "change1", reading["kernels"]),
                              ("grad_gap", "grad", None), ("change1_gap", "change1", None),
                              ("change_gap", "change", None)):
        out[name], out[f"{name}_leaf"] = harness.leaf_gap(prog[key], reading[key], leaves)
    return out


def unchanged(reading: Dict[str, Any]) -> Dict[str, Any]:
    """A step that returns its state unchanged: no gradient in the
    optimizer and no change."""
    zero = lambda d: {k: 0.0 for k in d}  # noqa: E731
    return {**reading, "grad": zero(reading["grad"]), "change1": zero(reading["change1"]),
            "change": zero(reading["change"])}


def changes(named, host, dev) -> List[float]:
    """Each leaf's norm of change from its seeded start."""
    return torch.stack([(p - host[n].to(dev, non_blocking=True)).norm()
                        for n, p in named]).tolist()


def run(r: harness.Run) -> None:
    from tpgan_tpu_torch.data.packing import device_bucketed_batch_iterator
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    conf, tr = r.cell.config, r.cell.traffic
    dev = r.device
    b, size, pool = int(tr["batch"]), int(conf["image_size"]), int(tr["pool"])
    cfg = port.detector_config(conf, b)
    state, model, opt = create_pretrain_state(cfg, 0, dev, steps_per_epoch=max(pool // b, 1))
    w = port.seeded("detector", harness.sub_seed(r.seed, 1), dev)
    weights.load(model, w)
    host = port.to_host(w)
    del w
    r.reset_memory_peak()  # the benchmark's own staging of the weights left out
    images, labels = make_pool(pool, size, harness.sub_seed(r.seed, 4), dev)
    batches = device_bucketed_batch_iterator({(size, size, 3): {"img": images, "label": labels}},
                                             b, seed=harness.sub_seed(r.seed, 5))
    step = make_pretrain_step(cfg, model, opt, state.scheduler)
    noise_seed = harness.sub_seed(r.seed, 6)
    generator = torch.Generator(device=dev).manual_seed(noise_seed)
    wd = conf["optimizer"]["weight_decay"]

    # the first steps, through the window's step: the ones the reference checks
    kept, locs, assigned, losses = [], [], [], []
    named = list(model.named_parameters())
    for i in range(int(tr["checked_steps"])):
        x, y = next(batches)
        kept.append((x.clone(), y.clone()))
        state, metrics, aux = step(state, x, y, generator, return_aux=True)
        locs.append(aux["loc"])
        assigned.append(aux["assigned"])
        losses.append(metrics["loss"])
        if i == 0:
            pred = (aux["loc"], aux["cls"])
            with torch.no_grad():
                grad = torch.stack([(opt.state[p]["momentum_buffer"]
                                     - wd * host[n].to(dev, non_blocking=True)).norm()
                                    for n, p in named]).tolist()
                change1 = changes(named, host, dev)
    with torch.no_grad():
        change = changes(named, host, dev)
    prog = {"pred": pred, "losses": [float(v) for v in losses],
            "grad": {n: v for (n, _), v in zip(named, grad)},
            "change1": {n: v for (n, _), v in zip(named, change1)},
            "change": {n: v for (n, _), v in zip(named, change)}}
    del named
    r.setup_done()

    history = []

    def dispatch():
        nonlocal state
        with r.span("fetch"):
            x, y = next(batches)
        with r.span("dispatch"):
            state, m = step(state, x, y, generator)
        history.append(m["loss"])

    calls, elapsed = harness.window(r, dispatch)
    r.e2e["pretrain_images_per_s"] = calls * b / elapsed
    r.attempted = calls
    r.failed = int((~torch.isfinite(torch.stack(history))).sum())
    r.window_closed()
    if r.trace_on:
        units = int(tr["trace_steps"])
        r.trace = harness.traced(r, dispatch, units)
        r.counts.update(traced_units=units)
    r.counts.update(flops_per_image=sum(flops.pretrain_terms(b, size).values()),
                    peak_flops=float(conf["peak_flops"]))

    del state, model, opt, step, batches, images, labels, history
    r.free()
    judge = Judge(conf, host, kept, locs, noise_seed, dev)
    reading = judge.follow()
    values = compare(prog, reading, judge.assignment_mismatch(assigned))
    harness.judge(r, values)
    r.info.update(losses=prog["losses"], reference_losses=reading["losses"])
    r.judge, r.judge_prog, r.judge_ref = judge, prog, reading
