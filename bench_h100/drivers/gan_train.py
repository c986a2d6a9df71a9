"""Driver ``gan_train``: TP-GAN training through the port's graphed multi-step.

Set-up makes the generator, critic and frozen identity embedder's weights
on the card from the seed, builds the port's GAN state, a device-resident
uint8 pack of ``pack_items`` synthetic items drawn from the seed and the
port's device sampler over it (``device_batch_iterator``), and
``make_multi_step(make_gan_train_step(...), steps_per_dispatch)``, whose
first call captures the step as a CUDA graph. That first dispatch is
also the start of training: its steps are the ones the reference follows.
The window then runs dispatches of ``steps_per_dispatch`` steps at
``batch``, each fed by stacking that many sampled batches, as the port's
training loop composes them (``train/loop.py``).

``correct`` compares the first step of that dispatch with the plain
reference (``reference/tpgan.py``) fed the same weights, rows and draws:
the step's D and G loss; the norm of each leaf's first gradient as the
optimizer holds it (Adam's first moment after the step); the norm of each
leaf's change from its seeded start, the update Adam applied; and the
norm of each leaf's change in the generator's EMA copy. The program's
are read between the dispatch's first and second graph replay. At random
weights the steps after the first amplify rounding (the first Adam
update moves every weight by about the learning rate, whatever the sign
of a gradient near zero), so later steps are not compared.

The first gradient is compared by the median leaf and by the identity
classifier's leaves (``HEAD``), not by the worst leaf of all: on some
seeds bf16 rounding scales the whole generator's backward by up to a
tenth, and a deep encoder conv by a third, with the reference in bf16
products moving the same leaves the same way. The classifier's gradient
takes no backward through a conv, and each row adds a part nearly
orthogonal to the others' (its own label and dropout mask), so its norm
shows how many rows the step averaged.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Callable, Dict, Optional

import torch

from bench_h100 import harness, port
from bench_h100.counts import flops, kernels
from bench_h100.reference import tpgan as ref

IMAGES = {"img": 128, "img64": 64, "img32": 32}
# the generator's identity classifier, the layer that makes its logits
HEAD = ("gen.feature_predict.fc.weight", "gen.feature_predict.fc.bias")


def item_shapes() -> Dict[str, tuple]:
    shapes = {}
    for key, size in IMAGES.items():
        shapes[key] = shapes[f"{key}_frontal"] = (size, size, 3)
    for part, ((h, w), _) in ref.PARTS.items():
        shapes[part] = shapes[f"{part}_frontal"] = (h, w, 3)
    return shapes


def make_pack(n: int, num_classes: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n`` synthetic uint8 NHWC items with the training set's keys and a
    label each, drawn on the card."""
    g = torch.Generator(device=device).manual_seed(seed)
    pack = {k: torch.randint(0, 256, (n, *s), generator=g, device=device, dtype=torch.uint8)
            for k, s in item_shapes().items()}
    pack["label"] = torch.randint(0, num_classes, (n,), generator=g, device=device,
                                  dtype=torch.int32)
    return pack


class Judge:
    """The reference's side of ``correct`` for one run: the inputs of the
    first dispatch, kept by the benchmark, and the comparison."""

    def __init__(self, conf, host: Dict[str, Dict[str, torch.Tensor]],
                 first: Dict[str, torch.Tensor], noise_seed: int, device):
        self.conf, self.host, self.first, self.noise_seed, self.device = \
            conf, host, first, noise_seed, device

    def follow(self, rounding: Optional[Callable] = None, half_batch: bool = False
               ) -> Dict[str, Any]:
        """The reference's readings of the first step; with ``rounding`` or
        ``half_batch`` the lower-precision control or a planted fault in the
        program's place."""
        dev, t = self.device, self.conf["train"]
        gw = {k: v.to(dev, copy=True).requires_grad_(True)
              for k, v in self.host["generator"].items()}
        dw = {k: v.to(dev, copy=True).requires_grad_(True) for k, v in self.host["critic"].items()}
        ew = port.to_device(self.host["embedder"], dev)
        opt_g = ref.Adam(gw, t["learning_rate"], t["beta1"], t["beta2"], t["eps"])
        opt_d = ref.Adam(dw, t["learning_rate"], t["beta1"], t["beta2"], t["eps"])
        g = torch.Generator(device=dev).manual_seed(self.noise_seed)
        start = time.perf_counter()
        with harness.tf32_off():
            batch = ref.decode_u8({key: v[0] for key, v in self.first.items()})
            noise = ref.draw_noise(g, batch["img"].shape[0])
            losses = ref.gan_step(gw, dw, ew, opt_g, opt_d, batch, noise, self.conf["loss"],
                                  rounding=rounding, half_batch=half_batch)
        decay = t["ema_decay"]
        with torch.no_grad():
            moment = {**{f"gen.{k}": float(m.norm()) for k, m in opt_g.m.items()},
                      **{f"disc.{k}": float(m.norm()) for k, m in opt_d.m.items()}}
            start_w = {**{f"gen.{k}": v for k, v in self.host["generator"].items()},
                       **{f"disc.{k}": v for k, v in self.host["critic"].items()}}
            now = {**{f"gen.{k}": v for k, v in gw.items()},
                   **{f"disc.{k}": v for k, v in dw.items()}}
            change = {k: float((now[k] - start_w[k].to(dev)).norm()) for k in now}
            # the EMA copy after one step from the start: decay * w0 + (1 - decay) * w1
            ema = {k: float(((1.0 - decay) * (now[k] - start_w[k].to(dev))).norm())
                   for k in now if k.startswith("gen.")}
        kernels = [k for k, v in start_w.items() if v.dim() >= 2]
        return {"losses": losses, "moment": moment, "change": change, "ema": ema,
                "kernels": kernels, "seconds": time.perf_counter() - start}


def compare(prog: Dict[str, Any], reference: Dict[str, Any]) -> Dict[str, Any]:
    """Gaps between the program's first step and the reference's:

    * ``loss1_gap``: the D and G loss, relative;
    * ``grad1_median_gap``: the median leaf's norm of Adam's first moment
      (the gradient as the optimizer holds it, times 1 - beta1), relative;
    * ``grad1_head_gap``: the worse of the ``HEAD`` leaves' moment norms,
      against the larger of that leaf's and their median's reference norm;
    * ``change1_gap``: the worst leaf's change from its start, against
      the larger of that leaf's and the median leaf's reference norm;
    * ``ema1_gap``: the same for each generator leaf's change in the EMA
      copy;
    * readings: ``grad1_gap``, the worst leaf's moment norm, measured as
      ``change1_gap``; ``grad1_kernel_gap`` and ``change1_kernel_gap``,
      the worst of the conv and linear kernels alone; ``loss1.<term>_gap``,
      each term of the two losses, relative; the worst leaf of each gap."""
    ref_m, prog_m = reference["moment"], prog["moment"]
    med_p = statistics.median(prog_m[k] for k in ref_m)
    med_r = statistics.median(ref_m.values())
    out: Dict[str, Any] = {
        "loss1_gap": max(harness.rel_gap(prog["losses"][name], reference["losses"][name])
                         for name in ("d_loss", "g_loss")),
        "grad1_median_gap": abs(med_p - med_r) / med_r,
    }
    for term in reference["losses"]:
        if term not in ("d_loss", "g_loss"):
            out[f"loss1.{term}_gap"] = harness.rel_gap(prog["losses"][term],
                                                        reference["losses"][term])
    kernels = reference["kernels"]
    for name, key, leaves in (("grad1_gap", "moment", None), ("change1_gap", "change", None),
                              ("ema1_gap", "ema", None), ("grad1_head_gap", "moment", HEAD),
                              ("grad1_kernel_gap", "moment", kernels),
                              ("change1_kernel_gap", "change", kernels)):
        out[name], out[f"{name}_leaf"] = harness.leaf_gap(prog[key], reference[key], leaves)
    return out


def unchanged(reading: Dict[str, Any]) -> Dict[str, Any]:
    """A step that returns its state unchanged: no moment, no change."""
    zero = lambda d: {k: 0.0 for k in d}  # noqa: E731
    return {**reading, "moment": zero(reading["moment"]), "change": zero(reading["change"]),
            "ema": zero(reading["ema"])}


def first_step_readings(multi, step, state, super_batch, generator, named, start, ema):
    """Runs the first dispatch, reading after its first step each leaf's
    Adam first moment, its change from ``start`` (host weights by leaf
    name) and, for the leaves ``ema`` holds, the change of the EMA copy:
    on the card between the first and the second replay of the step's
    graph, on the CPU (where a dispatch runs eager steps) after the first
    call of ``step``. Returns (state, metrics, {moment, change, ema: norms
    by leaf name})."""
    from tpgan_tpu_torch.train.gan_trainer import make_multi_step

    seen: Dict[str, Dict[str, float]] = {}

    def read():
        if seen:
            return
        with torch.no_grad():
            dev = named[0][1].device
            moment = torch.stack([opt.state[p]["exp_avg"].norm() for _, p, opt in named])
            change = torch.stack([(p - start[n].to(dev, non_blocking=True)).norm()
                                  for n, p, _ in named])
            moved = torch.stack([(e - start[n].to(dev, non_blocking=True)).norm()
                                 for n, e in ema.items()])
            names = [n for n, _, _ in named]
            seen["moment"] = dict(zip(names, moment.tolist()))
            seen["change"] = dict(zip(names, change.tolist()))
            seen["ema"] = dict(zip(ema, moved.tolist()))

    if next(state.gen.parameters()).device.type == "cuda":
        replay = torch.cuda.CUDAGraph.replay

        def observed(graph):
            replay(graph)
            read()

        torch.cuda.CUDAGraph.replay = observed
        try:
            state, metrics = multi(state, super_batch, generator)
        finally:
            torch.cuda.CUDAGraph.replay = replay
    else:
        def stepped(*args, **kwargs):
            out = step(*args, **kwargs)
            read()
            return out

        steps = next(iter(super_batch.values())).shape[0]
        state, metrics = make_multi_step(stepped, steps)(state, super_batch, generator)
    return state, metrics, seen


def run(r: harness.Run) -> None:
    from tpgan_tpu_torch.data.packing import device_batch_iterator
    from tpgan_tpu_torch.models.feature_extract import make_identity_embed_fn
    from tpgan_tpu_torch.train.gan_trainer import make_gan_train_step, make_multi_step

    conf, tr = r.cell.config, r.cell.traffic
    dev = r.device
    b, k = int(tr["batch"]), int(tr["steps_per_dispatch"])
    cfg = port.tpgan_config(conf, b)
    state, gen, disc, g_opt, d_opt, emb, host = port.gan_models(
        cfg, (harness.sub_seed(r.seed, 1), harness.sub_seed(r.seed, 2),
              harness.sub_seed(r.seed, 3)), dev)
    r.reset_memory_peak()  # the benchmark's own staging of the weights left out
    pack = make_pack(int(tr["pack_items"]), conf["G"]["num_classes"],
                     harness.sub_seed(r.seed, 4), dev)
    batches = device_batch_iterator(pack, b, seed=harness.sub_seed(r.seed, 5))
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, make_identity_embed_fn(emb))
    multi = make_multi_step(step, k)
    noise_seed = harness.sub_seed(r.seed, 6)
    generator = torch.Generator(device=dev).manual_seed(noise_seed)

    def super_batch():
        drawn = [next(batches) for _ in range(k)]
        return {key: torch.stack([d[key] for d in drawn]) for key in drawn[0]}

    # the first dispatch: the graph's capture and the step the reference follows
    first = super_batch()
    kept = {key: v.clone() for key, v in first.items()}
    named = [(f"gen.{n}", p, g_opt) for n, p in gen.named_parameters()]
    named += [(f"disc.{n}", p, d_opt) for n, p in disc.named_parameters()]
    start = {**{f"gen.{n}": v for n, v in host["generator"].items()},
             **{f"disc.{n}": v for n, v in host["critic"].items()}}
    ema = {f"gen.{n}": v for n, v in state.g_ema_params.items()}
    state, metrics, prog = first_step_readings(multi, step, state, first, generator, named,
                                               start, ema)
    prog["losses"] = {name: float(v[0]) for name, v in metrics.items()}
    del named, start, ema
    r.setup_done()

    history = []

    def dispatch():
        nonlocal state
        with r.span("fetch"):
            sb = super_batch()
        with r.span("dispatch"):
            state, m = multi(state, sb, generator)
        history.append(torch.stack([m["d_loss"].float(), m["g_loss"].float()]))

    calls, elapsed = harness.window(r, dispatch)
    r.e2e["train_images_per_s"] = calls * k * b / elapsed
    r.attempted = calls * k
    r.failed = int((~torch.isfinite(torch.stack(history))).any(dim=1).sum())
    r.window_closed()

    if r.trace_on:
        units = int(tr["trace_dispatches"])
        r.trace = harness.traced(r, dispatch, units)
        per_step = kernels.gan_step(b, conf["G"]["local_feature_layer_dim"])
        r.counts.update(traced_units=units * k, kernel_pattern=kernels.ALL,
                        kernel_calls_per_unit=sum(c for c, _ in per_step.values()),
                        kernel_bound_per_unit_s=sum(s for _, s in per_step.values()))
    r.counts.update(flops_per_image=sum(flops.gan_train_terms(b).values()),
                    peak_flops=float(conf["peak_flops"]))

    del state, gen, disc, g_opt, d_opt, emb, step, multi, batches, pack, history, first, metrics
    r.free()
    judge = Judge(conf, host, kept, noise_seed, dev)
    reading = judge.follow()
    values = compare(prog, reading)
    harness.judge(r, values)
    r.info.update(losses=prog["losses"], reference_losses=reading["losses"],
                  reference_s=reading["seconds"])
    r.judge, r.judge_prog, r.judge_ref = judge, prog, reading
