"""Driver ``serve_throughput``: offline frontalization of a face set
through the port's graphed synthesis (``make_graphed_synthesize_fn``).

Set-up makes the generator's weights on the card from the seed, builds
the port's generator and its serving copy in the compute dtype, and a
device-resident pool of ``pool_batches`` distinct batches of ``batch``
seeded crop sets (float32 NHWC profile image and four patches, values in
[-1, 1]) with a noise vector each; the first call captures the forward's
graph. In the window each forward takes the next pool batch, and its noise
is that batch's plus 1e-12 times the previous output's sum, so no forward
can be skipped or reordered.

``correct``: ``samples`` forwards drawn from the seed among the
window's first ``sample_range`` keep their output; once the window has
closed the plain reference computes each from the same inputs in
float32, and the worst image's relative L2 gap is compared (a batch's
gap would hide one altered image among 128).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_h100 import harness, port, weights
from bench_h100.counts import flops, kernels
from bench_h100.reference import tpgan as ref



def crop_sets(n: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n`` float32 NHWC crop sets in [-1, 1] drawn on the card: the
    profile image and the four patches."""
    g = torch.Generator(device=device).manual_seed(seed)
    shapes = {"img": (128, 128), **{p: hw for p, (hw, _) in ref.PARTS.items()}}
    return {k: torch.rand((n, h, w, 3), generator=g, device=device) * 2.0 - 1.0
            for k, (h, w) in shapes.items()}


def nchw(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device).permute(0, 3, 1, 2).contiguous() for k, v in batch.items()}


def rel_l2(prog: torch.Tensor, reference: torch.Tensor) -> float:
    a, b = prog.float().flatten(), reference.float().flatten()
    return float((a - b).norm() / b.norm())


def image_gaps(prog: torch.Tensor, reference: torch.Tensor) -> Dict[str, float]:
    """One batch's gaps: relative L2 over the batch (``image_gap``) and of
    its worst image (``image_worst_gap``)."""
    a, b = prog.float(), reference.float()
    per = (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)
    return {"image_gap": rel_l2(a, b), "image_worst_gap": float(per.max())}


class Judge:
    """``samples``: (crop set, z, the program's NHWC output) per sampled
    forward or request."""

    def __init__(self, conf, host: Dict[str, torch.Tensor],
                 samples: List[Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]],
                 device, calibration_seed: int):
        self.conf, self.host, self.samples, self.device = conf, host, samples, device
        self.calibration_seed = calibration_seed

    def reference(self, rounding=None) -> List[torch.Tensor]:
        """The reference's images of the sampled inputs; with ``rounding``
        the lower-precision control."""
        gw = port.to_device(self.host, self.device)
        outs = []
        with harness.tf32_off():
            for batch, z, _ in self.samples:
                outs.append(ref.synthesize(gw, nchw(batch, self.device), z.to(self.device),
                                           rounding=rounding).permute(0, 2, 3, 1))
        return outs

    def gaps(self, outs: Optional[List[torch.Tensor]] = None,
             reference: Optional[List[torch.Tensor]] = None) -> Dict[str, float]:
        """Each of ``image_gaps``' numbers, worst over the sampled batches."""
        outs = [o for _, _, o in self.samples] if outs is None else outs
        reference = self.reference() if reference is None else reference
        each = [image_gaps(o.to(self.device), r) for o, r in zip(outs, reference)]
        # no sampled answer came: nothing was shown right
        return {k: max((g[k] for g in each), default=float("inf"))
                for k in ("image_gap", "image_worst_gap")}

    def int8_outputs(self, batch_size: int) -> List[torch.Tensor]:
        """The control: the program's own int8 synthesis (calibrated on one
        batch-16 crop set, as its bench calibrates) on the same inputs."""
        from tpgan_tpu_torch.ops import quant
        from tpgan_tpu_torch.train.gan_trainer import build_generator, make_int8_synthesize_fn

        cfg = port.tpgan_config(self.conf, batch_size)
        gen = build_generator(cfg, self.device)
        weights.load(gen, port.to_device(self.host, self.device))
        calib = crop_sets(16, self.calibration_seed, self.device)
        scales = quant.calibrate_synthesis(cfg, gen, [calib])
        synth = make_int8_synthesize_fn(cfg, gen, scales)
        return [synth({k: v.to(self.device) for k, v in batch.items()}, z.to(self.device))
                for batch, z, _ in self.samples]


def build(r: harness.Run, batch: int):
    """(graphed synthesis, host weights) of the cell's configuration."""
    from tpgan_tpu_torch.train.gan_trainer import build_generator, make_graphed_synthesize_fn

    dev = r.device
    cfg = port.tpgan_config(r.cell.config, batch)
    gen = build_generator(cfg, dev)
    w = port.seeded("generator", harness.sub_seed(r.seed, 1), dev)
    weights.load(gen, w)
    host = port.to_host(w)
    del w
    r.reset_memory_peak()
    synth = make_graphed_synthesize_fn(cfg, gen)
    del gen
    r.free()
    return synth, host


def run(r: harness.Run) -> None:
    conf, tr = r.cell.config, r.cell.traffic
    dev = r.device
    b, n_pool = int(tr["batch"]), int(tr["pool_batches"])
    synth, host = build(r, b)
    pool = [crop_sets(b, harness.sub_seed(r.seed, 10 + j), dev) for j in range(n_pool)]
    z0 = torch.randn((n_pool, b, conf["G"]["zdim"]),
                     generator=torch.Generator(device=dev).manual_seed(harness.sub_seed(r.seed, 2)),
                     device=dev)
    synth(pool[0], z0[0])  # captures the forward's graph
    rng = np.random.RandomState(harness.sub_seed(r.seed, 3))
    sampled = set(int(i) for i in rng.choice(int(tr["sample_range"]), int(tr["samples"]),
                                                    replace=False))
    r.setup_done()

    kept = []
    at = {"i": 0, "z": z0[0]}

    def dispatch():
        i = at["i"]
        j = i % n_pool
        with r.span("forward"):
            out = synth(pool[j], at["z"])
        if i in sampled:
            kept.append(({k: v.clone() for k, v in pool[j].items()}, at["z"].clone(), out))
        at["z"] = z0[(i + 1) % n_pool] + out.float().sum() * 1e-12
        at["i"] = i + 1

    calls, elapsed = harness.window(r, dispatch)
    r.e2e["serve_images_per_s"] = calls * b / elapsed
    r.attempted, r.failed = calls, 0
    r.window_closed()
    if r.trace_on:
        units = int(tr["trace_forwards"])
        r.trace = harness.traced(r, dispatch, units)
        per = kernels.synthesis(b, conf["G"]["local_feature_layer_dim"])
        r.counts.update(traced_units=units, kernel_pattern=kernels.ALL,
                        kernel_calls_per_unit=sum(c for c, _ in per.values()),
                        kernel_bound_per_unit_s=sum(s for _, s in per.values()))
    r.counts.update(flops_per_image=flops.synthesis_per_image(),
                    peak_flops=float(conf["peak_flops"]))

    del synth, pool
    r.free()
    if len(kept) < len(sampled):
        r.info["unsampled"] = len(sampled) - len(kept)
    judge = Judge(conf, host, kept, dev, harness.sub_seed(r.seed, 9))
    harness.judge(r, judge.gaps())
    r.judge = judge
