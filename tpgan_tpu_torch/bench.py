"""Synthesis throughput of the port on one GPU, images/s — the port of
the root ``bench.py`` (which stays the JAX bench):

    python -m tpgan_tpu_torch.bench [--modes bf16,bf16+subpixel] [--repeats 3]

Prints ``bench.py``'s headline JSON line (``metric``, ``value``, ``unit``,
``vs_baseline``, ``mode``, ``modes``, ...) after every measurement, so a
run cut short still reports what it measured.

* ``value``: the full-size two-pathway generator (fm 1.0, random weights
  from seed 0, bf16) through ``make_graphed_synthesize_fn``: each timed
  dispatch is ``scan_len`` = 8 forwards, each replaying the forward's CUDA
  graph, each one's output feeding the next one's noise (the counterpart
  of ``bench_ours``'s jitted ``lax.scan``, ``bench.py:85-164``), the clock
  around a scalar the host reads; the best over batch 256 and 128 and the
  modes. ``eager_modes``: the same chain through ``make_synthesize_fn``.
* ``vs_baseline``: against ``bench_torch_reference``, the reference graph
  in plain torch (float32, eval mode), timed on the same card.
* ``mfu_bf16``: ``bench.py``'s model count of 170.9 GFLOP per image over
  the H100 SXM's 989 TFLOP/s dense bf16 (the card's power limit is in
  ``device``).

Modes (``bench.py``'s): base ``bf16`` or ``int8`` (the int8 PTQ synthesis,
``ops/quant.py``, calibrated on one batch-16 bench batch as
``bench.py:122-130`` does), with ``+subpixel`` (the subpixel upsample
algorithm) and, for int8, ``+bf16rescale`` (the dequantize arithmetic in
bf16). The default list is ``bench.py``'s, the headline serving mode
first. ``+pad`` is the TPU lane layout, which ``build_generator``
refuses, and ``bf16+bf16rescale`` names no int8 conv: both raise, as
typos do. With no CUDA device
the line carries ``skipped: ["all(device_unavailable)"]`` and the exit
code is 0, as ``bench.py``'s is.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

MODEL_FLOPS_PER_IMAGE = 170.9e9  # bench.py's count for the fm 1.0 synthesis graph
BATCH_SIZES = (256, 128)
SCAN_LEN = 8
DEFAULT_MODES = "int8+subpixel+bf16rescale,bf16,int8"
CALIBRATION_BATCH = 16  # bench.py:125-127


def parse_mode(mode: str) -> dict:
    """'base+tok+tok' -> make_config overrides (:func:`int8_knobs` reads
    the int8 part). Raises on what the port does not run and on unknown
    names, so a typo never benches the default config."""
    base, *tokens = mode.split("+")
    opts = set(tokens)
    if base not in ("bf16", "int8"):
        raise ValueError(f"unknown bench mode base {base!r}")
    unknown = opts - {"pad", "subpixel", "bf16rescale"}
    if unknown:
        raise ValueError(f"unknown bench mode tokens {sorted(unknown)}")
    if "bf16rescale" in opts and base != "int8":
        raise ValueError("+bf16rescale is an int8 option (the dequantize arithmetic in bf16)")
    if "pad" in opts:
        raise ValueError("+pad is the TPU lane layout (G.pad_channel_multiple), which the "
                         "port's build_generator refuses")
    overrides: dict = {"compute_dtype": "bfloat16", "G": {}}
    if "subpixel" in opts:
        overrides["G"]["upsample_mode"] = "subpixel"
    return overrides


def int8_knobs(mode: str) -> Optional[dict]:
    """None for a bf16 mode; for an int8 mode the keyword arguments of
    ``gan_trainer.make_int8_synthesize_fn`` (``rescale_dtype``)."""
    parse_mode(mode)
    base, *tokens = mode.split("+")
    if base != "int8":
        return None
    return {"rescale_dtype": torch.bfloat16 if "bf16rescale" in tokens else None}


def bench_batch(b: int, device) -> Dict[str, torch.Tensor]:
    """``bench.py``'s ``_bench_batch``: NHWC normal draws from seed 0."""
    rng = np.random.RandomState(0)
    shapes = {"img": (128, 128), "left_eye": (40, 40), "right_eye": (40, 40),
              "nose": (32, 40), "mouth": (32, 48)}
    return {k: torch.as_tensor(rng.randn(b, h, w, 3).astype(np.float32), device=device)
            for k, (h, w) in shapes.items()}


def build_synthesizers(mode: str, device) -> Dict[str, Callable]:
    """{"graphed": ..., "eager": ...}: the two forms of one seeded
    full-size generator's synthesis function in ``mode``; an int8 mode
    calibrates on one batch-16 bench batch first."""
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.ops import quant
    from tpgan_tpu_torch.train.gan_trainer import (
        build_generator,
        make_graphed_int8_synthesize_fn,
        make_graphed_synthesize_fn,
        make_int8_synthesize_fn,
        make_synthesize_fn,
    )

    cfg = make_config(parse_mode(mode))
    gen = build_generator(cfg, device, seed=0)
    knobs = int8_knobs(mode)
    if knobs is None:
        return {"graphed": make_graphed_synthesize_fn(cfg, gen),
                "eager": make_synthesize_fn(cfg, gen)}
    scales = quant.calibrate_synthesis(cfg, gen, [bench_batch(CALIBRATION_BATCH, device)])
    return {"graphed": make_graphed_int8_synthesize_fn(cfg, gen, scales, **knobs),
            "eager": make_int8_synthesize_fn(cfg, gen, scales, **knobs)}


def chain(synthesize: Callable, batch, z0: torch.Tensor, scan_len: int = SCAN_LEN) -> torch.Tensor:
    """``scan_len`` forwards, each one's output sum nudging the next one's
    noise (so none can be skipped or hoisted); returns the summed outputs."""
    acc = torch.zeros((), device=z0.device)
    z = z0
    for _ in range(scan_len):
        s = synthesize(batch, z).float().sum()
        acc = acc + s
        z = z + s * 1e-12
    return acc


def measure(synthesize: Callable, batch_size: int, device, scan_len: int = SCAN_LEN,
            repeats: int = 3) -> float:
    """Images/s of :func:`chain` at ``batch_size``: best of ``repeats``
    timed dispatches after one warm dispatch (which captures the graph),
    each clock stopped by reading the scalar on the host."""
    batch = bench_batch(batch_size, device)
    z = torch.zeros((batch_size, 64), device=device)
    float(chain(synthesize, batch, z, scan_len))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(chain(synthesize, batch, z, scan_len))
        best = min(best, time.perf_counter() - t0)
    return batch_size * scan_len / best


def bench_torch_reference(batch_size: int = 2, iters: int = 2, warmup: int = 1,
                          device: Optional[str] = None) -> float:
    """The reference architecture in plain torch (the D_and_G_model.py
    graph, the 75-channel fix applied as in the models), float32, eval
    mode: a copy of ``bench.py``'s ``bench_torch_reference``, run on
    ``device`` (the best one torch has when None)."""
    import torch.nn as nn
    import torch.nn.functional as F

    dev = device or ("cuda" if torch.cuda.is_available() else "cpu")

    def cba(i, o, k, s=1, p=0):
        return nn.Sequential(nn.Conv2d(i, o, k, s, p), nn.LeakyReLU(0.01))

    def res(c, k=3):
        p = (k - 1) // 2
        return nn.Sequential(cba(c, c, k, 1, p), nn.Conv2d(c, c, k, 1, p))

    class Res(nn.Module):
        def __init__(self, c, k=3):
            super().__init__()
            self.m = res(c, k)

        def forward(self, x):
            return F.leaky_relu(self.m(x) + x, 0.01)

    class Local(nn.Module):
        def __init__(self):
            super().__init__()
            ch = [64, 128, 256, 512]
            self.e = nn.ModuleList()
            cin = 3
            for i, c in enumerate(ch):
                self.e.append(nn.Sequential(cba(cin, c, 3, 1 if i == 0 else 2, 1), Res(c)))
                cin = c
            self.d0 = nn.ConvTranspose2d(512, 256, 3, 2, 1, 1)
            self.s0 = nn.Sequential(cba(512, 256, 3, 1, 1), Res(256))
            self.d1 = nn.ConvTranspose2d(256, 128, 3, 2, 1, 1)
            self.s1 = nn.Sequential(cba(256, 128, 3, 1, 1), Res(128))
            self.d2 = nn.ConvTranspose2d(128, 64, 3, 2, 1, 1)
            self.s2 = nn.Sequential(cba(128, 64, 3, 1, 1), Res(64))
            self.head = nn.Conv2d(64, 3, 1)

        def forward(self, x):
            skips = []
            h = x
            for m in self.e:
                h = m(h)
                skips.append(h)
            h = F.relu(self.d0(h))
            h = self.s0(torch.cat([h, skips[2]], 1))
            h = F.relu(self.d1(h))
            h = self.s1(torch.cat([h, skips[1]], 1))
            f = F.relu(self.d2(h))
            h = self.s2(torch.cat([f, skips[0]], 1))
            return self.head(h), f

    class Global(nn.Module):
        def __init__(self, zdim=64):
            super().__init__()
            spec = [(3, 64, 7, 1, 3), (64, 64, 5, 2, 2), (64, 128, 3, 2, 1),
                    (128, 256, 3, 2, 1), (256, 512, 3, 2, 1)]
            self.e = nn.ModuleList(
                nn.Sequential(cba(*s), *([Res(s[1])] * (4 if i == 4 else 1)))
                for i, s in enumerate(spec)
            )
            self.fc1 = nn.Linear(512 * 8 * 8, 512)
            self.d8 = nn.ConvTranspose2d(256 + zdim, 64, 8)
            self.d32 = nn.ConvTranspose2d(64, 32, 3, 4, 0, 1)
            self.d64 = nn.ConvTranspose2d(32, 16, 3, 2, 1, 1)
            self.d128 = nn.ConvTranspose2d(16, 8, 3, 2, 1, 1)
            self.a8 = nn.Sequential(*[Res(576) for _ in range(3)])
            self.u16 = nn.ConvTranspose2d(576, 512, 3, 2, 1, 1)
            self.a16 = Res(256)
            self.e16 = nn.Sequential(Res(768), Res(768))
            self.u32 = nn.ConvTranspose2d(768, 256, 3, 2, 1, 1)
            self.a32 = Res(160)
            self.e32 = nn.Sequential(Res(416), Res(416))
            self.u64 = nn.ConvTranspose2d(416, 128, 3, 2, 1, 1)
            self.a64 = Res(80, 5)
            self.e64 = nn.Sequential(Res(208), Res(208))
            self.u128 = nn.ConvTranspose2d(208, 64, 3, 2, 1, 1)
            self.a128 = Res(75, 7)
            self.e128 = Res(64 + 75 + 64 + 3, 5)
            self.head = nn.Sequential(
                cba(206, 64, 5, 1, 2), Res(64), cba(64, 32, 3, 1, 1),
                nn.Conv2d(32, 3, 3, 1, 1),
            )

        def forward(self, x, local_img, local_feat, z):
            skips = []
            h = x
            for m in self.e:
                h = m(h)
                skips.append(h)
            fc1 = self.fc1(h.flatten(1))
            fc2 = fc1.view(-1, 256, 2).max(-1).values
            t = torch.cat([fc2, z], 1)[:, :, None, None]
            d8 = F.relu(self.d8(t))
            d32 = F.relu(self.d32(d8))
            d64 = F.relu(self.d64(d32))
            d128 = F.relu(self.d128(d64))
            h = self.a8(torch.cat([d8, skips[4]], 1))
            h = F.relu(self.u16(h))
            h = self.e16(torch.cat([h, self.a16(skips[3])], 1))
            h = F.relu(self.u32(h))
            h = self.e32(torch.cat([h, self.a32(torch.cat([d32, skips[2]], 1))], 1))
            h = F.relu(self.u64(h))
            h = self.e64(torch.cat([h, self.a64(torch.cat([d64, skips[1]], 1))], 1))
            h = F.relu(self.u128(h))
            a = self.a128(torch.cat([d128, skips[0], x], 1))
            h = self.e128(torch.cat([h, a, local_feat, local_img], 1))
            return self.head(h)

    class Gen(nn.Module):
        def __init__(self):
            super().__init__()
            self.parts = nn.ModuleList(Local() for _ in range(4))
            self.g = Global()

        def forward(self, img, le, re, no, mo, z):
            outs = [m(p) for m, p in zip(self.parts, (le, re, no, mo))]

            def place(t, top, left):
                c = torch.zeros(t.shape[0], t.shape[1], 128, 128, device=t.device)
                c[:, :, top: top + t.shape[2], left: left + t.shape[3]] = t
                return c

            geom = [(19, 18), (18, 65), (47, 43), (72, 40)]
            feat = torch.stack([place(o[1], *g) for o, g in zip(outs, geom)]).max(0).values
            fake = torch.stack([place(o[0], *g) for o, g in zip(outs, geom)]).max(0).values
            return self.g(img, fake, feat, z)

    torch.manual_seed(0)
    with torch.no_grad():
        model = Gen().to(dev).eval()
        b = batch_size
        args = [
            torch.randn(b, 3, 128, 128, device=dev),
            torch.randn(b, 3, 40, 40, device=dev),
            torch.randn(b, 3, 40, 40, device=dev),
            torch.randn(b, 3, 32, 40, device=dev),
            torch.randn(b, 3, 32, 48, device=dev),
            torch.randn(b, 64, device=dev),
        ]
        for _ in range(warmup):
            model(*args)
        if dev == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model(*args)
        if dev == "cuda":
            torch.cuda.synchronize()
    return b * iters / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=DEFAULT_MODES,
                    help="comma list of bf16|int8 with optional +subpixel and, for int8, "
                         "+bf16rescale; the fastest mode is the headline value")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--batch-sizes", default=",".join(map(str, BATCH_SIZES)))
    args = ap.parse_args(argv)
    mode_list = [m.strip() for m in args.modes.split(",") if m.strip()]
    for mode in mode_list:
        parse_mode(mode)  # refuse before any measurement
    batch_sizes = [int(b) for b in args.batch_sizes.split(",")]
    modes: Dict[str, Optional[float]] = dict.fromkeys(mode_list)
    eager: Dict[str, Optional[float]] = dict.fromkeys(mode_list)
    skipped = []
    state = {"baseline": None, "device": None}

    def emit() -> None:
        measured = {k: v for k, v in modes.items() if v}
        headline = max(measured, key=measured.get) if measured else None
        ours = measured[headline] if headline else 0.0
        base = state["baseline"]
        rec = {
            "metric": "tpgan_synthesis_imgs_per_sec_per_chip",
            "value": ours,
            "unit": "imgs/s",
            "vs_baseline": round(ours / base, 2) if base and ours else None,
            "baseline_note": "the reference graph in plain torch, float32, eval mode "
                             "(bench_torch_reference), on the same card",
            "mode": headline,
            "modes": modes,
            "eager_modes": eager,
            "mfu_bf16": (round(modes["bf16"] * MODEL_FLOPS_PER_IMAGE / 989e12, 4)
                         if modes.get("bf16") else None),
            "batch_sizes": batch_sizes,
            "scan_len": SCAN_LEN,
            "device": state["device"],
        }
        if skipped:
            rec["skipped"] = skipped
        print(json.dumps(rec), flush=True)

    if not torch.cuda.is_available():
        skipped.append("all(device_unavailable)")
        emit()
        return 0
    from tpgan_tpu_torch.utils.timing import card_info

    device = torch.device("cuda")
    state["device"] = f"{card_info()}; torch {torch.__version__}, CUDA {torch.version.cuda}"
    emit()
    for mode in mode_list:
        fns = build_synthesizers(mode, device)
        for form, table in (("graphed", modes), ("eager", eager)):
            for b in batch_sizes:
                rate = measure(fns[form], b, device, repeats=args.repeats)
                table[mode] = round(max(table[mode] or 0.0, rate), 2)
                emit()
        del fns
        torch.cuda.empty_cache()
    state["baseline"] = bench_torch_reference(batch_size=8, iters=20, warmup=3, device="cuda")
    emit()
    return 0


if __name__ == "__main__":
    sys.exit(main())
