#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which exits non-zero on failure:

1. card        — name and power limit, as nvidia-smi reports them;
2. build       — compiles every CUDA kernel from ``tpgan_tpu_torch/csrc/``
                 (one nvcc per source, all started together) and prints
                 ptxas's register lines;
3. kernels     — each kernel against its plain PyTorch version on the card
                 at the shapes its path gives it: the fuse forward and
                 backward ``torch.equal`` (NaN cases included), the
                 symmetry+TV forward within rtol 1e-5 and bit-identical
                 over two runs, its backward within rtol 1e-6 on inputs
                 with planted ties; a CUDA tensor the kernel does not take
                 raises;
4. serve       — the full-size (fm=1.0, deconv) generator in bf16 from a
                 seeded init answers 4 requests of batch 8 through
                 ``build_generator`` / ``make_synthesize_fn``; 3 fuses per
                 forward;
5. f32 check   — the same forward in f32 (TF32 off, deterministic cuDNN),
                 once through the kernel and once with the plain fuse
                 forced in: max|diff| <= 1e-6;
6. train       — ``train_entry()``: ``create_gan_state`` +
                 ``make_gan_train_step`` at full size (fm 1.0), bf16, batch
                 16, seed 0, synthetic batches, 5 steps; every metric
                 finite, the parameters move, and per step the kernels
                 launch 7 fuse / 2 fuse-backward / 1 sym-TV / 1
                 sym-TV-backward times;
7. train f32   — after a warm-up step, one f32 step (TF32 off,
                 deterministic cuDNN) at batch 8, once through the
                 kernels and once with every kernel wrapper forced onto
                 its plain version: metrics within 1e-5 |ref| + 1e-6,
                 every parameter's gradient within a few ulp of its
                 leaf's largest (TRAIN_F32_GRAD_ULPS);
8. timings     — each kernel against its plain version and its byte bound
                 (fuse forward at batch 8 and 128; the new kernels at
                 batch 16 and 64); synthesis latency and images/s at batch
                 8 and 128; train-step ms and images/s at batch 16 and 64
                 with peak memory; profiler breakdowns of the batch-8
                 forward and of one batch-16 train step.

Counts are set to 0 just before each path (serve, train) is driven and
read just after; launches made to compare a kernel with its plain version
do not count. Ends with a ``{"kernels": [...]}`` line, the card's name and
power limit, and ``{"ok": true, "device": {...}}`` as the last line.
Imports nothing of JAX; needs one GPU.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from unittest import mock

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
FUSE_SHAPES = (  # (channels, dtype name): the three fuses of one forward
    (64, "bfloat16"),  # LocalPathway features, compute dtype
    (3, "bfloat16"),  # fake patches, compute dtype
    (3, "float32"),  # ground-truth patches, input dtype
)
FUSE_BWD_SHAPES = ((64, "bfloat16"), (3, "bfloat16"))  # the two backward launches of a step
REQUESTS = 4
BATCH = 8
TRAIN_BATCH = 16
TRAIN_STEPS = 5
TRAIN_F32_BATCH = 8
PER_STEP = {"fuse_parts": 7, "fuse_parts_bwd": 2, "sym_tv": 1, "sym_tv_bwd": 1}
F32_MAX_DIFF = 1e-6
# bf16 keeps 8 mantissa bits: the bf16 serving output may differ from the
# f32 one by a few percent of the output's range (the CPU test's bound)
BF16_REL_DIFF = 0.05
# The f32 step through the kernels against the plain versions, held on
# every parameter's gradient: the backward kernels act only there. Fuse
# forward and backward are exact; K2's backward is one formula in one
# order on both sides (its products by the small integer brackets are
# exact); K2's forward sums differ in order, but reach only the loss
# values, never a gradient. With deterministic cuDNN the gradients agree
# to the bit (0 elements differ) once a process has taken one f32 step:
# its first differs from later ones in the last bits on either path
# (cuBLAS/cuDNN first-call set-up; the phase prints by how much), so a
# warm-up step comes first. The bound is a few ulp of each leaf's largest
# gradient; a backward that drops the TV term, swaps two parts or the two
# upstream scalars, or zeroes the fuse gradient moves some leaf far
# beyond it.
TRAIN_F32_GRAD_ULPS = 4

def log(msg: str) -> None:
    print(msg, flush=True)


def card_info() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def gpu_time_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: a sleep kernel first lets the host
    queue all ``iters`` launches, so the events bracket device work only."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rotated(make, nbytes: int):
    """Copies of an input set, enough to rotate past the 50 MB L2."""
    return [make() for _ in range(max(1, math.ceil(200e6 / nbytes)))]


def make_parts(batch, channels, dtype, seed, device):
    """Parts at the slot sizes, with negatives, exact ties and zeros."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.ops.geometry import PART_GEOMETRY, PART_NAMES

    rng = np.random.RandomState(seed)
    parts = [
        rng.standard_normal((batch, channels) + PART_GEOMETRY[n][0]).astype(np.float32)
        for n in PART_NAMES
    ]
    parts[2][:, :, 0:8, 0:10] = parts[0][:, :, 28:36, 25:35]  # nose/left-eye tie
    parts[0][:, :, :5] = 0.0
    return [torch.from_numpy(p).to(device=device, dtype=dtype) for p in parts]


def make_image(batch, dtype, seed, device):
    """(B, 3, 128, 128) with TV ties, symmetry ties and zeros planted."""
    import numpy as np
    import torch

    x = np.random.RandomState(seed).uniform(-1, 1, (batch, 3, 128, 128)).astype(np.float32)
    x[:, :, 10] = x[:, :, 9]
    x[:, :, :, 40] = x[:, :, :, 41]
    x[:, :, :, 100] = x[:, :, :, 27]  # the mirror of column 27
    x[0, 1, 60:70, 60:70] = 0.0
    return torch.from_numpy(x).to(device=device, dtype=dtype)


def same(a, b) -> bool:
    import torch

    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def max_err(a, b) -> float:
    finite = ~(a.isnan() | b.isnan())
    return float((a[finite].float() - b[finite].float()).abs().max()) if finite.any() else 0.0


def check_kernels(dev, errors):
    """Phase 3: every kernel against its plain version; fills ``errors``
    with each kernel's max |kernel - plain|."""
    import torch

    from tpgan_tpu_torch.ops import kernels

    for c, dname in FUSE_SHAPES:
        dtype = getattr(torch, dname)
        for nan in (False, True):
            parts = make_parts(BATCH, c, dtype, seed=c, device=dev)
            if nan:
                parts[2][0, 1, 3, 4] = float("nan")
                parts[1][BATCH - 1, 0, 39, 39] = float("nan")
            got = kernels.fuse_parts(*parts)
            want = kernels.fuse_parts_plain(*parts)
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"fuse_parts kernel != plain at C={c} {dname} nan={nan}")
            if nan and int(got.isnan().sum()) != 2:
                raise AssertionError("fuse_parts kernel lost a NaN")
            errors["fuse_parts"] = max(errors["fuse_parts"], max_err(got, want))
            log(f"kernel check: fuse_parts B={BATCH} C={c} {dname} nan={nan}: equal")

    for c, dname in FUSE_BWD_SHAPES:
        dtype = getattr(torch, dname)
        for nan in (False, True):
            parts = make_parts(TRAIN_BATCH, c, dtype, seed=c + 1, device=dev)
            if nan:
                parts[2][0, 1, 3, 4] = float("nan")
            out = kernels.fuse_parts_plain(*parts)
            g = torch.randn(out.shape, generator=torch.Generator(device=dev).manual_seed(c),
                            device=dev).to(dtype)
            if nan:
                g[1, 0, 50, 50] = float("nan")  # a NaN cotangent passes where part >= out
            g = g.transpose(2, 3).contiguous().transpose(2, 3)  # non-contiguous, as autograd may
            got = kernels._launch_fuse_bwd(parts, out, g)
            want = kernels.fuse_parts_bwd_plain(parts, out, g)
            torch.cuda.synchronize()
            for k, (a, b) in enumerate(zip(got, want)):
                if a.dtype != dtype or not same(a, b):
                    raise AssertionError(f"fuse_parts_bwd kernel != plain, part {k}, C={c} "
                                         f"{dname} nan={nan}")
                errors["fuse_parts_bwd"] = max(errors["fuse_parts_bwd"], max_err(a, b))
            log(f"kernel check: fuse_parts_bwd B={TRAIN_BATCH} C={c} {dname} nan={nan}: equal "
                "(g non-contiguous)")

    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        x = make_image(TRAIN_BATCH, dtype, seed=3, device=dev)
        sums, sym, tv = kernels._launch_sym_tv(x)
        sums2, sym2, tv2 = kernels._launch_sym_tv(x)
        want = kernels.sym_tv_sums_plain(x)
        want_sym, want_tv = kernels.symmetry_tv_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(sums, sums2) and torch.equal(sym, sym2) and torch.equal(tv, tv2)):
            raise AssertionError(f"sym_tv kernel is not deterministic ({dname})")
        for name, a, b in (("sums", sums, want), ("sym", sym, want_sym), ("tv", tv, want_tv)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=f"sym_tv {name} {dname}")
        for a, b in ((sym, want_sym), (tv, want_tv)):
            errors["sym_tv"] = max(errors["sym_tv"], max_err(a, b))
        g_sym = torch.tensor(0.3, device=dev)
        g_tv = torch.tensor(1e-3, device=dev)
        dx = kernels._launch_sym_tv_bwd(x, g_sym, g_tv)
        dx_want = kernels.sym_tv_bwd_plain(x, g_sym, g_tv)
        torch.cuda.synchronize()
        if dx.dtype != dtype:
            raise AssertionError(f"sym_tv_bwd returned {dx.dtype} for {dtype}")
        torch.testing.assert_close(dx, dx_want, rtol=1e-6, atol=0, msg=f"sym_tv_bwd {dname}")
        errors["sym_tv_bwd"] = max(errors["sym_tv_bwd"], max_err(dx, dx_want))
        log(f"kernel check: sym_tv B={TRAIN_BATCH} {dname}: sums {sums.tolist()} vs plain "
            f"{want.tolist()}, bit-identical over two runs; sym_tv_bwd within rtol 1e-6 "
            f"(max|diff| {max_err(dx, dx_want):.3e}, planted ties)")

    for what, call in (
        ("fuse_parts", lambda: kernels.fuse_parts(
            *parts[:3], parts[3].transpose(2, 3).contiguous().transpose(2, 3))),
        ("symmetry_tv_losses", lambda: kernels.symmetry_tv_losses(x.transpose(2, 3))),
    ):
        try:
            call()
            raise AssertionError(f"{what} accepted a non-contiguous CUDA tensor")
        except ValueError:
            log(f"kernel check: {what} on a non-contiguous CUDA tensor raises (no fallback)")


def train_metrics_ok(metrics) -> None:
    import torch

    bad = {k: float(v) for k, v in metrics.items() if not torch.isfinite(v.float())}
    if bad:
        raise AssertionError(f"non-finite train metrics {bad}")


def run_train(dev, tag):
    """Phase 6: the full-size bf16 train step through ``train_entry``."""
    import torch

    from tpgan_tpu_torch.entry import train_entry
    from tpgan_tpu_torch.ops import kernels

    step_fn, (state, batch, generator) = train_entry()
    models = (state.gen, state.disc)
    before = [[p.detach().clone() for p in m.parameters()] for m in models]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = []
    for _ in range(TRAIN_STEPS):
        state, metrics = step_fn(state, batch, generator)
        history.append(metrics)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    for m in history:
        train_metrics_ok(m)
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    moved = [sum(not torch.equal(a, p) for a, p in zip(b, m.parameters()))
             for b, m in zip(before, models)]
    if min(moved) == 0 or state.step != TRAIN_STEPS:
        raise AssertionError(f"params moved (G, D): {moved}; step {state.step} != {TRAIN_STEPS}")
    last = {k: round(float(v), 5) for k, v in history[-1].items()}
    log(f"train: full size bf16 batch {TRAIN_BATCH}, {TRAIN_STEPS} steps in {wall:.2f} s "
        f"incl. first-step set-up; launches {launches} ({PER_STEP} per step); params moved "
        f"(G, D) {moved} of {[len(b) for b in before]} tensors; "
        f"last metrics {last} {tag}")
    return launches, (step_fn, state, batch, generator)


def grad_gap(a, b):
    """(elements that differ, worst leaf's max|a - b| over its max|b|)."""
    ndiff, worst = 0, 0.0
    for n, want in b.items():
        scale = float(want.abs().max())
        ndiff += int((a[n] != want).sum())
        worst = max(worst, float((a[n] - want).abs().max()) / scale if scale > 0 else 0.0)
    return ndiff, worst


def run_train_f32(dev):
    """Phase 7: after a warm-up step, one f32 step through the kernels and
    one through the plain versions, from the same seeded state, batch and
    noise; their gradients are held leaf by leaf."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = make_config({"compute_dtype": "float32"})
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_gan_batch(TRAIN_F32_BATCH, seed=5).items()}
    runs = []
    for plain in (False, False, True):  # warm-up, kernels, plain
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
        kernels.reset_launch_counts()
        forced = mock.patch.object(kernels, "_dispatch", lambda x, name: False)
        with forced if plain else contextlib.nullcontext():
            state, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(9))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if plain != (sum(counts.values()) == 0):
            raise AssertionError(f"f32 step ({'plain' if plain else 'kernels'}) launches {counts}")
        train_metrics_ok(metrics)
        named = [*gen.named_parameters(), *(("D." + n, p) for n, p in disc.named_parameters())]
        runs.append(({k: float(v) for k, v in metrics.items()},
                     {n: p.grad.detach().clone() for n, p in named},
                     {n: p.detach().clone() for n, p in named}))
        del state, gen, disc, g_opt, d_opt, step, named
    (mk, gk, pk), (mp, gp, pp) = runs[1:]
    worst = max(abs(mk[k] - mp[k]) / (1e-5 * abs(mp[k]) + 1e-6) for k in mp)
    if worst > 1.0:
        raise AssertionError(f"f32 step metrics: kernels {mk} vs plain {mp}")
    for n, want in gp.items():
        scale = float(want.abs().max())
        bound = TRAIN_F32_GRAD_ULPS * float(np.spacing(np.float32(scale)))  # f32 ulps
        d = float((gk[n] - want).abs().max())
        if not d <= bound:
            raise AssertionError(f"f32 step gradient {n}: kernels vs plain max|diff| {d} "
                                 f"> {TRAIN_F32_GRAD_ULPS} ulp of max|grad| {scale}")
    if max(float(g.abs().max()) for g in gp.values()) == 0:
        raise AssertionError("f32 step: every gradient is zero")
    gdiff, worst_grad = grad_gap(gk, gp)
    warm_diff, warm_worst = grad_gap(runs[0][1], gk)
    ndiff = sum(int((pk[n] != pp[n]).sum()) for n in pk)
    total = sum(p.numel() for p in pk.values())
    msum = max(abs(mk[k] - mp[k]) for k in mp)
    log(f"train f32 check: batch {TRAIN_F32_BATCH}, kernels vs plain versions: metrics max|diff| "
        f"{msum:.3e} (worst {worst:.3f} of 1e-5|ref|+1e-6); gradients of {len(gp)} leaves: "
        f"{gdiff} of {total} elements differ, worst leaf max|diff| {worst_grad:.3e} of its "
        f"max|grad| (bound {TRAIN_F32_GRAD_ULPS} ulp of it); updated params: {ndiff} differ; "
        f"the warm-up step against the kernels step: {warm_diff} gradient elements differ, worst "
        f"leaf {warm_worst:.3e} of its max|grad|")
    torch.backends.cudnn.deterministic = False


def time_kernels(dev, tag):
    """Phase 8, kernels: µs per call against the plain version and the
    byte bound, inputs rotated past L2."""
    import torch

    from tpgan_tpu_torch.ops import kernels

    rows = []

    def row(name, batch, label, k_ms, p_ms, nbytes):
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append(dict(name=name, batch=batch, label=label, ms=k_ms, plain_ms=p_ms,
                         bound_ms=bound_ms))
        log(f"time: {name} B={batch} {label}: kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, byte bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB; "
            f"{bound_ms / k_ms:.0%} of bound) {tag}")

    # K3 (conv3x3_bias_lrelu_pallas, not on any path) has no kernel yet;
    # its bound at one real layer, global_pathway.conv6 at full size
    # (64 -> 32 channels, 3x3, 128x128), batch 16, bf16:
    b, cin, cout, hw = TRAIN_BATCH, 64, 32, 128
    flops = 2 * b * hw * hw * cin * cout * 9
    nbytes = 2 * (b * hw * hw * (cin + cout) + 9 * cin * cout + cout)
    log(f"bound: K3 conv3x3+bias+LeakyReLU at global_pathway.conv6 (B={b}, {cin}->{cout}, "
        f"{hw}x{hw}, bf16): {flops / 1e9:.2f} GFLOP in {flops / BF16_FLOPS * 1e6:.2f} us, "
        f"{nbytes / 1e6:.2f} MB in {nbytes / HBM_BYTES_PER_S * 1e6:.2f} us: bound by "
        f"{'bytes' if nbytes / HBM_BYTES_PER_S > flops / BF16_FLOPS else 'operations'}, "
        f"{max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e6:.2f} us")

    for batch in (BATCH, 128):
        for c, dname in FUSE_SHAPES:
            dtype = getattr(torch, dname)
            parts = make_parts(batch, c, dtype, seed=1, device=dev)
            nbytes = (sum(p.numel() for p in parts) + batch * c * 128 * 128) * parts[0].element_size()
            copies = rotated(lambda: [p.clone() for p in parts], nbytes)
            it = iter(range(10**9))
            k_ms = gpu_time_ms(lambda: kernels._launch_fuse(copies[next(it) % len(copies)]), 200)
            p_ms = gpu_time_ms(lambda: kernels.fuse_parts_plain(*copies[next(it) % len(copies)]), 50)
            row("fuse_parts", batch, f"C={c} {dname}", k_ms, p_ms, nbytes)
            del parts, copies

    for batch in (TRAIN_BATCH, 64):
        for c, dname in FUSE_BWD_SHAPES:
            dtype = getattr(torch, dname)
            parts = make_parts(batch, c, dtype, seed=2, device=dev)
            out = kernels.fuse_parts_plain(*parts)
            g = torch.randn(out.shape, device=dev).to(dtype)
            # part, out slot, g slot and grad: each touched once
            nbytes = 4 * sum(p.numel() for p in parts) * parts[0].element_size()
            copies = rotated(lambda: ([p.clone() for p in parts], out.clone(), g.clone()),
                             nbytes + 2 * out.numel() * out.element_size())
            it = iter(range(10**9))
            k_ms = gpu_time_ms(lambda: kernels._launch_fuse_bwd(*copies[next(it) % len(copies)]), 100)
            p_ms = gpu_time_ms(lambda: kernels.fuse_parts_bwd_plain(*copies[next(it) % len(copies)]), 30)
            row("fuse_parts_bwd", batch, f"C={c} {dname}", k_ms, p_ms, nbytes)
            del parts, out, g, copies

        x = make_image(batch, torch.bfloat16, seed=4, device=dev)
        nbytes = x.numel() * x.element_size()
        copies = rotated(x.clone, nbytes)
        g_sym, g_tv = torch.tensor(0.3, device=dev), torch.tensor(1e-3, device=dev)
        it = iter(range(10**9))
        k_ms = gpu_time_ms(lambda: kernels._launch_sym_tv(copies[next(it) % len(copies)]), 200)
        p_ms = gpu_time_ms(lambda: kernels.symmetry_tv_plain(copies[next(it) % len(copies)]), 50)
        row("sym_tv", batch, "C=3 bfloat16", k_ms, p_ms, nbytes)
        k_ms = gpu_time_ms(
            lambda: kernels._launch_sym_tv_bwd(copies[next(it) % len(copies)], g_sym, g_tv), 200)
        p_ms = gpu_time_ms(
            lambda: kernels.sym_tv_bwd_plain(copies[next(it) % len(copies)], g_sym, g_tv), 50)
        row("sym_tv_bwd", batch, "C=3 bfloat16", k_ms, p_ms, 2 * nbytes)
        del x, copies
    return rows


def time_synthesis(dev, synthesize, zdim, tag):
    import torch

    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch

    # latency: each forward timed alone (host clock, synchronised);
    # throughput: forwards back to back with one synchronise at the end
    for batch, samples in ((BATCH, 100), (128, 20)):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_gan_batch(batch, seed=7).items()
             if k in ("img", "left_eye", "right_eye", "nose", "mouth")}
        z = torch.zeros(batch, zdim, device=dev)
        for _ in range(3):
            synthesize(b, z)
        torch.cuda.synchronize()
        lat = []
        for _ in range(samples):
            t0 = time.perf_counter()
            synthesize(b, z)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t0)
        lat.sort()
        # the highest percentile with at least ten samples beyond it
        hi = samples - 11
        t0 = time.perf_counter()
        for _ in range(samples):
            synthesize(b, z)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / samples
        log(f"time: synthesis bf16 batch {batch}: latency median {statistics.median(lat) * 1e3:.2f} ms, "
            f"p{round(100 * (hi + 1) / samples)} {lat[hi] * 1e3:.2f} ms ({samples} forwards); "
            f"back to back {dt * 1e3:.2f} ms/forward = {batch / dt:.1f} images/s "
            f"(inputs on the device) {tag}")


def time_train(dev, tag):
    """Train-step ms and images/s at batch 16 and 64 (steady state after
    warm-up, back to back, one synchronise at the end), with peak memory."""
    import gc

    import torch

    from tpgan_tpu_torch.entry import train_entry

    for batch, steps in ((TRAIN_BATCH, 20), (64, 10)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_fn, (state, b, generator) = train_entry(batch_size=batch)
        for _ in range(3):
            state, _m = step_fn(state, b, generator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            state, metrics = step_fn(state, b, generator)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        train_metrics_ok(metrics)
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"time: train step bf16 full size batch {batch}: {dt * 1e3:.2f} ms/step = "
            f"{batch / dt:.1f} images/s ({steps} steps after 3 warm-up; D+G update, inputs on "
            f"the device); peak memory {peak:.2f} GiB {tag}")
        del step_fn, state, b, generator, metrics, _m


def profile(fn, iters, what, unit, tag, names):
    """Busy/idle share, kernels per call, the top-8 kernels and the share
    of each named kernel, over ``iters`` calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels, memcpys and memsets; not the user-annotation ranges
    # (``Optimizer.step#Adam.step``) that the profiler also files as CUDA
    # (a kernel's demangled name may hold "#" too: ``{lambda(float)#1}``)
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kern = [e for e in device if not (getattr(e, "is_user_annotation", False)
                                      or e.name.startswith("Optimizer."))]
    kept = {id(e) for e in kern}
    left_out = {}
    for e in device:
        if id(e) not in kept:
            left_out[e.name] = left_out.get(e.name, 0) + 1
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    if busy_us <= 0:
        log(f"profile: {what}: the profiler recorded no device time (not measured)")
        return
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    shares = []
    for label, keys in names.items():
        us = sum(v for k, v in by_name.items() if any(s in k for s in keys))
        shares.append(f"{label} {us / iters:.1f} us/{unit} ({us / busy_us:.2%} of busy)")
    log(f"profile: {what}, {iters} {unit}s: wall {wall_us / iters / 1e3:.2f} ms/{unit}, "
        f"device busy {busy_us / iters / 1e3:.2f} ms/{unit} ({busy_us / wall_us:.0%}; idle "
        f"{1 - busy_us / wall_us:.0%}), {len(kern) // iters} kernels/{unit}; "
        f"{'; '.join(shares)} {tag}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {us / iters / 1e3:8.3f} ms/{unit}  {name[:110]}")
    top = sorted(left_out.items(), key=lambda kv: -kv[1])[:3]
    log(f"profile:   left out of busy time: {sum(left_out.values()) // iters} annotation "
        f"ranges/{unit} {[(n[:40], c // iters) for n, c in top]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU")
        return 2
    try:
        from tpgan_tpu_torch.config import make_config
        from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
        from tpgan_tpu_torch.entry import entry
        from tpgan_tpu_torch.models import generator as generator_module
        from tpgan_tpu_torch.ops import _build, kernels
        from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn
    except ImportError as e:
        log(f"FAIL: the tpgan_tpu_torch package is not importable here ({e}); "
            "run from the root of a checkout")
        return 2
    import numpy as np

    dev = torch.device("cuda")
    card = card_info()
    tag = f"[{card}]"
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {len(libs)} kernel libraries in {time.perf_counter() - t0:.1f} s")
    for source, path in libs.items():
        ptxas = path.with_suffix(".log")
        text = ptxas.read_text().splitlines() if ptxas.exists() else []
        log(f"  {source} -> {path.name}")
        fn = None
        for line in text:
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line:
                log(f"    {fn}: {line.split(':', 1)[-1].strip()}")
        if not text:
            log("    (cached build, no ptxas report)")

    # ---- 3. each kernel against its plain version ----
    errors = dict.fromkeys(PER_STEP, 0.0)
    check_kernels(dev, errors)

    # ---- 4. serve: full-size bf16 synthesis, 4 requests of batch 8 ----
    fn, args = entry()
    out = fn(*args)
    if out.shape != (BATCH, 128, 128, 3) or not torch.isfinite(out.float()).all():
        raise AssertionError(f"entry() gave {tuple(out.shape)} with non-finite values")
    del fn, args, out

    cfg = make_config({"compute_dtype": "bfloat16"})
    gen = build_generator(cfg, dev, seed=0)
    synthesize = make_synthesize_fn(cfg, gen)
    requests = []
    for i in range(REQUESTS):
        b = synthetic_gan_batch(BATCH, seed=100 + i)
        z = np.random.RandomState(200 + i).standard_normal((BATCH, cfg.G.zdim)).astype(np.float32)
        requests.append((b, z))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    outputs = [synthesize(b, z) for b, z in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = kernels.launch_counts()
    for o in outputs:
        if o.shape != (BATCH, 128, 128, 3) or o.dtype != torch.bfloat16:
            raise AssertionError(f"request gave {tuple(o.shape)} {o.dtype}")
        if not torch.isfinite(o.float()).all():
            raise AssertionError("request gave non-finite values")
    want = {"fuse_parts": 3 * REQUESTS, "fuse_parts_bwd": 0, "sym_tv": 0, "sym_tv_bwd": 0}
    if serve_launches != want:
        raise AssertionError(f"serve launches {serve_launches}, expected {want}")
    log(f"serve: {REQUESTS} requests x batch {BATCH}, bf16, full size, "
        f"{serve_s * 1e3:.1f} ms incl. first-call set-up; launches {serve_launches} {tag}")

    # ---- 5. f32 forward: kernel vs plain fuse ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    synth32 = make_synthesize_fn(make_config({"compute_dtype": "float32"}), gen)
    b, z = requests[0]
    with_kernel = synth32(b, z)
    with mock.patch.object(generator_module, "fuse_parts", kernels.fuse_parts_plain):
        with_plain = synth32(b, z)
    diff32 = float((with_kernel - with_plain).abs().max())
    if not torch.isfinite(with_kernel).all() or diff32 > F32_MAX_DIFF:
        raise AssertionError(f"f32 forward: kernel vs plain fuse max|diff| {diff32}")
    scale = float(with_kernel.abs().max())
    diff16 = float((outputs[0].float() - with_kernel).abs().max())
    if diff16 > BF16_REL_DIFF * scale:
        raise AssertionError(f"bf16 output is {diff16} off the f32 one (max|f32| {scale})")
    log(f"f32 check: kernel vs plain-fuse forward max|diff| = {diff32:.3e} (limit {F32_MAX_DIFF}); "
        f"bf16 vs f32 output max|diff| = {diff16:.4f} of max|f32| {scale:.4f} "
        f"(limit {BF16_REL_DIFF:.0%})")
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.allow_tf32 = True
    del synth32, with_kernel, with_plain

    # ---- 6. train: full-size bf16 steps through train_entry ----
    train_launches, (step_fn, state, tbatch, tgen) = run_train(dev, tag)
    b8 = {k: torch.as_tensor(v, device=dev) for k, v in requests[0][0].items()
          if k in ("img", "left_eye", "right_eye", "nose", "mouth")}
    z8 = torch.as_tensor(requests[0][1], device=dev)
    train_box = [state]

    def one_step():
        train_box[0], _ = step_fn(train_box[0], tbatch, tgen)

    profile(one_step, 2, f"train step bf16 batch {TRAIN_BATCH}", "step", tag, {
        "fuse_parts": ["fuse_parts_kernel"], "fuse_parts_bwd": ["fuse_parts_bwd_kernel"],
        "sym_tv": ["sym_tv_partial_kernel", "sym_tv_final_kernel"],
        "sym_tv_bwd": ["sym_tv_bwd_kernel"],
    })
    del step_fn, state, train_box, tbatch, tgen

    # ---- 7. train f32: kernels vs plain versions ----
    torch.cuda.empty_cache()
    run_train_f32(dev)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 8. timings ----
    rows = time_kernels(dev, tag)
    time_synthesis(dev, synthesize, cfg.G.zdim, tag)
    profile(lambda: synthesize(b8, z8), 3, f"bf16 synthesis batch {BATCH}", "forward", tag,
            {"fuse_parts": ["fuse_parts_kernel"]})
    del gen, synthesize, outputs
    torch.cuda.empty_cache()
    time_train(dev, tag)

    def main_path(name, batch):
        sel = [r for r in rows if r["name"] == name and r["batch"] == batch]
        return {k: sum(r[k] for r in sel) for k in ("ms", "plain_ms", "bound_ms")}

    spec = {
        # one forward's three fuses at batch 8 (C=64 bf16, C=3 bf16, C=3 f32)
        "fuse_parts": ("fuse_parts.cu", "tpgan_tpu/ops/pallas_kernels.py:64", BATCH),
        # one step's two backward fuses at batch 16 (C=64 and C=3, bf16)
        "fuse_parts_bwd": ("fuse_parts.cu", "tpgan_tpu/ops/pallas_kernels.py:118", TRAIN_BATCH),
        # one step's launch at batch 16, bf16
        "sym_tv": ("sym_tv.cu", "tpgan_tpu/ops/pallas_kernels.py:172", TRAIN_BATCH),
        "sym_tv_bwd": ("sym_tv.cu", "tpgan_tpu/ops/pallas_kernels.py:307", TRAIN_BATCH),
    }
    kernel_line = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"tpgan_tpu_torch/csrc/{src}",
        "replaces": replaces,
        # launches on the main paths: serve (4 requests) + train (5 steps)
        "launches": serve_launches[name] + train_launches[name],
        "max_abs_err": errors[name],
        **main_path(name, batch),
        "bound_by": "bytes",
        "library_ms": None,
    } for name, (src, replaces, batch) in spec.items()]}
    log(json.dumps(kernel_line))
    log(f"device: {card}")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke run failed", flush=True)
        code = 1
    sys.exit(code)
