#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which exits non-zero on failure:

1. card        — name and power limit, as nvidia-smi reports them;
2. build       — compiles every CUDA kernel from ``tpgan_tpu_torch/csrc/``
                 (one nvcc per source, all started together) and prints
                 ptxas's registers, stack frame and spills per kernel,
                 failing on any stack frame or spill;
3. kernels     — each kernel against its plain PyTorch version on the card
                 at the shapes its path gives it: the fuse forward and
                 backward ``torch.equal`` (NaN and tie cases included; the
                 backward with g a channel slice of a wider tensor, as a
                 torch.cat's backward hands it, read with no copy), the
                 symmetry+TV forward within rtol 1e-5 and bit-identical
                 over three runs with a call of another shape between
                 them, its backward ``torch.equal`` (NaN-aware) at batch
                 16 and 64 in bf16 and 8 in f32 on inputs with planted
                 ties and a NaN, in each kernel variant its plan can pick
                 (banded, both compiled band lengths among those shapes,
                 and general), each launch asserting its variant; the fuse
                 forward at batch
                 8 and 128;
                 the conv3x3+bias+LeakyReLU (K3) at the three A/B shapes
                 in bf16 (the TMA + wgmma kernel), its tail shapes (W 96
                 and 8, H 1, B 1, Cin 72, Cout 72 and 200, an f32 bias),
                 the A/B shapes through the mma_sync kernel, the first in
                 f32, the JAX test's shape and an odd one (mma_sync), each
                 asserting the kernel variant it launched, a NaN planted in
                 x, bf16 within one bf16 ulp (2^-7 |want| + 1e-6
                 max|want|), f32 within 1e-5 max|want|; a CUDA tensor the
                 kernel does not take (dtype, mixed dtypes, layout,
                 requires grad) raises;
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
                 finite, the parameters move, per step the kernels
                 launch 7 fuse / 2 fuse-backward / 1 sym-TV / 1
                 sym-TV-backward times (its banded kernel, never the
                 general one), and the fuse backward copies no g
                 (the layouts autograd hands it are recorded for phase 8);
7. train f32   — after a warm-up step, one f32 step (TF32 off,
                 deterministic cuDNN) at batch 8, once through the
                 kernels and once with every kernel wrapper forced onto
                 its plain version: metrics within 1e-5 |ref| + 1e-6,
                 every parameter's gradient within a few ulp of its
                 leaf's largest (TRAIN_F32_GRAD_ULPS);
8. timings     — each kernel against its plain version and its byte bound
                 (fuse forward at batch 8 and 128; the fuse backward and
                 K2 at batch 16 and 64, the fuse backward as the train
                 step calls it, g in the layout phase 6 recorded, the
                 whole wrapper call timed, beside a contiguous g; K3 in
                 f32 at the A/B's first shape against cuDNN, TF32 off);
                 synthesis latency and images/s at batch 8 and 128;
                 train-step ms and images/s at batch 16 and 64 with peak
                 memory; profiler breakdowns of the batch-8 forward and of
                 one batch-16 train step, with the kernel that runs just
                 before each fuse backward;
9. conv A/B    — ``tpgan_tpu_torch.examples.conv_ab``, K3's one path: the
                 kernel (``tma_wgmma``) against the mma_sync kernel (in
                 turns), cuDNN's conv + epilogue and the plain version at
                 the three head-area shapes, bf16; one JSON line per shape;
                 K3's launches equal the calls the A/B made, per variant; a
                 profile of one kernel call and of the cuDNN call at the
                 first shape;
10. loop       — ``run_gan_training`` at full size, bf16, batch 16, 4 steps
                 per dispatch (a CUDA graph of the step), 8 steps with a
                 checkpoint and a sample grid every 4, then a resume to 12:
                 every metric finite, the step numbers continue, the
                 kernels launched eagerly are the warm-up steps' before
                 each capture and the samples' forwards, the capture
                 recorded 7 / 2 / 1 / 1 launches per replay; its images/s
                 beside the eager step's of phase 8;
11. multi-step — after a warm-up step, K=3 graph replays of the f32 step
                 (batch 8, TF32 off, deterministic cuDNN) against 3 eager
                 steps from the same seeds with the optimizers made
                 capturable alike: parameters, EMA and Adam moments
                 bit-equal; profiles of the eager bf16 batch-16 step and
                 of the optimizers' update alone, default and capturable
                 (what the graph's Adam costs an eager step); then the
                 bf16 step at batch 16 and 64 as K=4 replays per
                 dispatch: images/s beside phase 8's eager step, and a
                 profile of two dispatches at batch 16 whose trace holds
                 7 / 2 / 1 / 1 launches of the fuse / fuse-backward /
                 sym-TV / sym-TV-backward kernels per replayed step, while
                 the wrappers launch nothing;
12. options    — the bf16 batch-16 step with gradient accumulation (2),
                 remat (both), and both: metrics finite, peak memory beside
                 the plain step's, and, without accumulation, each phase's
                 own peak;
13. graphed synthesis — ``tpgan_tpu_torch.bench``'s graphed and eager
                 forms at batch 8 and 128, each graph captured on one batch
                 and held against the eager form on another: bf16 and f32
                 bit-equal (f32 with deterministic cuDNN); a profile of one
                 replay whose trace holds 3 fuse kernels while the wrappers
                 launch nothing; images/s of both.

Counts are set to 0 just before each path (serve, train, conv A/B, loop) is
driven and read just after; launches made to compare a kernel with its
plain version do not count. A CUDA graph's replays run no wrapper and
count nothing (``ops.kernels.captured_launches``): the ``kernels`` line's
launches are the wrappers' own, and the profiler traces of phases 11 and 13
show that the kernels run inside the graphs. Ends with a
``{"kernels": [...]}`` line, the card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line.
Imports nothing of JAX; needs one GPU.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import os
import re
import statistics
import sys
import tempfile
import time
import traceback
from unittest import mock

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
PER_STEP = {"fuse_parts": 7, "fuse_parts_bwd": 2, "sym_tv": 1, "sym_tv_bwd": 1,
            "conv3x3_bias_lrelu": 0}
# the port's kernels by their CUDA function names, as a profiler trace
# names them (longest first: one name holds no other)
TRACE_KERNELS = re.compile(r"(fuse_parts_bwd_kernel|fuse_parts_kernel|sym_tv_bwd_general_kernel|"
                           r"sym_tv_bwd_kernel|sym_tv_kernel|conv3x3_\w*_kernel)")
# K3 on the card: (B, H, W, Cin, Cout, dtype name, variant) beside the
# three A/B shapes in bf16 — the TMA + wgmma kernel's tails (W 96: the last
# column tile runs past W; W 8; H 1; B 1; Cin 72: a zero-filled chunk tail;
# Cout 72 and 200: N tails), the dominant shape in f32, the JAX test's
# shape, odd sizes (mma_sync)
CONV_CHECKS = ((2, 6, 96, 64, 64, "bfloat16", "tma_wgmma"),
               (2, 20, 8, 64, 64, "bfloat16", "tma_wgmma"),
               (2, 1, 40, 64, 64, "bfloat16", "tma_wgmma"),
               (1, 32, 32, 128, 128, "bfloat16", "tma_wgmma"),
               (2, 16, 16, 72, 64, "bfloat16", "tma_wgmma"),
               (2, 16, 16, 64, 72, "bfloat16", "tma_wgmma"),
               (2, 12, 12, 32, 200, "bfloat16", "tma_wgmma"),
               (8, 128, 128, 64, 64, "float32", "f32"), (2, 16, 16, 8, 16, "float32", "f32"),
               (2, 16, 16, 8, 16, "bfloat16", "tma_wgmma"), (2, 9, 13, 5, 7, "float32", "f32"),
               (2, 9, 13, 5, 7, "bfloat16", "mma_sync"))
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
# its first differs from later ones in the last bits on either path, so a
# warm-up step comes first (the phase prints by how much). The cause is
# PyTorch's, not the port's (tpgan_tpu_torch/examples/first_step_bisect.py):
# the critic's weights sum their gradients from the real, fake and GP
# passes in an order autograd's engine threads settle differently on a
# process's first, slower pass. With set_multithreading_enabled(False)
# the D phase matches from its first run, as the G phase (through every
# port kernel), each D loss term alone and every single conv and linear
# call already do. The bound is a few ulp of each leaf's largest
# gradient; a backward that drops the TV term, swaps two parts or the two
# upstream scalars, or zeroes the fuse gradient moves some leaf far
# beyond it.
TRAIN_F32_GRAD_ULPS = 4
# phase 10: the loop, K steps per dispatch, a checkpoint, a sample and a
# log line every LOOP_EVERY steps, then a resume
LOOP_K = 4
LOOP_EVERY = 4
LOOP_STEPS = 8
LOOP_RESUME_TO = 12
MULTI_K = 3  # phase 11
GRAPHED_DISPATCHES = 5  # phase 11's timing: 20 steps after the capture
OPTION_STEPS = 2  # phase 12, timed after one step

def log(msg: str) -> None:
    print(msg, flush=True)


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


def slot_union_pixels() -> int:
    """Canvas pixels that some part's slot covers (the slots overlap)."""
    import numpy as np

    from tpgan_tpu_torch.ops.geometry import CANVAS_SIZE, PART_GEOMETRY

    covered = np.zeros((CANVAS_SIZE, CANVAS_SIZE), bool)
    for (h, w), (top, left) in PART_GEOMETRY.values():
        covered[top : top + h, left : left + w] = True
    return int(covered.sum())


def cat_slice(batch, layout, dtype, seed, device):
    """A cotangent of ``layout`` = (channels, wide channels, first channel)
    at ``batch``: channels [first, first + channels) of a (batch, wide, 128,
    128) tensor, as a torch.cat's backward hands it on."""
    import torch

    c, wide, first = layout
    full = torch.randn(batch, wide, 128, 128, device=device,
                       generator=torch.Generator(device=device).manual_seed(seed)).to(dtype)
    return full[:, first : first + c]


def check_kernels(dev, errors):
    """Phase 3: every kernel against its plain version; fills ``errors``
    with each kernel's max |kernel - plain|."""
    import torch

    from tpgan_tpu_torch.ops import kernels

    for batch, c, dname in [(BATCH, *s) for s in FUSE_SHAPES] + [(128, 64, "bfloat16")]:
        dtype = getattr(torch, dname)
        for nan in (False, True):
            parts = make_parts(batch, c, dtype, seed=c, device=dev)
            if nan:
                parts[2][0, 1, 3, 4] = float("nan")
                parts[1][batch - 1, 0, 39, 39] = float("nan")
            got = kernels.fuse_parts(*parts)
            want = kernels.fuse_parts_plain(*parts)
            torch.cuda.synchronize()
            if not same(got, want):
                raise AssertionError(f"fuse_parts kernel != plain at B={batch} C={c} {dname} "
                                     f"nan={nan}")
            if nan and int(got.isnan().sum()) != 2:
                raise AssertionError("fuse_parts kernel lost a NaN")
            errors["fuse_parts"] = max(errors["fuse_parts"], max_err(got, want))
            log(f"kernel check: fuse_parts B={batch} C={c} {dname} nan={nan}: equal")
            del parts, got, want

    for c, dname in FUSE_BWD_SHAPES:
        dtype = getattr(torch, dname)
        for nan, layout in ((False, "cat slice"), (True, "cat slice"), (True, "transposed")):
            parts = make_parts(TRAIN_BATCH, c, dtype, seed=c + 1, device=dev)
            g = cat_slice(TRAIN_BATCH, (c, c + 7, 4), dtype, seed=c, device=dev)
            if layout == "transposed":  # rows not dense: copied once, then the kernel
                g = g.transpose(2, 3).contiguous().transpose(2, 3)
            if nan:
                parts[2][0, 1, 3, 4] = float("nan")
                parts[0][1, 0, 31, 32] = parts[2][1, 0, 3, 7] = 1.0  # a tie at canvas (50, 50)
                g[1, 0, 50, 50] = float("nan")  # a NaN cotangent passes where part >= out
            copies = kernels.copy_counts()["fuse_parts_bwd_g"]
            got = kernels._launch_fuse_bwd(parts, g)
            want = kernels.fuse_parts_bwd_plain(parts, kernels.fuse_parts_plain(*parts), g)
            torch.cuda.synchronize()
            copied = kernels.copy_counts()["fuse_parts_bwd_g"] - copies
            if copied != (layout == "transposed"):
                raise AssertionError(f"fuse_parts_bwd copied g {copied} times ({layout})")
            for k, (a, b) in enumerate(zip(got, want)):
                if a.dtype != dtype or not same(a, b):
                    raise AssertionError(f"fuse_parts_bwd kernel != plain, part {k}, C={c} "
                                         f"{dname} nan={nan} g {layout}")
                errors["fuse_parts_bwd"] = max(errors["fuse_parts_bwd"], max_err(a, b))
            if nan and not (got[0][1, 0, 31, 32].isnan() and got[2][1, 0, 3, 7].isnan()):
                raise AssertionError("fuse_parts_bwd lost the NaN of g at a tie")
            log(f"kernel check: fuse_parts_bwd B={TRAIN_BATCH} C={c} {dname} nan={nan}: equal "
                f"(g a {layout}, {copied} copies of g)")

    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        x = make_image(TRAIN_BATCH, dtype, seed=3, device=dev)
        other = make_image(2, dtype, seed=5, device=dev)[:, :, :7, :5].contiguous()
        runs = []
        for _ in range(3):  # a call of another shape between: the finish's counter is reset
            runs.append([t.clone() for t in kernels._launch_sym_tv(x)])
            kernels._launch_sym_tv(other)
        sums, sym, tv = runs[0]
        want = kernels.sym_tv_sums_plain(x)
        want_sym, want_tv = kernels.symmetry_tv_plain(x)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for run in runs[1:] for a, b in zip(runs[0], run)):
            raise AssertionError(f"sym_tv kernel is not deterministic ({dname})")
        for name, a, b in (("sums", sums, want), ("sym", sym, want_sym), ("tv", tv, want_tv)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0, msg=f"sym_tv {name} {dname}")
        for a, b in ((sym, want_sym), (tv, want_tv)):
            errors["sym_tv"] = max(errors["sym_tv"], max_err(a, b))
        log(f"kernel check: sym_tv B={TRAIN_BATCH} {dname}: sums {sums.tolist()} vs plain "
            f"{want.tolist()}, bit-identical over three runs")
    check_sym_tv_bwd(dev, errors)

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


def check_sym_tv_bwd(dev, errors):
    """Phase 3, the K2 backward: ``torch.equal`` (NaN-aware) to its plain
    version at the main path's shapes (batch 16 and 64 bf16, the f32 check's
    batch 8; between them both compiled band lengths) on ``make_image``'s
    planted ties and a NaN, and through the general kernel (x one element
    past a 16-byte boundary; W 5), each launch asserting its variant."""
    import torch

    from tpgan_tpu_torch.ops import kernels

    g_sym, g_tv = torch.tensor(0.3, device=dev), torch.tensor(1e-3, device=dev)
    bands = set()
    for batch, dname in ((TRAIN_BATCH, "bfloat16"), (64, "bfloat16"),
                         (TRAIN_F32_BATCH, "float32")):
        dtype = getattr(torch, dname)
        x = make_image(batch, dtype, seed=3, device=dev)
        x[1, 2, 5, 5] = float("nan")
        shifted = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape)
        shifted.copy_(x)
        odd = make_image(2, dtype, seed=5, device=dev)[:, :, :7, :5].contiguous()
        plan = kernels.sym_tv_bwd_plan(tuple(x.shape), dtype)
        bands.add(plan.band_rows)
        for xin, variant in ((x, "banded"), (shifted, "general"), (odd, "general")):
            before = kernels.sym_tv_bwd_variant_counts()
            dx = kernels._launch_sym_tv_bwd(xin, g_sym, g_tv)
            dx_want = kernels.sym_tv_bwd_plain(xin, g_sym, g_tv)
            torch.cuda.synchronize()
            after = kernels.sym_tv_bwd_variant_counts()
            if after != {**before, variant: before[variant] + 1}:
                raise AssertionError(f"sym_tv_bwd {tuple(xin.shape)} {dname}: variants {before} "
                                     f"-> {after}, expected one {variant} launch")
            if dx.dtype != dtype or not same(dx, dx_want):
                raise AssertionError(f"sym_tv_bwd kernel != plain at {tuple(xin.shape)} {dname} "
                                     f"({variant}, plan {tuple(plan)})")
            errors["sym_tv_bwd"] = max(errors["sym_tv_bwd"], max_err(dx, dx_want))
        log(f"kernel check: sym_tv_bwd B={batch} {dname}: equal to plain (planted ties, a NaN) "
            f"with the plan {tuple(plan)}, and the general kernel on a misaligned x and on W=5")
    if bands != set(kernels.SYM_TV_BWD_BAND_ROWS):
        raise AssertionError(f"sym_tv_bwd: the main path's shapes ran bands of {sorted(bands)} "
                             f"rows, not every compiled one {kernels.SYM_TV_BWD_BAND_ROWS}")


def check_conv3x3(dev, errors):
    """Phase 3, K3: each kernel variant against its plain version, a NaN
    planted in x, asserting through the per-variant counts which kernel
    each shape launched; an f32 bias beside bf16; the refusals."""
    import torch

    from tpgan_tpu_torch.examples import conv_ab
    from tpgan_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    slope = conv_ab.NEGATIVE_SLOPE
    cases = ([(*s, "bfloat16", "tma_wgmma", None) for s in conv_ab.SHAPES]
             + [(*c, None) for c in CONV_CHECKS]
             + [(*s, "bfloat16", "mma_sync", "mma_sync") for s in conv_ab.SHAPES])
    for *shape, dname, variant, forced in cases:
        x, k, b = conv_ab.make_inputs(tuple(shape), dev, getattr(torch, dname))
        x[0, shape[1] // 2, shape[2] // 2, 0] = float("nan")
        before = kernels.conv3x3_variant_counts()
        if forced:
            got = kernels._launch_conv3x3(x, k, b, slope, variant=forced)
        else:
            got = kernels.conv3x3_bias_lrelu(x, k, b, slope)
        want = kernels.conv3x3_bias_lrelu_plain(x, k, b, slope)
        torch.cuda.synchronize()
        ran = {v: n - before[v] for v, n in kernels.conv3x3_variant_counts().items()
               if n != before[v]}
        if ran != {variant: 1}:
            raise AssertionError(f"conv3x3 {shape} {dname}: launched {ran}, expected {variant}")
        err = conv_ab.check_against_plain(got, want)
        h, w = shape[1:3]
        hood = (min(h // 2 + 1, h - 1) - max(h // 2 - 1, 0) + 1) * \
            (min(w // 2 + 1, w - 1) - max(w // 2 - 1, 0) + 1)
        if int(got.isnan().sum()) != hood * shape[4]:
            raise AssertionError(f"conv3x3 {shape} {dname}: {int(got.isnan().sum())} NaNs, "
                                 f"expected the pixel's 3x3 neighbourhood, {hood * shape[4]}")
        errors["conv3x3_bias_lrelu"] = max(errors["conv3x3_bias_lrelu"], err)
        log(f"kernel check: conv3x3_bias_lrelu {tuple(shape)} {dname} [{variant}]: "
            f"max|kernel - plain| {err:.3e} of max|plain| "
            f"{float(want.nan_to_num(0).float().abs().max()):.4g}, within limits; the planted "
            f"NaN covers its 3x3 neighbourhood")
        del x, k, b, got, want

    x, k, b = conv_ab.make_inputs((2, 16, 16, 64, 72), dev, torch.bfloat16)
    b32 = b.float() + 1e-3  # not representable in bf16
    before = kernels.conv3x3_variant_counts()["tma_wgmma"]
    err = conv_ab.check_against_plain(kernels.conv3x3_bias_lrelu(x, k, b32, slope),
                                      kernels.conv3x3_bias_lrelu_plain(x, k, b32, slope))
    if kernels.conv3x3_variant_counts()["tma_wgmma"] != before + 1:
        raise AssertionError("conv3x3 with an f32 bias did not launch tma_wgmma")
    errors["conv3x3_bias_lrelu"] = max(errors["conv3x3_bias_lrelu"], err)
    log(f"kernel check: conv3x3_bias_lrelu (2, 16, 16, 64, 72) bf16 with an f32 bias "
        f"[tma_wgmma]: max|kernel - plain| {err:.3e}, within limits")

    x, k, b = conv_ab.make_inputs((2, 9, 13, 5, 7), dev, torch.float32)
    for what, exc, call in (
        ("mixed dtypes", TypeError, lambda: kernels.conv3x3_bias_lrelu(x, k.bfloat16(), b)),
        ("a float16 x", TypeError, lambda: kernels.conv3x3_bias_lrelu(x.half(), k.half(), b)),
        ("a non-contiguous x", ValueError, lambda: kernels.conv3x3_bias_lrelu(
            x.transpose(1, 2).contiguous().transpose(1, 2), k, b)),
        ("an x that requires grad", ValueError, lambda: kernels.conv3x3_bias_lrelu(
            x.clone().requires_grad_(), k, b)),
    ):
        try:
            call()
            raise AssertionError(f"conv3x3_bias_lrelu accepted {what}")
        except exc:
            log(f"kernel check: conv3x3_bias_lrelu on {what} raises (no fallback)")


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
    layouts = {}  # channels -> (channels, wide channels, first channel) of the g handed on
    launch_fuse_bwd = kernels._launch_fuse_bwd

    def spy(parts, g):
        plane = g.shape[2] * g.shape[3]
        layouts[g.shape[1]] = (g.shape[1], g.stride(0) // plane, g.storage_offset() // plane
                               % (g.stride(0) // plane))
        return launch_fuse_bwd(parts, g)

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    history = []
    with mock.patch.object(kernels, "_launch_fuse_bwd", spy):
        for _ in range(TRAIN_STEPS):
            state, metrics = step_fn(state, batch, generator)
            history.append(metrics)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    copies = kernels.copy_counts()
    bwd_variants = kernels.sym_tv_bwd_variant_counts()
    for m in history:
        train_metrics_ok(m)
    want = {k: v * TRAIN_STEPS for k, v in PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    if bwd_variants != {"banded": TRAIN_STEPS, "general": 0}:
        raise AssertionError(f"train path's sym_tv_bwd variants {bwd_variants}: expected the "
                             "banded kernel every step")
    if copies != {"fuse_parts_bwd_g": 0}:
        raise AssertionError(f"train path copied g before the fuse backward: {copies}")
    moved = [sum(not torch.equal(a, p) for a, p in zip(b, m.parameters()))
             for b, m in zip(before, models)]
    if min(moved) == 0 or state.step != TRAIN_STEPS:
        raise AssertionError(f"params moved (G, D): {moved}; step {state.step} != {TRAIN_STEPS}")
    last = {k: round(float(v), 5) for k, v in history[-1].items()}
    log(f"train: full size bf16 batch {TRAIN_BATCH}, {TRAIN_STEPS} steps in {wall:.2f} s "
        f"incl. first-step set-up; launches {launches} ({PER_STEP} per step); sym_tv_bwd "
        f"variants {bwd_variants}; copies {copies}; "
        f"g handed to the fuse backward as (channels, of wide, from) {sorted(layouts.values())}; "
        f"params moved (G, D) {moved} of {[len(b) for b in before]} tensors; "
        f"last metrics {last} {tag}")
    return launches, layouts, (step_fn, state, batch, generator)


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


def time_kernels(dev, tag, layouts):
    """Phase 8, kernels: µs per call against the plain version and the
    byte bound, inputs rotated past L2. The fuse backward's whole wrapper
    call is timed with g in each ``layouts`` entry (phase 6's: how the
    train step hands it on) and, beside it, contiguous."""
    import torch

    from tpgan_tpu_torch.examples import conv_ab
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.utils.timing import HBM_BYTES_PER_S, gpu_time_ms, rotated

    rows = []

    def row(name, batch, label, k_ms, p_ms, nbytes, main=True, counted=""):
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        if main:  # the call as the main path makes it; the others are printed only
            rows.append(dict(name=name, batch=batch, label=label, ms=k_ms, plain_ms=p_ms,
                             bound_ms=bound_ms))
        log(f"time: {name} B={batch} {label}: kernel {k_ms * 1e3:.2f} us, plain "
            f"{p_ms * 1e3:.2f} us, byte bound {bound_ms * 1e3:.2f} us ({nbytes / 1e6:.2f} MB"
            f"{counted}; {bound_ms / k_ms:.0%} of bound) {tag}")

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

    # K3 in f32 at the A/B's first shape (CUDA cores, TF32 off everywhere)
    r = conv_ab.measure(conv_ab.SHAPES[0], dev, torch.float32)
    log(f"time: conv3x3_bias_lrelu {tuple(r['shape'])} float32: kernel {r['kernel_us']:.2f} us, "
        f"cuDNN {r['cudnn_us']:.2f} us, plain {r['plain_us']:.2f} us, bound {r['bound_us']:.2f} us "
        f"({r['bound_by']}; {r['bound_us'] / r['kernel_us']:.0%} of bound) {tag}")

    union = slot_union_pixels()
    for batch in (TRAIN_BATCH, 64):
        for c, dname in FUSE_BWD_SHAPES:
            dtype = getattr(torch, dname)
            size = torch.tensor([], dtype=dtype).element_size()
            parts = make_parts(batch, c, dtype, seed=2, device=dev)
            out = kernels.fuse_parts_plain(*parts)
            # parts read and grads written once, g read over the union of the slots
            part_bytes = sum(p.numel() for p in parts) * size
            nbytes = 2 * part_bytes + batch * c * union * size
            counted = (f": parts {part_bytes / 1e6:.2f} + grads {part_bytes / 1e6:.2f} + g over "
                       f"{union} px/plane {batch * c * union * size / 1e6:.2f}")
            for layout, main in ((layouts[c], True), ((c, c, 0), False)):
                if not main and layout == layouts[c]:
                    continue  # the train step hands this one on contiguous
                label = f"C={c} {dname}, g {'as the train step hands it' if main else 'contiguous'} " \
                        f"(channels {layout[2]}-{layout[2] + c - 1} of {layout[1]})"
                copies = rotated(lambda: ([p.clone() for p in parts], out.clone(),
                                          cat_slice(batch, layout, dtype, 3, dev)),
                                 nbytes + out.numel() * size)
                it = iter(range(10**9))
                k_ms = gpu_time_ms(lambda: kernels._launch_fuse_bwd(
                    *copies[next(it) % len(copies)][::2]), 100)
                p_ms = gpu_time_ms(lambda: kernels.fuse_parts_bwd_plain(
                    *copies[next(it) % len(copies)]), 30)
                row("fuse_parts_bwd", batch, label, k_ms, p_ms, nbytes, main, counted)
                del copies
            del parts, out

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
    warm-up, back to back, one synchronise at the end), with peak memory;
    returns {batch: (images/s, peak GiB)}."""
    import torch

    from tpgan_tpu_torch.entry import train_entry

    rates = {}
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
        rates[batch] = (batch / dt, peak)
        del step_fn, state, b, generator, metrics, _m
    return rates


def _f32_exact(on: bool) -> None:
    import torch

    torch.backends.cudnn.allow_tf32 = not on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = on
    torch.backends.cudnn.benchmark = False


def run_loop(dev, tag, eager_rate):
    """Phase 10: ``run_gan_training`` at full size, bf16, batch 16, K = 4
    steps per dispatch (the graphed step), 8 steps with a checkpoint and
    a sample every 4 steps, then a resume to 12. Returns the wrappers'
    launches in both runs: each capture's warm-up steps and each sample's
    forward (the graph's replays run no wrapper)."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train import loop as loop_module
    from tpgan_tpu_torch.train.checkpoint import latest_step
    from tpgan_tpu_torch.train.gan_trainer import GRAPH_WARMUP_CALLS, make_multi_step
    from tpgan_tpu_torch.train.loop import run_gan_training
    from tpgan_tpu_torch.train.metrics import MetricWriter
    from tpgan_tpu_torch.train.sampling import make_sample_fn

    cfg = make_config({"compute_dtype": "bfloat16",
                       "train": {"batch_size": TRAIN_BATCH, "checkpoint_every_steps": LOOP_EVERY}})
    pool = [synthetic_gan_batch(TRAIN_BATCH, seed=s, num_classes=cfg.G.num_classes)
            for s in range(4)]
    probe = synthetic_gan_batch(BATCH, seed=50)
    dataset = [{k: v[i] for k, v in probe.items()} for i in range(BATCH)]
    total = dict.fromkeys(PER_STEP, 0)
    multis = []  # each run's multi-step, for the capture's record of a replay

    def spy(step, k):
        multis.append(make_multi_step(step, k))
        return multis[-1]

    with tempfile.TemporaryDirectory() as root, \
            mock.patch.object(loop_module, "make_multi_step", spy):
        ckpt, logs = os.path.join(root, "ckpt"), os.path.join(root, "logs")
        writer = MetricWriter(logs, use_tensorboard=False)
        sample_fn = make_sample_fn(cfg, None, dataset, os.path.join(root, "samples"))
        runs = []
        for steps, resume in ((LOOP_STEPS, False), (LOOP_RESUME_TO, True)):
            gc.collect()
            torch.cuda.empty_cache()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            state = run_gan_training(
                cfg, itertools.cycle(pool), steps=steps, checkpoint_dir=ckpt, resume=resume,
                writer=writer, log_every=LOOP_EVERY, steps_per_dispatch=LOOP_K,
                sample_fn=sample_fn, sample_every=LOOP_EVERY, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = kernels.launch_counts()
            samples = (steps - (LOOP_STEPS if resume else 0)) // LOOP_EVERY
            # the eager warm-up steps before the capture and each sample's
            # one synthesis forward (3 fuses); the replays launch no wrapper
            want = {k: v * GRAPH_WARMUP_CALLS for k, v in PER_STEP.items()}
            want["fuse_parts"] += 3 * samples
            record = multis[-1].launches()
            if launches != want or state.step != steps or record != PER_STEP:
                raise AssertionError(f"loop to {steps}: launches {launches}, expected {want}; "
                                     f"the capture's record of a replay {record}, expected "
                                     f"{PER_STEP}; step {state.step}")
            for k in total:
                total[k] += launches[k]
            runs.append((steps, wall))
            del state
        writer.close()
        with open(os.path.join(logs, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        if [r["step"] for r in rows] != list(range(LOOP_EVERY, LOOP_RESUME_TO + 1, LOOP_EVERY)):
            raise AssertionError(f"loop metrics at steps {[r['step'] for r in rows]}")
        bad = [(r["step"], k) for r in rows for k, v in r.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"loop: non-finite metrics {bad}")
        ckpts = sorted(int(n) for n in os.listdir(ckpt) if n.isdigit())
        samples = sorted(os.listdir(os.path.join(root, "samples")))
        if latest_step(ckpt) != LOOP_RESUME_TO or ckpts != [4, 8, 12] or len(samples) != 3:
            raise AssertionError(f"loop: checkpoints {ckpts}, samples {samples}")
        size = sum(os.path.getsize(os.path.join(ckpt, "12", n))
                   for n in os.listdir(os.path.join(ckpt, "12")))
    rates = [round(r["imgs_per_sec"], 1) for r in rows]
    log(f"loop: run_gan_training full size bf16 batch {TRAIN_BATCH}, {LOOP_K} steps per dispatch "
        f"(CUDA graph), to step {LOOP_STEPS} in {runs[0][1]:.1f} s, resumed to {LOOP_RESUME_TO} in "
        f"{runs[1][1]:.1f} s (wall, incl. set-up, captures, checkpoints of {size / 2**30:.2f} GiB "
        f"and samples); metrics at steps {[r['step'] for r in rows]} finite; checkpoints {ckpts}; "
        f"wrapper launches {total} (warm-ups and samples); the capture's record of a replay "
        f"{multis[-1].launches()}; imgs_per_sec per logged window {rates} (steps "
        f"{LOOP_EVERY + 1}-{2 * LOOP_EVERY}: graph replays only) against the eager step's "
        f"{eager_rate:.1f} (phase 8) {tag}")
    return total


def run_multi_step_f32(dev):
    """Phase 11: K=3 graph replays of the f32 step against 3 eager steps
    from the same seeded state, batches and generator seed, the eager
    step's optimizers made capturable as the capture makes the graph's."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.train.gan_trainer import (
        create_gan_state,
        make_gan_train_step,
        make_multi_step,
    )
    from tpgan_tpu_torch.train.optim import make_capturable

    _f32_exact(True)
    cfg = make_config({"compute_dtype": "float32"})
    batches = [synthetic_gan_batch(TRAIN_F32_BATCH, seed=20 + i) for i in range(MULTI_K)]
    # a process's first f32 step differs in the last bits from later ones
    # (phase 7's reason, ROADMAP C2): one step first, thrown away
    warm = create_gan_state(cfg, seed=0, device=dev)
    make_gan_train_step(cfg, *warm[1:])(warm[0], batches[0],
                                        torch.Generator(device=dev).manual_seed(1))
    del warm
    runs = []
    for graphed in (False, True):
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
        generator = torch.Generator(device=dev).manual_seed(9)
        if graphed:
            multi = make_multi_step(step, MULTI_K)
            state, metrics = multi(
                state, {k: np.stack([b[k] for b in batches]) for k in batches[0]}, generator)
            if multi.launches() != PER_STEP:
                raise AssertionError(f"multi-step f32: per replay {multi.launches()}")
        else:
            make_capturable(g_opt)
            make_capturable(d_opt)
            history = [step(state, b, generator)[1] for b in batches]
            metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
        torch.cuda.synchronize()
        leaves = {**{f"G.{n}": p for n, p in gen.named_parameters()},
                  **{f"D.{n}": p for n, p in disc.named_parameters()},
                  **{f"ema.{n}": t for n, t in state.g_ema_params.items()}}
        for tag_, opt, model in (("G", g_opt, gen), ("D", d_opt, disc)):
            for n, p in model.named_parameters():
                leaves[f"{tag_}.exp_avg.{n}"] = opt.state[p]["exp_avg"]
                leaves[f"{tag_}.exp_avg_sq.{n}"] = opt.state[p]["exp_avg_sq"]
        runs.append(({k: v.clone() for k, v in metrics.items()},
                     {k: v.detach().clone() for k, v in leaves.items()}, state.step))
        del state, gen, disc, g_opt, d_opt, step
    _f32_exact(False)
    (m_e, l_e, s_e), (m_g, l_g, s_g) = runs
    ndiff = sum(int((l_g[k] != l_e[k]).sum()) for k in l_e)
    total = sum(v.numel() for v in l_e.values())
    worst = 0.0
    for k, want in l_e.items():
        scale = float(want.abs().max())
        d = float((l_g[k] - want).abs().max())
        if ndiff and not d <= TRAIN_F32_GRAD_ULPS * float(np.spacing(np.float32(scale))):
            raise AssertionError(f"multi-step f32 {k}: graph vs eager max|diff| {d} beyond "
                                 f"{TRAIN_F32_GRAD_ULPS} ulp of max {scale}")
        worst = max(worst, d / scale if scale else 0.0)
    mdiff = sum(int((m_g[k] != m_e[k]).sum()) for k in m_e)
    if s_e != s_g or s_g != MULTI_K:
        raise AssertionError(f"multi-step f32: steps {s_e} / {s_g}")
    log(f"multi-step f32: batch {TRAIN_F32_BATCH}, {MULTI_K} graph replays against {MULTI_K} "
        f"eager steps (TF32 off, deterministic cuDNN, same seeds, capturable Adam on both "
        f"sides): {ndiff} of {total} elements "
        f"of the parameters, EMA and Adam moments differ (worst leaf {worst:.3e} of its max), "
        f"{mdiff} of {sum(v.numel() for v in m_e.values())} metric values; the capture's "
        f"record of a replay {PER_STEP}")


def capturable_cost(dev, tag, cfg):
    """Phase 11: what the graph's capturable Adam and fixed ``.grad``
    buffers cost the eager bf16 step: profiles of the step, and of both
    optimizers' update alone, default and then capturable, on a state of
    its own."""
    import torch

    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step
    from tpgan_tpu_torch.train.optim import make_capturable

    state, *models = create_gan_state(cfg, seed=0, device=dev)
    step = make_gan_train_step(cfg, *models)
    batch = synthetic_gan_batch(TRAIN_BATCH, seed=0, num_classes=cfg.G.num_classes)
    generator = torch.Generator(device=dev).manual_seed(0)
    box = [state]

    def one_step():
        box[0], _ = step(box[0], batch, generator)

    def update():
        state.d_opt.step()
        state.g_opt.step()

    out = {}
    for mode in ("default", "capturable"):
        if mode == "capturable":
            make_capturable(state.g_opt)
            make_capturable(state.d_opt)
        one_step()  # first use of this mode
        out[mode] = (profile(one_step, 2, f"eager train step bf16 batch {TRAIN_BATCH}, {mode} "
                             "Adam", "step", tag, {}),
                     profile(update, 2, f"D + G Adam update alone, {mode}", "update", tag, {}))
    if any(p is None for pair in out.values() for p in pair):
        log("capturable cost: the profiler recorded no device time (not measured)")
        return
    (s0, a0), (s1, a1) = out["default"], out["capturable"]
    step_k, step_ms = s1["kernels"] - s0["kernels"], s1["busy_ms"] - s0["busy_ms"]
    adam_k, adam_ms = a1["kernels"] - a0["kernels"], a1["busy_ms"] - a0["busy_ms"]
    log(f"capturable cost: eager bf16 step batch {TRAIN_BATCH}: default {s0['kernels']:.0f} "
        f"kernels, {s0['busy_ms']:.2f} ms busy per step; capturable Adam + fixed .grad "
        f"{s1['kernels']:.0f} kernels, {s1['busy_ms']:.2f} ms ({step_k:+.0f}, {step_ms:+.2f} ms); "
        f"the Adam update alone {a0['kernels']:.0f} -> {a1['kernels']:.0f} kernels, "
        f"{a0['busy_ms']:.2f} -> {a1['busy_ms']:.2f} ms ({adam_k:+.0f}, {adam_ms:+.2f} ms); the "
        f"rest, the gradient copies, {step_k - adam_k:+.0f} kernels, {step_ms - adam_ms:+.2f} ms "
        f"{tag}")


def time_graphed_step(dev, tag, eager):
    """Phase 11, timing: the full-size bf16 step as K = LOOP_K replays per
    dispatch at batch 16 and 64, after the capture, ``GRAPHED_DISPATCHES``
    dispatches back to back, after what the capturable optimizers cost
    the eager step (:func:`capturable_cost`); at batch 16, then, a profile
    of two dispatches whose trace must hold each kernel's launches per
    replayed step while the wrappers launch nothing."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train.gan_trainer import (
        create_gan_state,
        make_gan_train_step,
        make_multi_step,
    )

    cfg = make_config({"compute_dtype": "bfloat16"})
    capturable_cost(dev, tag, cfg)
    for batch in (TRAIN_BATCH, 64):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        multi = make_multi_step(make_gan_train_step(cfg, gen, disc, g_opt, d_opt), LOOP_K)
        b = synthetic_gan_batch(batch, seed=0, num_classes=cfg.G.num_classes)
        super_batch = {k: np.stack([v] * LOOP_K) for k, v in b.items()}
        generator = torch.Generator(device=dev).manual_seed(0)
        state, metrics = multi(state, super_batch, generator)  # the capture
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPHED_DISPATCHES):
            state, metrics = multi(state, super_batch, generator)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (GRAPHED_DISPATCHES * LOOP_K)
        for k in metrics:
            if not torch.isfinite(metrics[k].float()).all():
                raise AssertionError(f"graphed step batch {batch}: non-finite {k}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"time: graphed train step bf16 full size batch {batch}: {dt * 1e3:.2f} ms/step = "
            f"{batch / dt:.1f} images/s ({GRAPHED_DISPATCHES} dispatches of {LOOP_K} replays "
            f"after the capture, batches copied in from the host; eager {eager[batch][0]:.1f} "
            f"images/s in phase 8); peak memory {peak:.2f} GiB {tag}")
        if batch == TRAIN_BATCH:
            box = [state]

            def dispatch():
                box[0], _ = multi(box[0], super_batch, generator)

            kernels.reset_launch_counts()
            stats = profile(dispatch, 2, f"graphed train step bf16 batch {batch}, {LOOP_K} "
                            "replays per dispatch", "dispatch", tag,
                            {"fuse_parts": ["fuse_parts_kernel"]})
            wrappers = kernels.launch_counts()
            if any(wrappers.values()):
                raise AssertionError(f"graph replays went through the wrappers: {wrappers}")
            replays = 2 * LOOP_K
            traced = check_traced(stats, f"graphed step, {replays} replays", {
                "fuse_parts_kernel": 7 * replays, "fuse_parts_bwd_kernel": 2 * replays,
                "sym_tv_kernel": replays, "sym_tv_bwd_kernel": replays})
            log(f"graphed step: the trace of {replays} replayed steps holds {traced} (7 / 2 / 1 / 1 "
                f"per step); the wrappers launched nothing {tag}")
            del box
        del state, gen, disc, g_opt, d_opt, multi, metrics


def run_options(dev, tag, plain_peak):
    """Phase 12: the bf16 batch-16 step with each option; metrics finite,
    ms/step and peak memory beside the plain step's."""
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

    batch = synthetic_gan_batch(TRAIN_BATCH, seed=0)
    out = []
    for name, train in (("plain", {}), ("accum 2", {"grad_accum_steps": 2}),
                        ("remat both", {"remat": True, "remat_scope": "both"}),
                        ("accum 2 + remat both", {"grad_accum_steps": 2, "remat": True,
                                                  "remat_scope": "both"})):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = make_config({"compute_dtype": "bfloat16", "train": train})
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
        generator = torch.Generator(device=dev).manual_seed(0)
        state, metrics = step(state, batch, generator)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OPTION_STEPS):
            state, metrics = step(state, batch, generator)
            train_metrics_ok(metrics)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / OPTION_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        line = f"{name} {dt * 1e3:.1f} ms/step, peak {peak:.2f} GiB"
        if not train.get("grad_accum_steps"):
            # where the peak is: one more step, phase by phase (the step's
            # exposed parts), the peak of each
            nchw, (z, gp_eps, mask_d, mask_g) = step.prepare(batch, generator)
            phases = {}
            for phase, run in (("D", lambda: step.d_phase(nchw, z, gp_eps, mask_d)),
                               ("G", lambda: step.g_phase(nchw, z, mask_g))):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                run()
                torch.cuda.synchronize()
                phases[phase] = torch.cuda.max_memory_allocated() / 2**30
            line += f" (D phase peak {phases['D']:.2f}, G phase {phases['G']:.2f} GiB)"
        out.append(line)
        del state, gen, disc, g_opt, d_opt, step, metrics
    log(f"options: bf16 full size batch {TRAIN_BATCH}, {OPTION_STEPS} steps after one, metrics "
        f"finite: {'; '.join(out)} (phase 8's plain step: peak {plain_peak:.2f} GiB) {tag}")


def run_graphed_synthesis(dev, tag):
    """Phase 13: the bench's graphed and eager synthesis at batch 8 and 128:
    each graph captured on one batch and held against the eager form on
    another, bit for bit; a profile of one replay whose trace holds the 3
    fuse kernels of a forward while the wrappers launch nothing; images/s
    of both forms."""
    import torch

    from tpgan_tpu_torch import bench
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train.gan_trainer import (
        SYNTHESIS_KEYS,
        build_generator,
        make_graphed_synthesize_fn,
        make_synthesize_fn,
    )

    def request(batch, seed):
        """A batch of its own from ``seed``, on the card."""
        inputs = {k: torch.as_tensor(v, device=dev)
                  for k, v in synthetic_gan_batch(batch, seed=seed).items() if k in SYNTHESIS_KEYS}
        z = torch.randn(batch, 64, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
        return inputs, z

    lines = []
    for dname in ("bfloat16", "float32"):
        _f32_exact(dname == "float32")
        if dname == "bfloat16":
            fns = bench.build_synthesizers("bf16", dev)
        else:
            cfg = make_config({"compute_dtype": "float32"})
            gen = build_generator(cfg, dev, seed=0)
            fns = {"graphed": make_graphed_synthesize_fn(cfg, gen),
                   "eager": make_synthesize_fn(cfg, gen)}
        for batch in (BATCH, 128):
            fns["graphed"](*request(batch, 1))  # the capture, on its own batch
            inputs, z = request(batch, 2)
            kernels.reset_launch_counts()
            got = fns["graphed"](inputs, z)
            torch.cuda.synchronize()
            wrappers = kernels.launch_counts()
            want = fns["eager"](inputs, z)
            err = float((got.float() - want.float()).abs().max())
            record = fns["graphed"].launches()[batch]["fuse_parts"]
            if not torch.equal(got, want) or any(wrappers.values()) or record != 3:
                raise AssertionError(f"graphed synthesis {dname} B={batch}: max|graphed - eager| "
                                     f"{err} on a batch other than the capture's; wrapper "
                                     f"launches over a replay {wrappers}; the capture's record "
                                     f"{record} fuses")
            line = f"{dname} B={batch}: graphed == eager on a batch other than the capture's"
            if dname == "bfloat16":
                if batch == BATCH:
                    stats = profile(lambda: fns["graphed"](inputs, z), 1,
                                    f"graphed bf16 synthesis batch {batch}", "forward", tag,
                                    {"fuse_parts": ["fuse_parts_kernel"]})
                    check_traced(stats, "one graphed forward", {"fuse_parts_kernel": 3})
                    line += ", the trace of one replay holds 3 fuse kernels"
                rates = {form: bench.measure(fns[form], batch, dev) for form in ("graphed", "eager")}
                line += (f", {rates['graphed']:.1f} images/s graphed against {rates['eager']:.1f} "
                         f"eager ({bench.SCAN_LEN} dependent forwards per timed dispatch, best "
                         f"of 3)")
            lines.append(line)
        del fns
        torch.cuda.empty_cache()
    _f32_exact(False)
    log(f"graphed synthesis: {'; '.join(lines)} {tag}")


def profile(fn, iters, what, unit, tag, names, before=None):
    """Busy/idle share, kernels per call, the top-8 kernels and the share
    of each named kernel, over ``iters`` calls of ``fn``; with ``before``,
    the device kernels that ran just before each kernel of that name.
    Returns ``{"busy_ms", "kernels"}`` per call and ``"traced"``: the
    port's kernels in the trace, {CUDA function name: launches in all
    ``iters`` calls}; None when the profiler recorded no device time."""
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
        return None
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    shares = []
    for label, keys in names.items():
        us = sum(v for k, v in by_name.items() if any(s in k for s in keys))
        shares.append(f"{label} {us / iters:.1f} us/{unit} ({us / busy_us:.2%} of busy)")
    log(f"profile: {what}, {iters} {unit}s: wall {wall_us / iters / 1e3:.2f} ms/{unit}, "
        f"device busy {busy_us / iters / 1e3:.2f} ms/{unit} ({busy_us / wall_us:.0%}; idle "
        f"{1 - busy_us / wall_us:.0%}), {round(len(kern) / iters)} kernels/{unit}; "
        f"{'; '.join(shares)} {tag}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"profile:   {us / iters / 1e3:8.3f} ms/{unit}  {name[:110]}")
    if before:
        timeline = sorted(kern, key=lambda e: e.time_range.start)
        for prev, e in zip(timeline, timeline[1:]):
            if before in e.name:
                log(f"profile:   before {before}: {prev.time_range.elapsed_us():.2f} us "
                    f"{'[a copy] ' if 'copy' in prev.name.lower() else ''}{prev.name[:100]}")
    top = sorted(left_out.items(), key=lambda kv: -kv[1])[:3]
    log(f"profile:   left out of busy time: {sum(left_out.values()) // iters} annotation "
        f"ranges/{unit} {[(n[:40], c // iters) for n, c in top]}")
    traced = {}
    for e in kern:
        m = TRACE_KERNELS.search(e.name)
        if m:
            traced[m.group(1)] = traced.get(m.group(1), 0) + 1
    return {"busy_ms": busy_us / iters / 1e3, "kernels": len(kern) / iters, "traced": traced}


def check_traced(stats, what, want):
    """Raise unless the profile ``stats`` traced exactly ``want``: {CUDA
    function name: launches}, the kernels that ran on the device."""
    got = None if stats is None else stats["traced"]
    if got != want:
        raise AssertionError(f"{what}: the profiler trace holds the port's kernels {got}, "
                             f"expected {want}")
    return want


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke run needs an NVIDIA GPU")
        return 2
    try:
        from tpgan_tpu_torch.config import make_config
        from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
        from tpgan_tpu_torch.entry import entry
        from tpgan_tpu_torch.examples import conv_ab
        from tpgan_tpu_torch.models import generator as generator_module
        from tpgan_tpu_torch.ops import _build, kernels
        from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn
        from tpgan_tpu_torch.utils.timing import card_info
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
        fn = stack = None
        for line in text:
            if "Compiling entry function" in line:
                fn = line.split("'")[1] if "'" in line else line.strip()
                stack = None
            elif "stack frame" in line:
                stack = line.strip()
                used = [int(n) for n in re.findall(r"(\d+) bytes (?:stack frame|spill)", line)]
                if any(used):  # every kernel keeps its state in registers
                    raise AssertionError(f"{source}: {fn} has a stack frame or spills: {stack}")
            elif "registers" in line:
                log(f"    {fn}: {line.split(':', 1)[-1].strip()}; {stack or 'no stack report'}")
        if not text:
            log("    (cached build, no ptxas report)")

    # ---- 3. each kernel against its plain version ----
    errors = dict.fromkeys(PER_STEP, 0.0)
    check_kernels(dev, errors)
    check_conv3x3(dev, errors)

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
    want = {"fuse_parts": 3 * REQUESTS, "fuse_parts_bwd": 0, "sym_tv": 0, "sym_tv_bwd": 0,
            "conv3x3_bias_lrelu": 0}
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
    train_launches, g_layouts, (step_fn, state, tbatch, tgen) = run_train(dev, tag)
    b8 = {k: torch.as_tensor(v, device=dev) for k, v in requests[0][0].items()
          if k in ("img", "left_eye", "right_eye", "nose", "mouth")}
    z8 = torch.as_tensor(requests[0][1], device=dev)
    train_box = [state]

    def one_step():
        train_box[0], _ = step_fn(train_box[0], tbatch, tgen)

    profile(one_step, 2, f"train step bf16 batch {TRAIN_BATCH}", "step", tag, {
        "fuse_parts": ["fuse_parts_kernel"], "fuse_parts_bwd": ["fuse_parts_bwd_kernel"],
        "sym_tv": ["sym_tv_kernel"], "sym_tv_bwd": ["sym_tv_bwd_kernel"],
    }, before="fuse_parts_bwd_kernel")
    del step_fn, state, train_box, tbatch, tgen

    # ---- 7. train f32: kernels vs plain versions ----
    torch.cuda.empty_cache()
    run_train_f32(dev)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False

    # ---- 8. timings ----
    rows = time_kernels(dev, tag, g_layouts)
    time_synthesis(dev, synthesize, cfg.G.zdim, tag)
    profile(lambda: synthesize(b8, z8), 3, f"bf16 synthesis batch {BATCH}", "forward", tag,
            {"fuse_parts": ["fuse_parts_kernel"]})
    del gen, synthesize, outputs
    torch.cuda.empty_cache()
    train_rates = time_train(dev, tag)

    # ---- 9. conv A/B: K3 against cuDNN's conv + epilogue ----
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    ab_rows = conv_ab.run(dev, log=log)  # one JSON line per shape
    torch.cuda.synchronize()
    ab_launches = kernels.launch_counts()
    ab_variants = kernels.conv3x3_variant_counts()
    calls = sum(r["kernel_calls"] for r in ab_rows)
    mma_calls = sum(r["mma_sync_calls"] for r in ab_rows)
    if ab_launches != {**dict.fromkeys(ab_launches, 0), "conv3x3_bias_lrelu": calls + mma_calls}:
        raise AssertionError(f"conv A/B launches {ab_launches}, expected {calls + mma_calls} "
                             "conv3x3 only")
    if ab_variants != {"tma_wgmma": calls, "mma_sync": mma_calls, "f32": 0}:
        raise AssertionError(f"conv A/B variants {ab_variants}: expected {calls} tma_wgmma "
                             f"and {mma_calls} mma_sync")
    log(f"conv A/B: {len(ab_rows)} shapes, {calls} tma_wgmma + {mma_calls} mma_sync calls = "
        f"launches {ab_variants} {tag}")
    conv_row = ab_rows[0]  # (8, 128, 128, 64, 64): the shape the JAX package calls dominant
    x, k, b = conv_ab.make_inputs(conv_ab.SHAPES[0], dev)
    weight = kernels.conv3x3_weight_oihw(k)
    cudnn_call = lambda: kernels.conv3x3_bias_lrelu_cudnn(x, weight, b, conv_ab.NEGATIVE_SLOPE)
    kernel_call = lambda: kernels.conv3x3_bias_lrelu(x, k, b, conv_ab.NEGATIVE_SLOPE)
    kernel_call()
    profile(kernel_call, 20, f"K3 tma_wgmma {conv_ab.SHAPES[0]} bf16", "call", tag,
            {"K3": ["conv3x3_tma_wgmma_kernel"]})
    with conv_ab.library_settings():  # the A/B's: cuDNN's algorithm is already chosen
        cudnn_call()
        profile(cudnn_call, 20, f"cuDNN conv + epilogue {conv_ab.SHAPES[0]} bf16", "call", tag,
                {"conv": ["fprop", "conv"], "bias add": ["Functor_add"],
                 "leaky_relu": ["leaky_relu"]})
    del x, k, b, weight

    # ---- 10-13. the loop, multi-step, options, graphed synthesis ----
    torch.cuda.empty_cache()
    loop_launches = run_loop(dev, tag, train_rates[TRAIN_BATCH][0])
    run_multi_step_f32(dev)
    time_graphed_step(dev, tag, train_rates)
    run_options(dev, tag, train_rates[TRAIN_BATCH][1])
    run_graphed_synthesis(dev, tag)

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
        # wrapper launches on the main paths: serve (4 requests) + train
        # (5 steps) + the loop's eager calls (2 captures' warm-up steps and
        # 3 samples' forwards); the loop's graph replays run no wrapper (the
        # traces of phases 11 and 13 show their kernels)
        "launches": serve_launches[name] + train_launches[name] + loop_launches[name],
        "max_abs_err": errors[name],
        **main_path(name, batch),
        "bound_by": "bytes",
        "library_ms": None,
    } for name, (src, replaces, batch) in spec.items()]}
    kernel_line["kernels"].append({
        "name": "conv3x3_bias_lrelu",
        "route": "cuda",
        "source": "tpgan_tpu_torch/csrc/conv3x3.cu",
        "replaces": "tpgan_tpu/ops/pallas_kernels.py:260",
        # launches on its one path, the conv A/B
        "launches": ab_launches["conv3x3_bias_lrelu"],
        "max_abs_err": errors["conv3x3_bias_lrelu"],
        "ms": conv_row["kernel_us"] / 1e3,
        "plain_ms": conv_row["plain_us"] / 1e3,
        "bound_ms": conv_row["bound_us"] / 1e3,
        "bound_by": conv_row["bound_by"],
        "library_ms": conv_row["cudnn_us"] / 1e3,
    })
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
