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
                 launch nothing; images/s of both;
14. data       — the port's data path: (a) the procedural Multi-PIE
                 protocol (8 subjects x 9 cameras, 64 training items)
                 rendered, prepared and written as PNGs, then packed into
                 uint8 shards; (b) ``run_gan_training`` at full size, bf16,
                 batch 16, 4 steps per dispatch, 8 steps, fed by the shards
                 through 2 loader workers, pinned memory and
                 ``prefetch_to_device``; (c) the same loop fed by
                 ``device_batch_iterator`` from the 64 items repeated to
                 2,560 (0.42 GB) in device memory, yaw-weighted; in both,
                 metrics finite and every batch the step received equal to
                 its host copy (position-weighted checksums on the card
                 and on the host); (d) an f32 step on a uint8 batch equal
                 to the step on the batch decoded beforehand, bit for bit,
                 and its profiler trace's host-to-device bytes equal to
                 the uint8 batch's; (e) ``bench_loader``'s four input
                 paths at batch 16 and 64 beside the graphed step's
                 images/s (phase 11), and the loop rates beside phase 10's.
                 Its launches are printed on their own line, not counted
                 in the ``kernels`` line.
15. identity and eval — the identity embedder and the evaluation: (a) the
                 full-width ResNet18 (f32 and bf16) and MobileNetV2Classifier
                 (f32) forwards on the card against the same seeded weights'
                 f32 forward on the CPU (f32 within 1e-4 of each output's
                 largest magnitude, TF32 off, deterministic cuDNN; bf16
                 within 5%), and the embedder's forward images/s in f32 and
                 bf16; (b) ``run_feature_extract_training`` on the procedural
                 protocol, 16 subjects x 9 cameras, 4 whole subjects held
                 out, batch 64, 30 augmented SGD steps, one validation and a
                 checkpoint: metrics finite, parameters moved, the checkpoint
                 reloads bit for bit; (c) the full-size bf16 GAN step with
                 that checkpoint frozen as the identity embedder, eager and
                 as K=4 graph replays, at batch 16 and 64: the identity term
                 > 0 and finite, 7 / 2 / 1 / 1 launches per step, the
                 embedder's weights, gradients and BatchNorm statistics
                 untouched; images/s and peak memory beside phases 8 and 11,
                 and the embedder's share of a batch-16 step's device busy
                 time (profiles of the step with and without the term); (d)
                 phase 7's f32 kernels-against-plain check and phase 11's
                 replays-against-eager check with the term on; (e)
                 ``evaluate_protocol`` on the rendered protocol with 2 noise
                 draws, G from the step's checkpoint, through the graphed and
                 the eager synthesis: PSNR finite, SSIM, Rank-1 and identity
                 similarity in range, every camera scored, graphed equal to
                 eager; images/s over three whole passes after the checked
                 one, the first call (the graph's capture) timed apart. Its
                 launches go on their own line.

16. detector    — the landmark detector (no port kernel on its path): (1)
                 a CelebA-layout corpus of 640 JPEGs (160-320 px, 512
                 subjects, quality 92) rendered by the port's
                 ``generate_pretrain_protocol``, 16 files decoded by the
                 host library and the Python reference, equal; the codec's
                 encode and decode images/s on one thread; (2) the forward
                 on the card in both head modes, eval and train-mode
                 BatchNorm, within 1e-4 of each output's largest of the
                 same weights' f32 forward on the CPU (TF32 off); (3) one
                 f32 pretrain step, batch 8, 256², on the card against the
                 CPU with the same uniforms: the assignment equal, the loss
                 within 1e-5 |ref| + 1e-6, parameters and statistics within
                 DETECTOR_STEP_ULPS ulp of each leaf's largest; (4)
                 ``run_pretrain`` as ``cmd_pretrain`` drives it, 2 epochs
                 and a resume to 3, from the JPEG files through
                 ``batch_iterator`` (one 256 bucket) and from two buckets
                 (256, 384) resident in device memory with pixel-budget
                 batches: metrics finite, parameters moved, the nose prior
                 in ``detector_meta.json``, per-epoch checkpoints and
                 ``best/``, the resume continuing the steps and the
                 schedule, the checkpoint reloading bit for bit; (5) the
                 eager f32 step's ms and images/s at batch 64, 256², both
                 head modes (TF32 as cuDNN defaults it; the absolute head
                 also with TF32 off), peak memory, a profile of one step
                 (no port kernel in its trace) and the eval step's
                 images/s. Its launches (none) go on their own line.

Counts are set to 0 just before each path (serve, train, conv A/B, loop,
phase 14's two loops, phase 15's steps and protocol runs, and phase 16's
two ``run_pretrain`` runs) is driven
and read just after; launches made to compare a kernel with its
plain version do not count. A CUDA graph's replays run no wrapper and
count nothing (``ops.kernels.captured_launches``): the ``kernels`` line's
launches are the wrappers' own, and the profiler traces of phases 11 and 13
show that the kernels run inside the graphs. Ends with a
``{"kernels": [...]}`` line, the card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line.
Imports nothing of JAX; needs one GPU.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import itertools
import json
import os
import re
import statistics
import subprocess
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
# phase 14: the data path. 8 subjects x 9 cameras: 64 training items (the
# profiles; the frontal view is each one's twin); the device-resident pack
# repeats them 40 times, 2,560 items, the size of the full Multi-PIE GAN
# layout (0.42 GB uint8)
DATA_SUBJECTS = 8
DATA_REPEAT = 40
DATA_WORKERS = 2
LOADER_WORKERS = 4
LOADER_BATCHES = 16
HTOD_TRACES = 2
# phase 15: the identity embedder and the evaluation. 16 subjects x 9
# cameras, 4 held out whole (their frontal image the gallery)
IDENTITY_SUBJECTS = 16
IDENTITY_HELD_OUT = 4
EMBEDDER_BATCH = 64
EMBEDDER_STEPS = 30
EMBEDDER_CHECK_BATCH = 8
EMBEDDER_F32_TOL = 1e-4  # of each output's largest magnitude, TF32 off
IDENTITY_STEPS = ((TRAIN_BATCH, 10), (64, 5))  # (batch, timed eager steps)
EVAL_BATCH = 16
EVAL_Z = 2
EVAL_TIMED_PASSES = 3  # protocol passes timed after the checked one, for (e)'s images/s
PROFILE_CAMERAS = {"110", "120", "090", "080", "130", "140", "010", "200"}
# phase 16: the landmark detector. The CelebA-layout corpus at the JAX
# package's defaults (160-320 px, 512 subjects), the pretrain config's
# image size and batch (tpgan_tpu/config.py:54,61)
DETECTOR_IMAGES = 640
DETECTOR_DECODE_CHECK = 16
DETECTOR_ENCODE_TIMED = 64
DETECTOR_SIZE = 256
DETECTOR_BATCH = 64
DETECTOR_CHECK_BATCH = 2
DETECTOR_STEP_BATCH = 8
DETECTOR_F32_TOL = 1e-4  # of each output's largest magnitude, TF32 off
# the f32 forward on the card against the CPU (TF32 off): eval mode within
# DETECTOR_F32_TOL of each output's largest; train-mode BatchNorm takes
# the batch's statistics, summed in other orders on the card and the CPU
# (2.9e-5 - 1.1e-4 on the H100 at 700 W)
DETECTOR_F32_TRAIN_TOL = 5e-4
# the f32 step on the card against the CPU: the parameters' movement in
# relative L2 over all leaves (the CPU tests hold each f32 side within
# 2.5e-2 of a float64 run: the seeded MobileNetV2 is ill-conditioned in
# f32; 7.8e-3 - 2.0e-2 card against CPU on the H100 at 700 W), and every
# BatchNorm's running statistics within 1e-4 of its largest variance (a
# running mean near 0 is noise: a leaf's own largest is no scale there,
# nor for a bias that starts at 0)
DETECTOR_MOVE_REL_L2 = 5e-2
DETECTOR_STATS_TOL = 1e-4
DETECTOR_TIMED_STEPS = 10
# run_pretrain as cmd_pretrain drives it: 544 training and 64 validation
# images, validation every 5 steps, 2 epochs then a resume to 3, the
# learning rate's milestones at epochs 1 and 2
DETECTOR_OVERRIDES = ["pretrain.train_data_ratio=0.85", "pretrain.validation_data_ratio=0.1",
                      "pretrain.log_step_of_batchs=5", "pretrain.num_epochs=2",
                      "pretrain.learning_rate_scheduler_milestone=(1,2)"]

def log(msg: str) -> None:
    print(msg, flush=True)


PR_SET_CHILD_SUBREAPER = 36


def adopt_orphans() -> None:
    """Make this process the subreaper of every process it starts, so that
    a grandchild whose parent exits first (a data-loader worker, a
    compiler's child) becomes its child, where stop_processes finds it."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)


def children(parent=None) -> dict:
    """{pid: (state, command line)} of the children of ``parent`` (this
    process by default), from /proc."""
    parent, out = parent or os.getpid(), {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace").strip()
        except OSError:
            continue
        fields = stat.rsplit(")", 1)[1].split()  # state, ppid, ...
        if int(fields[1]) == parent:
            out[int(entry)] = (fields[0], cmd[:200] or stat.split(" ", 2)[1])
    return out


def stop_processes(grace_s: float = 10.0) -> dict:
    """Stop every process of this run that still runs, before the script
    exits, and return those that were left, {pid: (state, command line)}.
    The data loader's worker server and its resource tracker are stopped
    as ``pipeline.stop_worker_server`` stops them (Python would stop them
    only after the program has exited, and the server outlives it while
    its preload still runs). A worker that still runs (an iterator a
    failure left open) holds the server, so it is sent SIGTERM first.
    Then every other child, orphans included, gets SIGTERM and after
    ``grace_s`` SIGKILL, round by round until none is left, each reaped."""
    import signal
    import threading

    left = {}
    # the run is over: DataLoader's SIGCHLD handler would raise on a
    # worker stopped here
    signal.signal(signal.SIGCHLD, signal.SIG_DFL)
    pipeline = sys.modules.get("tpgan_tpu_torch.data.pipeline")
    if pipeline is not None:
        from multiprocessing import forkserver

        server = forkserver._forkserver._forkserver_pid
        workers = children(server) if server else {}
        for pid, (state, _) in workers.items():
            if state != "Z":
                left[pid] = workers[pid]
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGTERM)
        # bounded: what still holds the server after grace_s is killed below
        stopper = threading.Thread(target=pipeline.stop_worker_server, daemon=True)
        stopper.start()
        stopper.join(grace_s)
    deadline = time.monotonic() + grace_s
    while True:
        now = children()
        if not now:
            break
        late = time.monotonic() > deadline
        for pid, (state, cmd) in now.items():
            left.setdefault(pid, (state, cmd))
            if state != "Z":
                with contextlib.suppress(OSError):
                    os.kill(pid, signal.SIGKILL if late else signal.SIGTERM)
            with contextlib.suppress(ChildProcessError):
                os.waitpid(pid, 0 if late else os.WNOHANG)
        time.sleep(0.05)
    return left


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


def run_train_f32(dev, identity_embed=None):
    """Phase 7: after a warm-up step, one f32 step through the kernels and
    one through the plain versions, from the same seeded state, batch and
    noise; their gradients are held leaf by leaf. Phase 15 (d) runs it with
    the identity term on (``identity_embed``)."""
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
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, identity_embed)
        kernels.reset_launch_counts()
        forced = mock.patch.object(kernels, "_dispatch", lambda x, name: False)
        with forced if plain else contextlib.nullcontext():
            state, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(9))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        if plain != (sum(counts.values()) == 0):
            raise AssertionError(f"f32 step ({'plain' if plain else 'kernels'}) launches {counts}")
        train_metrics_ok(metrics)
        if (identity_embed is not None) != (float(metrics["g_identity_preserving"]) > 0):
            raise AssertionError(f"f32 step: identity term {float(metrics['g_identity_preserving'])}")
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
    what = "identity: train f32 check with the identity term" if identity_embed else "train f32 check"
    log(f"{what}: batch {TRAIN_F32_BATCH}, kernels vs plain versions: metrics max|diff| "
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
    launches in both runs (each capture's warm-up steps and each sample's
    forward: the graph's replays run no wrapper) and the logged
    ``imgs_per_sec`` of both runs."""
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
    return total, rates


def run_multi_step_f32(dev, identity_embed=None):
    """Phase 11: K=3 graph replays of the f32 step against 3 eager steps
    from the same seeded state, batches and generator seed, the eager
    step's optimizers made capturable as the capture makes the graph's.
    Phase 15 (d) runs it with the identity term on (``identity_embed``)."""
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
    make_gan_train_step(cfg, *warm[1:], identity_embed)(
        warm[0], batches[0], torch.Generator(device=dev).manual_seed(1))
    del warm
    runs = []
    for graphed in (False, True):
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, identity_embed)
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
    if (identity_embed is not None) != bool((m_g["g_identity_preserving"] > 0).all()):
        raise AssertionError(f"multi-step f32: identity term {m_g['g_identity_preserving']}")
    what = "identity: multi-step f32 with the identity term" if identity_embed else "multi-step f32"
    log(f"{what}: batch {TRAIN_F32_BATCH}, {MULTI_K} graph replays against {MULTI_K} "
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
    replayed step while the wrappers launch nothing. Returns images/s
    per batch size."""
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
    rates = {}
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
        rates[batch] = batch / dt
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
    return rates


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


def checksum(t):
    """A position-weighted int64 sum of a tensor's values, exact on the
    card and on the host: equal for equal bytes in equal places."""
    import torch

    v = t.reshape(-1).to(torch.int64)
    w = (torch.arange(v.numel(), device=v.device, dtype=torch.int64) * 40503 + 1) % 65521
    return (v * w).sum()


def host_sums(batch):
    """{key: checksum} of a host batch (numpy arrays or CPU tensors)."""
    import torch

    return {k: int(checksum(torch.as_tensor(v))) for k, v in sorted(batch.items())}


def repeat_pack(src, dst, times):
    """The pack at ``src`` with its items ``times`` over, as one shard."""
    import numpy as np

    from tpgan_tpu_torch.data.packing import INDEX_NAME, shard_path

    with open(os.path.join(src, INDEX_NAME)) as f:
        meta = json.load(f)
    os.makedirs(dst)
    size = 0
    for key in meta["keys"]:
        one = np.concatenate([np.load(shard_path(src, s, key)) for s in range(len(meta["shards"]))])
        whole = np.concatenate([one] * times)
        np.save(shard_path(dst, 0, key), whole)
        size += whole.nbytes
    n = meta["num_items"] * times
    with open(os.path.join(dst, INDEX_NAME), "w") as f:
        json.dump({**meta, "num_items": n, "shards": [n], "names": meta["names"] * times}, f)
    return size


def htod_copies(fn, dev):
    """(host-to-device copies in bytes, in device order; device events) in
    a profiler trace of ``fn()``, read from the exported trace's
    ``gpu_memcpy`` and ``kernel`` events; a 1-byte copy runs first and is
    left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.ones(1, dtype=torch.uint8).to(dev)
        torch.cuda.synchronize()
        time.sleep(0.1)
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        prof.export_chrome_trace(os.path.join(d, "trace.json"))
        with open(os.path.join(d, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    copies = sorted((e["ts"], int(e.get("args", {}).get("bytes", -1))) for e in events
                    if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", ""))
    device = sum(e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") for e in events)
    return [b for _, b in copies if b != 1], device


def f32_step_batches(ds):
    """Phase 14 (d)'s batch: the pack's first TRAIN_F32_BATCH items as
    uint8, and decoded on the host as the step decodes them."""
    import numpy as np

    items = [ds[i] for i in range(TRAIN_F32_BATCH)]
    u8 = {k: np.stack([it[k] for it in items]) for k in items[0]}
    decoded = {k: (2.0 * v.astype(np.float32) - 255.0) / 255.0 if v.dtype == np.uint8 else v
               for k, v in u8.items()}
    return u8, decoded


def htod_traces(pack, device="cuda"):
    """Run in a fresh process by phase 14 (d) (``python3 -c "import
    chip_smoke; chip_smoke.htod_traces(pack)"``): an eager f32 step at
    batch TRAIN_F32_BATCH on the pack's first items, uint8 and decoded on
    the host, each profiled in HTOD_TRACES sessions of one step, after an
    unprofiled step. Prints, as its last line, {mode: {"handed": bytes of
    each leaf the step moved, "traces": [[copy bytes], ...], "device":
    [device events per trace]}}. In the smoke's own process, after its
    earlier profiles, a trace showed no copy at all; in a fresh one a
    trace has missed the first copy of a step, never shown one that was
    not made."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.packing import PackedDataset
    from tpgan_tpu_torch.train import gan_trainer

    dev = torch.device(device)
    ds = PackedDataset(pack, to_float=False)
    u8, decoded = f32_step_batches(ds)
    cfg = make_config({"compute_dtype": "float32"})
    state, gen, disc, g_opt, d_opt = gan_trainer.create_gan_state(cfg, seed=0, device=dev)
    step = gan_trainer.make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
    box = [step(state, u8, torch.Generator(device=dev).manual_seed(0))[0]]  # unprofiled
    handed = []
    real = gan_trainer._to_device

    def spy(x, device):
        handed.append(np.asarray(x).nbytes)
        return real(x, device)

    out = {}
    for mode, batch in (("uint8", u8), ("decoded", decoded)):
        def one():
            box[0], _ = step(box[0], batch, torch.Generator(device=dev).manual_seed(1))

        traces, device = [], []
        with mock.patch.object(gan_trainer, "_to_device", spy):
            for _ in range(HTOD_TRACES):
                handed.clear()
                copies, events = htod_copies(one, dev)
                traces.append(copies)
                device.append(events)
        out[mode] = {"handed": list(handed), "traces": traces, "device": device}
    print(json.dumps(out))


def run_data_loop(dev, cfg, feed, log_dir):
    """Phase 14's loop: ``run_gan_training`` over ``feed`` for 8 steps, K =
    LOOP_K per dispatch (the CUDA graph). Returns the checksums of every
    batch the step received (taken on the card, in the step's stream),
    the logged ``imgs_per_sec``, the wrapper launches and the wall time."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train import loop as loop_module
    from tpgan_tpu_torch.train.gan_trainer import GRAPH_WARMUP_CALLS
    from tpgan_tpu_torch.train.loop import run_gan_training
    from tpgan_tpu_torch.train.metrics import MetricWriter

    received = []
    real = loop_module.make_multi_step

    def spy(step, k):
        multi = real(step, k)

        def spied(state, super_batch, generator):
            received.append({key: torch.stack([checksum(v[i]) for i in range(k)])
                             for key, v in sorted(super_batch.items())})
            return multi(state, super_batch, generator)

        return spied

    writer = MetricWriter(log_dir, use_tensorboard=False)
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(loop_module, "make_multi_step", spy):
        state = run_gan_training(cfg, feed, steps=LOOP_STEPS, writer=writer, log_every=LOOP_EVERY,
                                 steps_per_dispatch=LOOP_K, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    writer.close()
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    bad = [(r["step"], k) for r in rows for k, v in r.items() if not np.isfinite(v)]
    if state.step != LOOP_STEPS or [r["step"] for r in rows] != [LOOP_EVERY, LOOP_STEPS] or bad:
        raise AssertionError(f"data loop: step {state.step}, metrics at {[r['step'] for r in rows]}, "
                             f"non-finite {bad}")
    want = {k: v * GRAPH_WARMUP_CALLS for k, v in PER_STEP.items()}
    if launches != want:
        raise AssertionError(f"data loop: launches {launches}, expected {want} (the warm-up steps "
                             "before the capture)")
    sums = [{k: int(v[i]) for k, v in r.items()} for r in received for i in range(LOOP_K)]
    return sums, [r["imgs_per_sec"] for r in rows], launches, wall


def run_uint8_step(dev, tag, ds, pack):
    """Phase 14 (d): one eager f32 step on a uint8 numpy batch equals the
    step on the same batch decoded on the host beforehand, bit for bit
    (TF32 off, deterministic cuDNN); then the
    host-to-device copies of each in profiler traces taken in a fresh
    process (:func:`htod_traces`): the uint8 batch's bytes, against four
    times its image bytes for the decoded one. Every trace's copies are
    among those the step made; at least one trace of each holds them
    all."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

    cfg = make_config({"compute_dtype": "float32"})
    u8, decoded = f32_step_batches(ds)
    _f32_exact(True)
    out = {}
    # no warm-up step: phases 7 and 11 took this process's first f32 steps,
    # whose last bits differ from later ones (ROADMAP C2)
    for name, batch in (("uint8", u8), ("decoded", decoded)):
        gc.collect()
        torch.cuda.empty_cache()
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
        state, metrics = step(state, batch, torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     {**{"g." + k: v.clone() for k, v in state.gen.state_dict().items()},
                      **{"d." + k: v.clone() for k, v in state.disc.state_dict().items()},
                      **{"ema." + k: v.clone() for k, v in state.g_ema_params.items()}})
        del state, gen, disc, g_opt, d_opt, step
    _f32_exact(False)
    (m8, s8), (mf, sf) = out["uint8"], out["decoded"]
    differ = sum(int((s8[k] != sf[k]).sum()) for k in s8)
    total = sum(v.numel() for v in s8.values())
    if m8 != mf or differ:
        raise AssertionError(f"uint8 step: {differ} of {total} state elements and metrics "
                             f"{[k for k in m8 if m8[k] != mf.get(k)]} differ from the decoded step")
    del out, s8, sf
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke; chip_smoke.htod_traces({pack!r})"],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the traced steps' process exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    traced = json.loads(proc.stdout.strip().splitlines()[-1])
    want = {"uint8": sum(v.nbytes for v in u8.values()),
            "decoded": sum(v.nbytes for v in decoded.values())}
    lines = []
    for mode, r in traced.items():
        handed = r["handed"]
        extra = [dict(collections.Counter(c) - collections.Counter(handed)) for c in r["traces"]]
        complete = [c for c in r["traces"] if sorted(c) == sorted(handed)]
        if sum(handed) != want[mode] or any(extra) or not complete:
            raise AssertionError(f"{mode} step: moved {handed} ({sum(handed)} B, the batch is "
                                 f"{want[mode]} B); traces {r['traces']} (beyond the moved "
                                 f"copies: {extra})")
        lines.append(f"{mode}: moves {len(handed)} leaves, {sum(handed)} B; the traces hold "
                     f"{[len(c) for c in r['traces']]} copies ({len(complete)} of "
                     f"{len(r['traces'])} complete: {sum(complete[0])} B), device events "
                     f"{r['device']}")
    log(f"data (d): f32 step batch {TRAIN_F32_BATCH} on a uint8 batch against the host-decoded "
        f"batch: 0 of {total} state elements and 0 of {len(m8)} metrics differ. Host-to-device "
        f"copies per step, traced in a fresh process ({time.perf_counter() - t0:.1f} s): "
        f"{'; '.join(lines)}; the uint8 batch is {want['uint8']} B {tag}")


def run_data(dev, tag, graphed_rates, loop_rates):
    """Phase 14: the data path at full size, bf16. (a) the procedural
    Multi-PIE protocol rendered and written by the port; (b) the loop fed
    from packed shards through worker processes, pinned memory and
    ``prefetch_to_device``; (c) the loop fed from a 0.42 GB pack held in
    device memory, yaw-weighted; every batch the step received against its
    host copy, by checksum; (d) the uint8 step against the decoded one;
    (e) ``bench_loader``'s four paths at batch 16 and 64 beside the
    graphed step (phase 11) and the loop rates beside phase 10's."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data import bench_loader
    from tpgan_tpu_torch.data.multipie import TrainDataset, camera_token
    from tpgan_tpu_torch.data.packing import (
        PackedDataset,
        device_batch_iterator,
        load_packed_to_device,
        pack_dataset,
        shard_path,
    )
    from tpgan_tpu_torch.data.pipeline import batch_iterator, prefetch_to_device
    from tpgan_tpu_torch.data.synthetic_faces import ALL_CAMERA_YAWS, generate_gan_protocol

    cfg = make_config({"compute_dtype": "bfloat16", "train": {"batch_size": TRAIN_BATCH}})
    seed = cfg.train.seed
    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        # (a) files
        t0 = time.perf_counter()
        img_list = generate_gan_protocol(os.path.join(root, "mp"), DATA_SUBJECTS)
        t_files = time.perf_counter() - t0
        pack = os.path.join(root, "packed")
        t0 = time.perf_counter()
        pack_dataset(TrainDataset(img_list), pack)
        t_pack = time.perf_counter() - t0
        ds = PackedDataset(pack, to_float=False)
        if len(img_list) != DATA_SUBJECTS * 8 or len(ds) != len(img_list):
            raise AssertionError(f"data: {len(img_list)} training items, {len(ds)} packed")
        log(f"data (a): {DATA_SUBJECTS} subjects x 9 cameras rendered, prepared (Lanczos "
            f"pyramids, patches) and written as PNGs in {t_files:.1f} s: {len(img_list)} training "
            f"items; packed in {t_pack:.1f} s")

        # (b) shards -> worker processes -> pinned memory -> prefetch
        inner = batch_iterator(ds, TRAIN_BATCH, seed=seed, num_workers=DATA_WORKERS,
                               pin_memory=True)
        feed = prefetch_to_device(inner, size=2, device=dev)
        got, rates_b, launches_b, wall_b = run_data_loop(dev, cfg, feed, os.path.join(root, "b"))
        feed.close()
        inner.close()
        host = [host_sums(b) for b in itertools.islice(
            batch_iterator(ds, TRAIN_BATCH, seed=seed, num_workers=0), LOOP_STEPS)]
        if got != host:
            bad = [i for i, (g, h) in enumerate(zip(got, host)) if g != h]
            raise AssertionError(f"data (b): batches {bad} of {len(host)} that the step received "
                                 f"differ from their host copies ({len(got)} received)")
        log(f"data (b): run_gan_training full size bf16 batch {TRAIN_BATCH}, {LOOP_K} steps per "
            f"dispatch (CUDA graph), fed by PackedDataset(uint8) -> batch_iterator("
            f"{DATA_WORKERS} workers, pinned) -> prefetch_to_device(2): {LOOP_STEPS} steps in "
            f"{wall_b:.1f} s, metrics finite, all {len(got)} batches the step received equal "
            f"their host copies (checksums over {len(got[0])} keys each); imgs_per_sec per logged "
            f"window {[round(r, 1) for r in rates_b]} {tag}")

        # (c) the whole pack in device memory, yaw-weighted sampling
        big = os.path.join(root, "packed_x40")
        size = repeat_pack(pack, big, DATA_REPEAT)
        names = PackedDataset(big).names
        yaws = np.asarray([abs(ALL_CAMERA_YAWS.get(camera_token(n), 0.0)) for n in names])
        weights = 1.0 + (yaws / 90.0) ** 2  # train.yaw_weight_gamma = 1
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        data = load_packed_to_device(big, dev)
        torch.cuda.synchronize()
        t_load, after = time.perf_counter() - t0, torch.cuda.memory_allocated()
        got_c, rates_c, launches_c, wall_c = run_data_loop(
            dev, cfg, device_batch_iterator(data, TRAIN_BATCH, seed=seed, weights=weights),
            os.path.join(root, "c"))
        arrays = {k: np.load(shard_path(big, 0, k), mmap_mode="r") for k in data}
        rng, p = np.random.RandomState(seed), weights / weights.sum()
        host_c = []
        for _ in range(LOOP_STEPS):
            idx = rng.choice(len(names), size=(TRAIN_BATCH,), p=p)
            host_c.append(host_sums({k: np.ascontiguousarray(a[idx]) for k, a in arrays.items()}))
        if got_c != host_c:
            bad = [i for i, (g, h) in enumerate(zip(got_c, host_c)) if g != h]
            raise AssertionError(f"data (c): gathered batches {bad} differ from a host gather of "
                                 f"the same indices ({len(got_c)} received)")
        del data, arrays
        torch.cuda.empty_cache()
        log(f"data (c): {len(names)} items ({size / 1e9:.3f} GB uint8) loaded to the card in "
            f"{t_load:.2f} s: allocated {before / 2**30:.2f} -> {after / 2**30:.2f} GiB; "
            f"run_gan_training from device_batch_iterator (yaw weights 1 + (|yaw|/90)^2, "
            f"{weights.min():.2f}-{weights.max():.2f}): {LOOP_STEPS} steps in {wall_c:.1f} s, "
            f"metrics finite, all {len(got_c)} gathered batches equal a host gather of the same "
            f"indices; imgs_per_sec per logged window {[round(r, 1) for r in rates_c]} {tag}")
        log(f"data: wrapper launches {launches_b} in (b) and {launches_c} in (c), each the "
            f"{PER_STEP} per step of the warm-up steps before its capture")

        # (d) the uint8 transfer
        run_uint8_step(dev, tag, ds, pack)

        # (e) loader rates against the step's
        t0 = time.perf_counter()
        for batch in (TRAIN_BATCH, 64):
            rows = bench_loader.run(os.path.join(root, "mp", "img.list"), pack, batch,
                                    batches=LOADER_BATCHES, num_workers=LOADER_WORKERS, device=dev)
            for r in rows:
                log(json.dumps(r))
            rates = ", ".join(f"{r['path']} {r['imgs_per_sec']:.1f}" for r in rows)
            log(f"data (e): loader images/s at batch {batch}: {rates}; the graphed step eats "
                f"{graphed_rates[batch]:.1f} (phase 11) {tag}")
        log(f"data (e): {time.perf_counter() - t0:.1f} s for the loader rates; the loop's "
            f"imgs_per_sec per window: shards {[round(r, 1) for r in rates_b]}, device "
            f"{[round(r, 1) for r in rates_c]}, synthetic batches (phase 10) {loop_rates}")
    log(f"data: phase 14 took {time.perf_counter() - start:.1f} s")


class _Collect:
    """A metric writer that keeps what it is given."""

    def __init__(self):
        self.lines = []

    def write(self, step, metrics):
        self.lines.append((step, {k: float(v) for k, v in metrics.items()}))


def check_embedders(dev, tag):
    """Phase 15 (a): each embedder's forward on the card against the same
    seeded weights' f32 forward on the CPU; the forward's images/s at
    batch ``EMBEDDER_BATCH`` in f32 and bf16."""
    import copy

    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.models.feature_extract import build_feature_extract_model, cast_embedder

    x = torch.from_numpy(np.random.RandomState(0).uniform(
        -1, 1, (EMBEDDER_CHECK_BATCH, 3, 128, 128)).astype(np.float32))
    lines = []
    for base in ("resnet", "mobilenetv2"):
        cfg = make_config({"feature_extract_model": {"base_model_name": base}})
        model = build_feature_extract_model(cfg, dev, seed=0).eval()
        cpu = build_feature_extract_model(cfg, "cpu", seed=0).eval()
        cpu.load_state_dict(model.state_dict())
        forms = [("f32", model)]
        if base == "resnet":
            forms.append(("bf16", cast_embedder(copy.deepcopy(model), torch.bfloat16)))
        with torch.no_grad():
            want = [t.float() for t in cpu(x)]
            _f32_exact(True)
            got = {name: [t.float().cpu() for t in m(x.to(dev))] for name, m in forms}
            _f32_exact(False)
        for name, outs in got.items():
            errs = [float((g - w).abs().max() / w.abs().max()) for g, w in zip(outs, want)]
            bound = EMBEDDER_F32_TOL if name == "f32" else BF16_REL_DIFF
            if not max(errs) <= bound or not all(torch.isfinite(g).all() for g in outs):
                raise AssertionError(f"embedder {base} {name} on the card vs f32 on the CPU: "
                                     f"(logits, features) max|diff| {errs} of max, bound {bound}")
            line = (f"{base} {name} (logits, features {tuple(outs[1].shape)}) max|card - cpu| "
                    f"{errs[0]:.2e}, {errs[1]:.2e} of max (bound {bound})")
            if base == "resnet":
                m = dict(forms)[name]
                xb = torch.randn(EMBEDDER_BATCH, 3, 128, 128, device=dev).to(
                    torch.bfloat16 if name == "bf16" else torch.float32)
                with torch.no_grad():
                    for _ in range(3):
                        m(xb)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(10):
                        m(xb)
                    torch.cuda.synchronize()
                line += (f", forward {EMBEDDER_BATCH * 10 / (time.perf_counter() - t0):.1f} "
                         f"images/s at batch {EMBEDDER_BATCH}")
            lines.append(line)
        del model, cpu, forms
    log(f"identity (a): {'; '.join(lines)} (f32 timed with cuDNN's default TF32) {tag}")


def train_embedder(dev, tag, root):
    """Phase 15 (b): ``run_feature_extract_training`` on the rendered
    protocol with whole subjects held out. Returns (checkpoint directory,
    the GAN training list)."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.multipie import IdentityImageDataset, frontal_twin_path
    from tpgan_tpu_torch.data.synthetic_faces import generate_gan_protocol
    from tpgan_tpu_torch.models.feature_extract import build_feature_extract_model
    from tpgan_tpu_torch.train.checkpoint import restore_model_variables
    from tpgan_tpu_torch.train.feature_extract import (
        held_out_subject_split,
        load_val_data,
        run_feature_extract_training,
    )

    t0 = time.perf_counter()
    img_list = generate_gan_protocol(os.path.join(root, "mp"), IDENTITY_SUBJECTS)
    every_view = img_list + sorted({frontal_twin_path(p) for p in img_list})
    train, split = held_out_subject_split(every_view, IDENTITY_HELD_OUT)
    val = load_val_data(split)
    ds = IdentityImageDataset(train)
    items = [ds[i] for i in range(len(ds))]
    images = np.stack([im for im, _ in items])
    labels = np.stack([lbl for _, lbl in items])
    t_data = time.perf_counter() - t0

    def batches():
        rng = np.random.RandomState(0)
        while True:
            idx = rng.choice(len(images), EMBEDDER_BATCH, replace=False)
            yield images[idx], labels[idx]

    cfg = make_config()
    writer, ck = _Collect(), os.path.join(root, "embedder")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = run_feature_extract_training(cfg, batches(), steps=EMBEDDER_STEPS, writer=writer,
                                         checkpoint_dir=ck, val_data=val, val_every=10**9,
                                         device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(s, m) for s, m in writer.lines if not all(np.isfinite(v) for v in m.values())]
    fresh = build_feature_extract_model(cfg, dev, seed=0)
    moved = sum(not torch.equal(a, b) for a, b in zip(fresh.parameters(), state.model.parameters()))
    restore_model_variables(ck, fresh)
    reloaded = all(torch.equal(v, state.model.state_dict()[k]) for k, v in fresh.state_dict().items())
    if bad or not moved or not reloaded or state.step != EMBEDDER_STEPS:
        raise AssertionError(f"embedder training: non-finite {bad}; {moved} parameters moved; "
                             f"checkpoint reloads equal: {reloaded}; step {state.step}")
    curve = [(s, round(m["loss"], 4), m["accuracy"]) for s, m in writer.lines if "loss" in m]
    val_metrics = writer.lines[-1][1]
    log(f"identity (b): {IDENTITY_SUBJECTS} subjects x 9 cameras rendered in {t_data:.1f} s; "
        f"{len(train)} training images of {IDENTITY_SUBJECTS - IDENTITY_HELD_OUT} subjects, "
        f"{IDENTITY_HELD_OUT} held out ({len(split['probe_paths'])} probes, "
        f"{len(split['gallery_paths'])} gallery); run_feature_extract_training full-width "
        f"ResNet18, {cfg.pretrain.optimizer} lr {cfg.optimizer_param.learning_rate}, batch "
        f"{EMBEDDER_BATCH}, {EMBEDDER_STEPS} augmented steps in {wall:.2f} s; (step, loss, "
        f"accuracy) {curve}; val_rank1 {val_metrics['val_rank1']:.4f}, val_identity_sim "
        f"{val_metrics['val_identity_sim']:.4f}; {moved} parameter tensors moved; the "
        f"checkpoint reloads bit for bit {tag}")
    return ck, img_list


def identity_steps(dev, tag, embed, embedder, train_rates, graphed_rates, gan_ck):
    """Phase 15 (c): the full-size bf16 step with the identity term, eager
    and as graph replays at batch 16 and 64; the embedder's share of the
    batch-16 step's device busy time; the batch-16 eager state saved to
    ``gan_ck``. Returns the wrapper launches of the eager steps."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train.checkpoint import save_checkpoint
    from tpgan_tpu_torch.train.gan_trainer import (
        create_gan_state,
        make_gan_train_step,
        make_multi_step,
    )

    before = {k: v.clone() for k, v in embedder.state_dict().items()}
    cfg = make_config({"compute_dtype": "bfloat16"})
    launches = collections.Counter()
    lines = []
    for batch, steps in IDENTITY_STEPS:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, identity_embed=embed)
        b = synthetic_gan_batch(batch, seed=0, num_classes=cfg.G.num_classes)
        generator = torch.Generator(device=dev).manual_seed(0)
        for _ in range(3):
            state, _m = step(state, b, generator)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        history = []
        for _ in range(steps):
            state, metrics = step(state, b, generator)
            history.append(metrics)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        counts = kernels.launch_counts()
        launches.update(counts)
        for m in history:
            train_metrics_ok(m)
            if not float(m["g_identity_preserving"]) > 0:
                raise AssertionError(f"identity step: the term is {float(m['g_identity_preserving'])}")
        if counts != {k: v * steps for k, v in PER_STEP.items()}:
            raise AssertionError(f"identity step batch {batch}: launches {counts} over {steps} steps")
        peak = torch.cuda.max_memory_allocated() / 2**30
        line = (f"eager batch {batch}: {dt * 1e3:.2f} ms/step = {batch / dt:.1f} images/s, peak "
                f"{peak:.2f} GiB (phase 8 without the term: {train_rates[batch][0]:.1f} images/s, "
                f"{train_rates[batch][1]:.2f} GiB), g_identity_preserving "
                f"{float(history[-1]['g_identity_preserving']):.4f}")
        if batch == TRAIN_BATCH:
            plain = make_gan_train_step(cfg, gen, disc, g_opt, d_opt)
            box = [state]

            def with_term():
                box[0], _ = step(box[0], b, generator)

            def without():
                box[0], _ = plain(box[0], b, generator)

            without()  # its first use
            busy = {}
            for name, fn in (("with", with_term), ("without", without)):
                stats = profile(fn, 2, f"eager train step bf16 batch {batch}, {name} the identity "
                                "term", "step", tag, {})
                busy[name] = None if stats is None else stats["busy_ms"]
            if None in busy.values():
                line += "; the embedder's share of busy time not measured (no device time traced)"
            else:
                share = (busy["with"] - busy["without"]) / busy["with"]
                line += (f"; device busy {busy['with']:.2f} ms/step with the term, "
                         f"{busy['without']:.2f} without: the embedder's share {share:.1%}")
            save_checkpoint(gan_ck, box[0].step, box[0])
            del box, plain
        lines.append(line)
        del state, gen, disc, g_opt, d_opt, step, history, metrics, _m

        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        multi = make_multi_step(make_gan_train_step(cfg, gen, disc, g_opt, d_opt, embed), LOOP_K)
        super_batch = {k: np.stack([v] * LOOP_K) for k, v in b.items()}
        state, metrics = multi(state, super_batch, generator)  # the capture
        if multi.launches() != PER_STEP:
            raise AssertionError(f"graphed identity step: per replay {multi.launches()}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            state, metrics = multi(state, super_batch, generator)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / (2 * LOOP_K)
        if not all(torch.isfinite(v.float()).all() for v in metrics.values()) or \
                not bool((metrics["g_identity_preserving"] > 0).all()):
            raise AssertionError(f"graphed identity step batch {batch}: metrics {metrics}")
        peak = torch.cuda.max_memory_allocated() / 2**30
        lines.append(f"graphed batch {batch}: {dt * 1e3:.2f} ms/step = {batch / dt:.1f} images/s "
                     f"({LOOP_K} replays per dispatch; phase 11 without the term: "
                     f"{graphed_rates[batch]:.1f}), peak {peak:.2f} GiB, the capture's record "
                     f"{multi.launches()} per replay")
        del state, gen, disc, g_opt, d_opt, multi, metrics
    grads = [n for n, p in embedder.named_parameters() if p.grad is not None or p.requires_grad]
    moved = [k for k, v in embedder.state_dict().items() if not torch.equal(v, before[k])]
    if grads or moved:
        raise AssertionError(f"the frozen embedder took gradients {grads[:4]} or moved {moved[:4]}")
    log(f"identity (c): full-size bf16 step with the identity term through the trained f32 "
        f"ResNet18: {'; '.join(lines)}; no embedder parameter has a .grad or moved, no "
        f"BatchNorm statistic moved {tag}")
    return launches


def eval_protocol(dev, tag, gan_ck, embed, img_list):
    """Phase 15 (e): ``evaluate_protocol`` on the rendered protocol with G
    from the step's checkpoint, graphed and eager. Returns the wrapper
    launches of both runs."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.multipie import TrainDataset
    from tpgan_tpu_torch.data.pipeline import batch_iterator
    from tpgan_tpu_torch.evaluate import evaluate_protocol
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train.checkpoint import restore_gan_checkpoint
    from tpgan_tpu_torch.train.gan_trainer import (
        GRAPH_WARMUP_CALLS,
        create_gan_state,
        eval_g_params,
        make_graphed_synthesize_fn,
        make_synthesize_fn,
    )

    cfg = make_config({"compute_dtype": "bfloat16"})
    state = restore_gan_checkpoint(gan_ck, create_gan_state(cfg, seed=1, device=dev)[0])
    weights = eval_g_params(state)  # the EMA weights, as cmd_eval's "auto"
    with torch.no_grad():
        for n, p in state.gen.named_parameters():
            p.copy_(weights[n])
    batches = list(batch_iterator(TrainDataset(img_list), EVAL_BATCH, shuffle=False, epochs=1,
                                  drop_last=False, num_workers=0))
    results, launches, lines = {}, collections.Counter(), []
    n_items = len(img_list) * EVAL_Z

    def one_pass(synthesize):
        return evaluate_protocol(
            synthesize, batches, img_list, cfg.G.zdim, embed=embed, z_samples=EVAL_Z,
            generator=torch.Generator(device=dev).manual_seed(0))

    for form, make in (("graphed", make_graphed_synthesize_fn), ("eager", make_synthesize_fn)):
        synthesize = make(cfg, state.gen)
        kernels.reset_launch_counts()
        # the first call alone: the graph's warm-up forwards, capture and one replay
        # (graphed), or one forward (eager), timed apart from the passes below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        synthesize(batches[0], torch.zeros((len(batches[0]["img"]), cfg.G.zdim), device=dev))
        torch.cuda.synchronize()
        first_call = time.perf_counter() - t0
        results[form] = one_pass(synthesize)
        counts = kernels.launch_counts()
        launches.update(counts)
        forwards = len(batches) * EVAL_Z + 1
        # eager: 3 fuses per forward; graphed: the capture's warm-up forwards only
        want = 3 * (forwards if form == "eager" else GRAPH_WARMUP_CALLS)
        if counts["fuse_parts"] != want or sum(counts.values()) != want:
            raise AssertionError(f"protocol {form}: launches {counts}, expected {want} fuses")
        # the rate: whole passes after the checked one, each timed on its own
        walls = []
        for _ in range(EVAL_TIMED_PASSES):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again = one_pass(synthesize)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            if again != results[form]:
                raise AssertionError(f"protocol {form}: a repeated pass differs: {again}")
        rates = sorted(n_items / w for w in walls)
        lines.append(
            f"{form} {rates[0]:.1f}-{rates[-1]:.1f} images/s over {EVAL_TIMED_PASSES} passes "
            f"after the first (each {len(img_list)} items x {EVAL_Z} draws, "
            f"{min(walls):.3f}-{max(walls):.3f} s, embedding and scoring included); first call "
            f"{first_call:.3f} s ({'warm-up, capture, replay' if form == 'graphed' else 'one forward'}"
            f"); launches {dict(counts)}")
        del synthesize
    # how far the noise moves the first batch's fakes (psnr_z_std reads it)
    synthesize = make_synthesize_fn(cfg, state.gen)
    z = torch.randn((2, len(batches[0]["img"]), cfg.G.zdim), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    z_moves = float((synthesize(batches[0], z[0]).float()
                     - synthesize(batches[0], z[1]).float()).abs().max())
    lines.append(f"max|fake(z1) - fake(z2)| on the first batch {z_moves:.3e}")
    del synthesize
    out = results["eager"]
    cams = set(out.get("per_camera", {}))
    ok = (np.isfinite(out["psnr"]) and -1 <= out["ssim"] <= 1 and 0 <= out["rank1"] <= 1
          and -1 <= out["identity_sim"] <= 1 and cams == PROFILE_CAMERAS
          and out["num_images"] == len(img_list) and out["z_samples"] == EVAL_Z)
    if not ok or results["graphed"] != out:
        raise AssertionError(f"protocol: eager {out}; graphed {results['graphed']}")
    summary = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in out.items()
               if k != "per_camera"}
    log(f"identity (e): evaluate_protocol, G from the step's checkpoint (EMA), bf16, batch "
        f"{EVAL_BATCH}: {summary}; per camera (psnr, ssim, rank1) "
        f"{ {c: (round(r['psnr'], 2), round(r['ssim'], 3), r['rank1']) for c, r in sorted(out['per_camera'].items())} }; "
        f"graphed == eager; {'; '.join(lines)} {tag}")
    return launches


def run_identity_eval(dev, tag, train_rates, graphed_rates):
    """Phase 15: the identity embedder and the evaluation, (a)-(e)."""
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.models.feature_extract import (
        build_feature_extract_model,
        make_identity_embed_fn,
    )
    from tpgan_tpu_torch.train.checkpoint import restore_model_variables

    start = time.perf_counter()
    check_embedders(dev, tag)
    with tempfile.TemporaryDirectory() as root:
        ck, img_list = train_embedder(dev, tag, root)
        embedder = build_feature_extract_model(make_config(), dev, seed=1)
        restore_model_variables(ck, embedder)
        embed = make_identity_embed_fn(embedder)
        gan_ck = os.path.join(root, "gan")
        step_launches = identity_steps(dev, tag, embed, embedder, train_rates, graphed_rates,
                                       gan_ck)
        torch.cuda.empty_cache()
        run_train_f32(dev, embed)
        run_multi_step_f32(dev, embed)
        eval_launches = eval_protocol(dev, tag, gan_ck, embed, img_list)
    log(f"identity: wrapper launches {dict(step_launches)} in (c)'s timed eager steps (7 / 2 / 1 "
        f"/ 1 per step) and {dict(eval_launches)} in (e) (3 per eager forward and per graph "
        f"warm-up forward); phase 15 took {time.perf_counter() - start:.1f} s")


def detector_corpus(root, tag):
    """Phase 16 (1): the CelebA-layout corpus rendered and written by the
    port's ``generate_pretrain_protocol`` (JPEGs from its encoder); 16
    files decoded by the host library and by the plain Python reference,
    equal; the encoder's and the host decoder's images/s on one thread."""
    import numpy as np

    from tpgan_tpu_torch.data import celeba, imageio, native
    from tpgan_tpu_torch.data.synthetic_faces import generate_pretrain_protocol, render_face

    t0 = time.perf_counter()
    txt = generate_pretrain_protocol(root, DETECTOR_IMAGES)
    render_write_s = time.perf_counter() - t0
    paths = celeba.find_images(root)
    if len(paths) != DETECTOR_IMAGES:
        raise AssertionError(f"corpus: {len(paths)} files, expected {DETECTOR_IMAGES}")
    rng = np.random.RandomState(7)
    faces = [render_face(int(rng.randint(0, 512)), float(rng.uniform(-60, 60)),
                         int(rng.randint(160, 321)))[0] for _ in range(DETECTOR_ENCODE_TIMED)]
    t0 = time.perf_counter()
    for i, face in enumerate(faces):
        imageio.write_jpeg(os.path.join(root, f"timed_{i}.jpeg"), face, quality=92)
    encode_rate = len(faces) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    decoded = [imageio.read_rgb(p) for p in paths]
    decode_rate = len(paths) / (time.perf_counter() - t0)
    t0 = time.perf_counter()
    for p, img in zip(paths[:DETECTOR_DECODE_CHECK], decoded):
        ref = imageio.read_jpeg(p, entropy=native.jpeg_huff_decode_reference)
        if not np.array_equal(ref, img):
            raise AssertionError(f"corpus: the host decoder and the reference differ on {p}")
    ref_s = (time.perf_counter() - t0) / DETECTOR_DECODE_CHECK
    sides = [max(d.shape[:2]) for d in decoded]
    log(f"detector (1): {DETECTOR_IMAGES} images ({min(sides)}-{max(sides)} px, quality 92) "
        f"rendered and written in {render_write_s:.1f} s; {DETECTOR_DECODE_CHECK} decoded by "
        f"the host library equal to the Python reference ({ref_s * 1e3:.0f} ms/image); one "
        f"thread: encode {encode_rate:.1f} images/s ({DETECTOR_ENCODE_TIMED} faces of 160-320 "
        f"px, render excluded), decode {decode_rate:.1f} images/s (the {DETECTOR_IMAGES} "
        f"files) {tag}")
    return txt


def detector_offsets(loc, head_mode, size):
    """The anchor head's loc as its offsets from the anchor centres in
    stride units, (loc - centre) / stride: what its convs emit, before the
    decode multiplies their f32 noise by the stride (up to 256 px at the
    1x1 scales). The absolute head's loc as it is."""
    from tpgan_tpu_torch.models.mobilenet_v2 import anchor_centres, anchor_strides

    if head_mode != "anchor_offset":
        return loc
    return (loc - anchor_centres((size, size))) / anchor_strides((size, size))


def check_detector_forward(dev, tag):
    """Phase 16 (2): the detector's forward on the card in both head
    modes, eval and train-mode BatchNorm, against the same seeded
    weights' f32 forward on the CPU (TF32 off, deterministic cuDNN): cls,
    and the absolute head's loc, within DETECTOR_F32_TOL (train mode:
    DETECTOR_F32_TRAIN_TOL) of each output's largest magnitude; the
    anchor head's loc as its offsets in stride units
    (``detector_offsets``)."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.train.pretrain import build_detector

    x = torch.from_numpy(np.random.RandomState(3).uniform(
        0, 1, (DETECTOR_CHECK_BATCH, 3, DETECTOR_SIZE, DETECTOR_SIZE)).astype(np.float32))
    lines, bad = [], []
    for head_mode in ("absolute", "anchor_offset"):
        cfg = make_config({"pretrain": {"head_mode": head_mode}})
        model = build_detector(cfg, dev, seed=4)
        cpu = build_detector(cfg, "cpu", seed=4)
        cpu.load_state_dict(model.state_dict())
        for train in (False, True):
            model.train(train)
            cpu.train(train)
            with torch.no_grad():
                want = cpu(x)
                _f32_exact(True)
                got = [t.cpu() for t in model(x.to(dev))]
                _f32_exact(False)
            pairs = [(detector_offsets(got[0], head_mode, DETECTOR_SIZE),
                      detector_offsets(want[0], head_mode, DETECTOR_SIZE)), (got[1], want[1])]
            errs = [float((g - w).abs().max() / w.abs().max()) for g, w in pairs]
            raw_loc = float((got[0] - want[0]).abs().max() / want[0].abs().max())
            what = f"{head_mode} {'train' if train else 'eval'}"
            lines.append(f"{what} {errs[0]:.2e}, {errs[1]:.2e} (loc itself {raw_loc:.2e})")
            bound = DETECTOR_F32_TRAIN_TOL if train else DETECTOR_F32_TOL
            if not max(errs) <= bound or not all(torch.isfinite(g).all() for g in got):
                bad.append(what)
        del model, cpu
    log(f"detector (2): forward at batch {DETECTOR_CHECK_BATCH}, {DETECTOR_SIZE}x"
        f"{DETECTOR_SIZE}, card against CPU, max|diff| of max for (loc, cls), the anchor "
        f"head's loc as offsets in stride units: {'; '.join(lines)} (bound "
        f"{DETECTOR_F32_TOL} eval, {DETECTOR_F32_TRAIN_TOL} train) {tag}")
    if bad:
        raise AssertionError(f"detector forward on the card vs the CPU beyond the bound: {bad}")


def _bn_stats_gap(got, want) -> float:
    """The largest gap of any BatchNorm's running mean or variance, as a
    share of that BatchNorm's largest running variance."""
    gap = 0.0
    for k in want:
        if k.endswith("running_var"):
            base = k[:-len("running_var")]
            scale = float(want[k].abs().max())
            for s in ("running_mean", "running_var"):
                gap = max(gap, float((got[base + s] - want[base + s]).abs().max()) / scale)
    return gap


def check_detector_step(dev, tag, ds):
    """Phase 16 (3): one f32 pretrain step (batch 8, 256x256, uint8 items
    of the corpus, TF32 off, deterministic cuDNN, the same uniforms) on
    the card against the CPU: the assignment equal, the loss within
    1e-5 |ref| + 1e-6, the parameters' movement within
    DETECTOR_MOVE_REL_L2 of the CPU's in relative L2 over all leaves,
    the BatchNorm statistics within DETECTOR_STATS_TOL."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.models.mobilenet_v2 import anchor_centres
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    items = [ds[i] for i in range(DETECTOR_STEP_BATCH)]
    x = np.stack([np.clip(im * 255.0, 0.0, 255.0).astype(np.uint8) for im, _ in items])
    lbl = np.stack([l for _, l in items])
    n = anchor_centres((DETECTOR_SIZE, DETECTOR_SIZE)).shape[0]  # 1,540 anchors at 256
    u = torch.rand((DETECTOR_STEP_BATCH, n), generator=torch.Generator().manual_seed(9))
    runs = []
    for head_mode in ("absolute", "anchor_offset"):
        cfg = make_config({"pretrain": {"head_mode": head_mode}})
        sides = []
        for d in (dev, torch.device("cpu")):
            state, model, opt = create_pretrain_state(cfg, 6, d)
            if sides:
                model.load_state_dict(sides[0][3])
            before = {k: v.detach().to("cpu", copy=True) for k, v in model.state_dict().items()}
            step = make_pretrain_step(cfg, model, opt, state.scheduler)
            _f32_exact(d.type == "cuda")
            state, metrics, aux = step(state, x, lbl, u=u, return_aux=True)
            _f32_exact(False)
            sides.append((metrics, aux, {k: v.detach().cpu() for k, v in
                                         model.state_dict().items()}, before))
        (gm, ga, gsd, g0), (cm, ca, csd, c0) = sides
        leaves = [k for k, _ in create_pretrain_state(cfg, 6, "cpu")[1].named_parameters()]
        move = lambda sd, sd0: torch.cat([(sd[k] - sd0[k]).double().ravel()  # noqa: E731
                                          for k in leaves])
        mg, mc = move(gsd, g0), move(csd, c0)
        move_gap = float((mg - mc).norm() / mc.norm())
        flips = {k: int((ga[k].cpu() != ca[k]).sum()) for k in ("assigned", "keep_bg")}
        loss_gap = abs(float(gm["loss"]) - float(cm["loss"]))
        leaf_gaps = sorted((float((gsd[k] - g0[k] - csd[k] + c0[k]).norm()
                                  / (csd[k] - c0[k]).norm()), k) for k in leaves)
        stats = _bn_stats_gap(gsd, csd)
        log(f"detector (3): f32 step {head_mode}, batch {DETECTOR_STEP_BATCH}: assignment "
            f"differs in {flips} anchors ({int((ca['assigned'] >= 0).sum())} positives, "
            f"{int(ca['keep_bg'].sum())} background kept on the CPU), loss "
            f"{float(gm['loss']):.6f} card vs {float(cm['loss']):.6f} CPU (|diff| "
            f"{loss_gap:.2e}); the parameters' movement {move_gap:.3e} off the CPU's in "
            f"relative L2 over all leaves (bound {DETECTOR_MOVE_REL_L2}; the worst leaf "
            f"{leaf_gaps[-1][1]} {leaf_gaps[-1][0]:.3e}); BatchNorm statistics {stats:.2e} of "
            f"their largest variance (bound {DETECTOR_STATS_TOL}) {tag}")
        if any(flips.values()):
            raise AssertionError(f"detector f32 step {head_mode}: the assignment differs "
                                 f"between the card and the CPU: {flips}")
        if not loss_gap <= 1e-5 * abs(float(cm["loss"])) + 1e-6:
            raise AssertionError(f"detector f32 step {head_mode}: loss {float(gm['loss'])} on "
                                 f"the card, {float(cm['loss'])} on the CPU")
        if move_gap > DETECTOR_MOVE_REL_L2 or stats > DETECTOR_STATS_TOL:
            raise AssertionError(f"detector f32 step {head_mode}: movement {move_gap}, "
                                 f"statistics {stats} off the CPU's")
        runs.append(move_gap)
    return runs


def _pretrain_like_cli(dev, cfg, ck, resume, device_data):
    """``cmd_pretrain`` (``tpgan_tpu/cli.py:86-165``) on the port: the
    dataset and its split, the nose prior from the training labels, the
    host batch iterator (or, ``device_data``, the buckets resident in
    device memory with pixel-budget batches), a metrics writer and
    ``run_pretrain``. Returns (the final state, steps per epoch, the log
    directory)."""
    import numpy as np

    from tpgan_tpu_torch.data.celeba import CelebALandmarkDataset
    from tpgan_tpu_torch.data.packing import (
        device_bucketed_batch_iterator,
        device_bucketed_eval_batches,
        load_pretrain_to_device,
        pixel_budget_batches,
    )
    from tpgan_tpu_torch.data.pipeline import batch_iterator, bucketed_batch_iterator
    from tpgan_tpu_torch.train.metrics import MetricWriter
    from tpgan_tpu_torch.train.pretrain import fit_nose_prior, run_pretrain

    p = cfg.pretrain
    ds = CelebALandmarkDataset(p.txt_name, p.data_root_dir, p.image_size, buckets=p.image_buckets)
    train_idx, val_idx, _ = ds.split(p.train_data_ratio, p.validation_data_ratio)
    steps_per_epoch = max(len(train_idx) // p.batch_size, 1)
    nose_prior = fit_nose_prior(np.stack([
        ds.labels[os.path.basename(ds.image_paths[i])] for i in train_idx]))
    iterators = []
    if device_data:
        train_groups = load_pretrain_to_device(ds, train_idx, dev)
        val_groups = load_pretrain_to_device(ds, val_idx, dev) if val_idx else {}
        batch_for = (pixel_budget_batches({**val_groups, **train_groups}, p.batch_size)
                     if p.image_buckets else None)
        if batch_for:
            steps_per_epoch = max(1, int(sum(int(g["img"].shape[0]) / batch_for[k]
                                             for k, g in train_groups.items())))
        train_it = device_bucketed_batch_iterator(train_groups, p.batch_size,
                                                  seed=cfg.train.seed, batch_for=batch_for)

        def val_batches():
            return device_bucketed_eval_batches(val_groups, p.batch_size, batch_for=batch_for)
    else:
        make_iter = bucketed_batch_iterator if p.image_buckets else batch_iterator
        train_it = make_iter(ds, p.batch_size, shuffle=True, indices=train_idx, epochs=None)
        iterators.append(train_it)

        def val_batches():
            it = make_iter(ds, p.batch_size, shuffle=False, indices=val_idx, epochs=1,
                           drop_last=False)
            iterators.append(it)
            return it
    log_dir = os.path.join(p.log_root_dir, p.model_name)
    writer = MetricWriter(log_dir, use_tensorboard=False)
    try:
        state = run_pretrain(cfg, train_it, val_batches_fn=val_batches if val_idx else None,
                             steps_per_epoch=steps_per_epoch, writer=writer, checkpoint_dir=ck,
                             resume=resume, nose_prior=nose_prior, device=dev)
    finally:
        writer.close()
        for it in iterators:
            it.close()
    return state, steps_per_epoch, log_dir


def run_detector_pretrain(dev, tag, root, txt, name, overrides):
    """Phase 16 (4): ``run_pretrain`` as ``cmd_pretrain`` drives it, 2
    epochs then a resume to 3: metrics finite, the parameters moved, the
    sidecar with the nose prior, per-epoch checkpoints and ``best/``, the
    resume continuing the step count and the schedule, the checkpoint
    reloading bit for bit. Returns the wrapper launches of the two runs."""
    import torch

    from tpgan_tpu_torch.config import flat_override, make_config
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train.checkpoint import latest_step, restore_checkpoint
    from tpgan_tpu_torch.train.pretrain import (
        build_detector,
        create_pretrain_state,
        load_nose_prior,
    )

    run_root = os.path.join(root, name)
    ck = os.path.join(run_root, "ck")
    base = [f"pretrain.data_root_dir={root}", f"pretrain.txt_name={txt}",
            f"pretrain.log_root_dir={os.path.join(run_root, 'logs')}", *DETECTOR_OVERRIDES,
            *overrides]
    cfg = flat_override(make_config(), base)
    device_data = "device" in name
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, spe, log_dir = _pretrain_like_cli(dev, cfg, ck, False, device_data)
    first_s = time.perf_counter() - t0
    first_step = state.step
    init = build_detector(cfg, dev, seed=0)
    moved = sum(int((a != b).sum()) for a, b in zip(state.model.parameters(), init.parameters()))
    if first_step != 2 * spe or latest_step(ck) != first_step or not moved:
        raise AssertionError(f"{name}: {first_step} steps ({spe} per epoch), newest checkpoint "
                             f"{latest_step(ck)}, {moved} parameter elements moved")
    cfg3 = flat_override(cfg, ["pretrain.num_epochs=3"])
    t0 = time.perf_counter()
    resumed, _, _ = _pretrain_like_cli(dev, cfg3, ck, True, device_data)
    resume_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    torch.cuda.synchronize()
    epochs = sorted(int(d) for d in os.listdir(ck) if d.isdigit())
    lr = resumed.optimizer.param_groups[0]["lr"]
    want_lr = cfg.optimizer_param.learning_rate * cfg.pretrain.learning_rate_scheduler_gamma ** 2
    if resumed.step != 3 * spe or epochs != [spe, 2 * spe, 3 * spe] or \
            resumed.scheduler.last_epoch != 3 * spe or abs(lr - want_lr) > 1e-12:
        raise AssertionError(f"{name} resume: step {resumed.step}, checkpoints {epochs}, "
                             f"schedule at {resumed.scheduler.last_epoch} with lr {lr}")
    with open(os.path.join(ck, "best_acc.json")) as f:
        best = json.load(f)
    if latest_step(os.path.join(ck, "best")) != best["step"] or load_nose_prior(ck) is None:
        raise AssertionError(f"{name}: best/ holds {latest_step(os.path.join(ck, 'best'))}, "
                             f"best_acc.json {best}, nose prior {load_nose_prior(ck)}")
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(l) for l in f]
    vals = [l for l in lines if "val_accuracy" in l]
    if not lines or not vals or not all(
            all(isinstance(v, (int, float)) and v == v and abs(v) != float("inf")
                for v in l.values()) for l in lines):
        raise AssertionError(f"{name}: metrics {lines[-3:]}")
    fresh = create_pretrain_state(cfg3, 11, dev, steps_per_epoch=spe)[0]
    restore_checkpoint(ck, fresh)
    same = all(torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(),
                                                fresh.model.state_dict().values()))
    if not same or fresh.step != resumed.step:
        raise AssertionError(f"{name}: the checkpoint does not reload bit for bit")
    log(f"detector (4) {name}: {spe} steps per epoch, 2 epochs in {first_s:.1f} s, resumed to "
        f"step {resumed.step} in {resume_s:.1f} s (lr {lr:.1e}); checkpoints {epochs} + best/ "
        f"at step {best['step']} (val_accuracy {best['best_acc']:.4f}); {len(vals)} "
        f"validations, last {json.dumps({k: round(v, 4) for k, v in vals[-1].items()})}; "
        f"{moved} parameter elements moved; reloads bit for bit {tag}")
    return launches


def time_detector(dev, tag):
    """Phase 16 (5): the eager f32 pretrain step's ms and images/s at
    batch 64, 256², both head modes with cuDNN's default TF32 and the
    absolute head with TF32 off, peak memory, a profile of one step, and
    the eval step's images/s."""
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.entry import pretrain_entry
    from tpgan_tpu_torch.train.pretrain import make_eval_step

    rates = {}
    for head_mode, tf32 in (("absolute", True), ("anchor_offset", True), ("absolute", False)):
        torch.backends.cudnn.allow_tf32 = tf32
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        step_fn, (state, images, labels, gen) = pretrain_entry(head_mode=head_mode)
        for _ in range(3):
            state, metrics = step_fn(state, images, labels, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DETECTOR_TIMED_STEPS):
            state, metrics = step_fn(state, images, labels, gen)
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / DETECTOR_TIMED_STEPS
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(torch.isfinite(v) for v in metrics.values()):
            raise AssertionError(f"detector step {head_mode}: metrics {metrics}")
        box = [state]

        def one_step():
            box[0], _m = step_fn(box[0], images, labels, gen)

        stats = profile(one_step, 2, f"detector f32 pretrain step {head_mode} batch "
                        f"{DETECTOR_BATCH}, TF32 {'on' if tf32 else 'off'}", "step", tag,
                        {"conv": ["conv", "xmma", "gemm"], "batch_norm": ["batch_norm", "bn_"]})
        check_traced(stats, f"detector step {head_mode}", {})
        eval_step = make_eval_step(make_config({"pretrain": {"head_mode": head_mode}}),
                                   state.model)
        for _ in range(2):
            eval_step(state, images, labels, gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(DETECTOR_TIMED_STEPS):
            m = eval_step(state, images, labels, gen)
        torch.cuda.synchronize()
        eval_rate = DETECTOR_BATCH * DETECTOR_TIMED_STEPS / (time.perf_counter() - t0)
        if not all(torch.isfinite(v) for v in m.values()):
            raise AssertionError(f"detector eval {head_mode}: metrics {m}")
        log(f"time: detector f32 pretrain step {head_mode}, batch {DETECTOR_BATCH}, "
            f"{DETECTOR_SIZE}x{DETECTOR_SIZE}: {dt * 1e3:.2f} ms/step = "
            f"{DETECTOR_BATCH / dt:.1f} images/s ({DETECTOR_TIMED_STEPS} steps after 3 "
            f"warm-up, inputs on the device, cuDNN's TF32 {'on' if tf32 else 'off'}); peak "
            f"memory {peak:.2f} GiB; eval step {eval_rate:.1f} images/s {tag}")
        rates[(head_mode, tf32)] = (DETECTOR_BATCH / dt, peak, eval_rate, stats)
        del step_fn, state, images, labels, gen, box, eval_step
    torch.backends.cudnn.allow_tf32 = True
    return rates


def run_detector(dev, tag):
    """Phase 16: the landmark detector, (1)-(5). Launches none of the
    port's kernels: its launches go on a line of their own."""
    import torch

    from tpgan_tpu_torch.data.celeba import CelebALandmarkDataset
    from tpgan_tpu_torch.data.pipeline import stop_worker_server

    start = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        txt = detector_corpus(root, tag)
        check_detector_forward(dev, tag)
        check_detector_step(dev, tag, CelebALandmarkDataset(txt, root, DETECTOR_SIZE))
        torch.cuda.empty_cache()
        files = run_detector_pretrain(dev, tag, root, txt, "files-256", [])
        stop_worker_server()
        device = run_detector_pretrain(dev, tag, root, txt, "device-256-384",
                                       ["pretrain.image_buckets=(256,384)"])
        torch.cuda.empty_cache()
        rates = time_detector(dev, tag)
    launched = {k: files[k] + device[k] for k in files}
    if any(launched.values()):
        raise AssertionError(f"detector: the pretrain runs launched port kernels {launched}")
    log(f"detector: wrapper launches {launched} in the two run_pretrain runs (the detector "
        f"path runs none of the port's kernels); phase 16 took "
        f"{time.perf_counter() - start:.1f} s")
    return rates


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
    loop_launches, loop_rates = run_loop(dev, tag, train_rates[TRAIN_BATCH][0])
    run_multi_step_f32(dev)
    graphed_rates = time_graphed_step(dev, tag, train_rates)
    run_options(dev, tag, train_rates[TRAIN_BATCH][1])
    run_graphed_synthesis(dev, tag)

    # ---- 14. data: the loop fed from files, shards and device memory ----
    torch.cuda.empty_cache()
    run_data(dev, tag, graphed_rates, loop_rates)

    # ---- 15. identity and eval: the embedder, its training, the term, the protocol ----
    gc.collect()
    torch.cuda.empty_cache()
    run_identity_eval(dev, tag, train_rates, graphed_rates)

    # ---- 16. the landmark detector: corpus, parity, run_pretrain, timings ----
    gc.collect()
    torch.cuda.empty_cache()
    run_detector(dev, tag)

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
    adopt_orphans()
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        print("FAIL: chip smoke run failed", flush=True)
        code = 1
    # on stderr: the last line of stdout stays the result
    for pid, (state, cmd) in stop_processes().items():
        print(f"stopped a process left running: {pid} ({state}) {cmd}", file=sys.stderr, flush=True)
    sys.exit(code)
