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
                 the A/B shapes through the mma_sync kernel, the f32
                 CUDA-core kernel at the three A/B shapes and the same
                 tails (Cin 5 guarded, Cout 264), on an x 4 bytes off 16
                 (guarded) and at y exactly 0 (bit for bit, signs
                 included), the JAX test's shape and an odd one (mma_sync),
                 each asserting the kernel variant it launched and its
                 copy path (16-byte or guarded), a NaN planted in x, bf16
                 within one bf16 ulp (2^-7 |want| + 1e-6 max|want|), f32
                 within 1e-5 max|want|; a CUDA tensor the kernel does not
                 take (dtype, mixed dtypes, layout, requires grad) raises;
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
                 whole wrapper call timed, beside a contiguous g);
                 synthesis latency and images/s at batch 8 and 128;
                 train-step ms and images/s at batch 16 and 64 with peak
                 memory; profiler breakdowns of the batch-8 forward and of
                 one batch-16 train step, with the kernel that runs just
                 before each fuse backward;
9. conv A/B    — ``tpgan_tpu_torch.examples.conv_ab``, K3's one path: in
                 bf16 the kernel (``tma_wgmma``) against the mma_sync
                 kernel (in turns), in f32 the CUDA-core kernel, each
                 beside cuDNN's conv + epilogue (f32 with TF32 off) and the
                 plain version at the three head-area shapes; one JSON
                 line per shape and dtype; K3's launches equal the calls
                 the A/B made, per variant (f32 launches = f32 calls); a
                 profile of one kernel call and of the cuDNN call at the
                 first shape, in bf16 and in f32;
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
                 the CLI's ``pretrain`` (``cli.main``), 2 epochs and a
                 ``--resume`` to 3, from the JPEG files through
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
17. frontalize  — full-stack frontalization, uint8 frames to faces: the
                 main path, ``frontalize_entry()`` (8 frames of 480x640,
                 the MobileNetV2 + SSD detector at 256 in f32, the
                 full-size generator in bf16), answers 2 requests, 3 K1
                 launches each; (a) card against CPU (f32, TF32 off, 2
                 frames): ``resize`` in each method, ``scale_and_translate``
                 and the synthesis preprocessing within 1e-5 (nearest
                 equal), ``detect_lm5`` with TTA, refine and a nose prior on
                 a detector whose location biases fall in the frame, its
                 decode picks equal, lm5 within 1e-3 px, scores within
                 1e-5, the f32 face within 1e-4 of its largest, the bf16
                 face within 5% of the f32 one; (b) ``make_graphed_
                 frontalize_fn``'s replays bit-equal to the eager function
                 in f32 and bf16 on frames other than the capture's, a
                 replay's trace holding 3 fuse kernels; (c) images/s at
                 batch 8 and the batch-1 median and p90 latency, eager and
                 graphed, peak memory, kernels per forward and the
                 device's idle share, and the graphed
                 ``make_synthesis_pipeline`` beside phase 13's graphed
                 synthesis; (d) ``make_full_inference_fn`` once at full
                 width, finite.
18. int8 and serving — int8 post-training quantization (``ops/quant.py``:
                 im2col + ``torch._int_mm``) and the ``torch.export``
                 serving artifacts: the main path, ``int8_entry()`` (the
                 full-size generator in bf16, calibrated on its example
                 batch), answers 2 requests of 8, 3 K1 launches each; (a)
                 ``int8``, ``int8+bf16rescale`` and ``int8+subpixel+
                 bf16rescale`` (the bench's, calibrated on one batch of 16),
                 eager and graphed at batch 8 and 128: replays bit-equal to
                 eager, K1 3 per eager forward and 3 in a replay's trace,
                 images/s, peak memory and kernels per forward beside phase
                 13's bf16; (b) card against CPU: the int32 sums of three
                 layers equal; every int8 conv of the f32 synthesis fed
                 the CPU run's float input, its quantized weight and input
                 held by flips, its int32 sums and its rescale against the
                 CPU's; the whole f32 int8 synthesis (each side calibrated
                 on its own) up to its first flip; (c) the per-layer A/B of
                 ``examples/int8_variants_probe.py``: every distinct conv
                 shape of the generator at batch 8, cuDNN bf16 against the
                 int8 conv, us per call; (d) ``frontalize_entry``'s program
                 with the int8 generator (2 eager requests, 3 K1 launches
                 each; graphed equal to eager; images/s at batch 8 and the
                 batch-1 latency beside phase 17's); (e) ``serving``:
                 ``export_synthesis`` (f32, int8) and ``export_frontalize``
                 (int8) on the card, each
                 loaded back against the live program (within 1e-5 of its
                 largest; their fuse is the plain one, and K1 equals it),
                 their sizes, and ``aot_compile_synthesis``'s first
                 request against ``make_synthesize_fn``'s.
19. cli        — the command line at full width, ``tpgan_tpu_torch.cli.
                 main`` in this process (the counts are read here):
                 ``synth-data --protocol both --pack`` (4 subjects, 96
                 CelebA-layout JPEGs); ``train`` bf16, batch 16, from
                 ``--packed --device-data`` (yaw-weighted), 20 steps eager
                 (7 / 2 / 1 / 1 launches per step) and 20 with
                 ``--steps-per-dispatch 2`` (a CUDA graph: only the warm-up
                 steps launch wrappers), metrics finite, a checkpoint;
                 ``synthesize`` from it (a 128x128 PNG, 3 K1 launches);
                 ``eval`` on the rendered list (finite JSON, every camera);
                 ``pretrain --device-data``; ``frontalize`` a PNG and a
                 JPEG frame with both checkpoints (3 K1 each); an f32
                 ``export`` loaded back within EXPORT_TOL of the live
                 program; then ``python3 -m tpgan_tpu_torch synthesize`` in
                 a fresh process (within the bf16 bound of the in-process
                 PNG) and one with ``CUDA_VISIBLE_DEVICES=`` (exit 3). Each
                 subcommand's wall time, and ``train``'s images/s.
20. scale-out  — the data axis (``parallel/``): (a) a world of one over
                 NCCL in this process, full size, bf16, batch 16:
                 ``run_gan_training(mesh=make_mesh(...))`` for 2 eager
                 steps and for one K = 2 dispatch (the NCCL all-reduces in
                 the CUDA graph), each against the same run without a
                 mesh (deterministic cuDNN, 4 ulps of each leaf's
                 largest); ms per step with and without the mesh in
                 turns, and the all-reduce's device time from a profile;
                 (b) two ranks over gloo on this card (NCCL takes one
                 rank per card): ``entry.dryrun_multichip(2, "gloo")``
                 (JAX's layout for two devices: ``{data: 1, model: 2}``),
                 the detector's step at 256 with synced BatchNorm on 2 x
                 32 rows against one process at 64, and the full-size
                 bf16 GAN step on 2 x 8 rows for 2 steps, each rank's
                 kernel launches (7 / 2 / 1 / 1 per step) and its time,
                 host-staged and not a data-parallel rate; (c) ``python3
                 -m torch.distributed.run --nproc-per-node 1 -m
                 tpgan_tpu_torch train --set mesh.data=1`` in a fresh
                 interpreter, and ``mesh.data=2`` on that world of one,
                 which exits non-zero with ``make_mesh``'s message; (d)
                 no process of the phase left running.
21. model axis — tensor parallelism (``parallel/tensor_parallel.py``),
                 gloo ranks sharing this card: (a)
                 ``entry.dryrun_multichip(4, "gloo")`` on ``{data: 2,
                 model: 2}``: the fm 0.25 f32 step against one process
                 (``1e-3 + 1e-3|ref|``), the full-size f32 synthesis
                 under dp+tp within 5e-4 (TF32 off), MiB of parameters +
                 Adam per rank against one process's; (b) the full-size
                 bf16 GAN step at batch 16 on ``{data: 1, model: 2}`` for
                 2 steps: metrics finite, the gathered parameters' movement
                 against one process's bf16 run, within TP_NOISE_FACTOR of
                 the distance from that run to its f32 twin, each rank's
                 launches (7 / 2 / 1 / 1 per step), ``per_device_bytes``
                 below 0.8 of one process's, ``max_memory_allocated`` and
                 ms per step (host-staged, not a tensor-parallel rate);
                 (c) the detector's f32 step at 256 on ``{data: 1, model:
                 2}`` against one process; (d) ``python3 -m
                 torch.distributed.run --nproc-per-node 1 -m
                 tpgan_tpu_torch train --set mesh.model=2``, which exits
                 non-zero with ``make_mesh``'s "1 devices not divisible by
                 model=2"; (e) no process of the phase left running.

Counts are set to 0 just before each path (serve, train, conv A/B, loop,
phase 14's two loops, phase 15's steps and protocol runs, phase 16's
two ``pretrain`` runs, phase 17's frontalize requests, phase 18's int8
synthesis and int8 frontalize requests, each of phase 19's
subcommands, phase 20's mesh runs and each gloo rank's GAN steps, phase
21's tensor-parallel ranks' GAN steps) is driven
and read just after; launches made to compare a kernel with its
plain version do not count. A CUDA graph's replays run no wrapper and
count nothing (``ops.kernels.captured_launches``): the ``kernels`` line's
launches are the wrappers' own, and the profiler traces of phases 11, 13
and 17 show that the kernels run inside the graphs. Ends with a
``{"kernels": [...]}`` line, the card's name and power limit, and
``{"ok": true, "device": {...}}`` as the last line.
Imports nothing of JAX; needs one GPU.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import gc
import itertools
import json
import os
import re
import shutil
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
# the K1 / K2 wrappers' layout copies per bf16 step (``kernels.copy_counts``):
# the channels-last parts in and canvases out, the canvases' g and the part
# gradients back, K2's image and its gradient
COPIES_PER_STEP = {"fuse_parts_in": 28, "fuse_parts_out": 7, "fuse_parts_bwd_g": 2,
                   "fuse_parts_bwd_out": 8, "sym_tv_in": 1, "sym_tv_bwd_out": 1}
# the port's kernels by their CUDA function names, as a profiler trace
# names them (longest first: one name holds no other)
TRACE_KERNELS = re.compile(r"(fuse_parts_bwd_kernel|fuse_parts_kernel|sym_tv_bwd_general_kernel|"
                           r"sym_tv_bwd_kernel|sym_tv_kernel|conv3x3_\w*_kernel)")
# K3 on the card: (B, H, W, Cin, Cout, dtype name, variant, 16-byte copies)
# beside the three A/B shapes in bf16 — the TMA + wgmma kernel's tails (W
# 96: the last column tile runs past W; W 8; H 1; B 1; Cin 72: a zero-filled
# chunk tail; Cout 72 and 200: N tails), the f32 kernel at the three A/B
# shapes and the same tails (Cin 5: its guarded copies; Cout 264: three N
# tiles), the JAX test's shape, odd sizes (mma_sync, f32 guarded)
CONV_CHECKS = ((2, 6, 96, 64, 64, "bfloat16", "tma_wgmma", True),
               (2, 20, 8, 64, 64, "bfloat16", "tma_wgmma", True),
               (2, 1, 40, 64, 64, "bfloat16", "tma_wgmma", True),
               (1, 32, 32, 128, 128, "bfloat16", "tma_wgmma", True),
               (2, 16, 16, 72, 64, "bfloat16", "tma_wgmma", True),
               (2, 16, 16, 64, 72, "bfloat16", "tma_wgmma", True),
               (2, 12, 12, 32, 200, "bfloat16", "tma_wgmma", True),
               (8, 128, 128, 64, 64, "float32", "f32", True),
               (8, 64, 64, 128, 128, "float32", "f32", True),
               (32, 32, 32, 256, 256, "float32", "f32", True),
               (2, 6, 96, 64, 64, "float32", "f32", True),
               (2, 20, 8, 64, 64, "float32", "f32", True),
               (2, 1, 40, 64, 64, "float32", "f32", True),
               (1, 32, 32, 128, 128, "float32", "f32", True),
               (2, 16, 16, 72, 64, "float32", "f32", True),
               (2, 9, 13, 5, 64, "float32", "f32", False),
               (2, 16, 16, 64, 72, "float32", "f32", True),
               (2, 12, 12, 32, 200, "float32", "f32", True),
               (2, 8, 8, 32, 264, "float32", "f32", True),
               (2, 16, 16, 8, 16, "float32", "f32", True),
               (2, 16, 16, 8, 16, "bfloat16", "tma_wgmma", True),
               (2, 9, 13, 5, 7, "float32", "f32", False),
               (2, 9, 13, 5, 7, "bfloat16", "mma_sync", False))
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
# phase 17: full-stack frontalization, frontalize_entry's program (batch 8
# uint8 frames of 480x640, the detector at 256 in f32, the generator at
# full size in bf16); the card-against-CPU check on 2 of its frames
FRONT_REQUESTS = 2
FRONT_CHECK_BATCH = 2
FRONT_LM_TOL = 1e-3  # px, card against CPU
FRONT_SCORE_TOL = 1e-5
FRONT_F32_TOL = 1e-4  # of the f32 face's largest magnitude, TF32 off
FRONT_RESAMPLE_TOL = 1e-5  # the resampler and the preprocessing, card against CPU
FRONT_TIMED = 20  # back-to-back calls per images/s figure
FRONT_LATENCY = 100  # batch-1 calls, each timed alone (p90: ten beyond it)
# phase 18: int8 synthesis and the serving export
INT8_REQUESTS = 2
INT8_MODES = ("int8", "int8+bf16rescale", "int8+subpixel+bf16rescale")
INT8_SCAN_128 = 4  # dependent forwards per timed dispatch at batch 128 (one timed)
INT8_CHECK_BATCH = 2  # the card-against-CPU synthesis
INT8_AB_ITERS = 20  # timed calls per form and conv shape in the per-layer A/B
# (input channels, size, kernel, stride, (lo, hi) padding, input dilation) of
# the layers whose int32 sums the card and the CPU must give alike: the RGB
# stem (K 147, padded to 152), conv0_res0's 7x7 64 -> 64 at 128x128 (K
# 3,136) and deconv_32 as the dilated transposed conv (stride 4)
INT8_LAYER_CHECKS = {"stem 7x7 3->64": (3, 128, 7, 1, (3, 3), 1),
                     "conv0_res0 7x7 64->64": (64, 128, 7, 1, (3, 3), 1),
                     "deconv_32 dilated x4": (64, 8, 3, 1, (2, 3), 4)}
# Each int8 conv of the f32 synthesis on the card, fed the float input
# the CPU run gave its twin (both programs on the CPU's scales): the
# quantized weight and input flip in at most INT8_LAYER_FLIP_SHARE of
# their values and never by more than 1 (the same IEEE products and
# half-to-even rounding on both sides: none expected); the int32 sums of
# the CPU's int8 input equal the CPU's; the rescale of the CPU's sums is
# within INT8_RESCALE_REL of the CPU's output, of its largest magnitude
# (elementwise float32 on both sides: equal expected). A bar per layer
# does not depend on how a flip propagates.
INT8_LAYER_FLIP_SHARE = 1e-3
INT8_RESCALE_REL = 1e-6
# The whole f32 int8 synthesis, each side calibrated on its own
# (tests/test_torch_quant.py's argument): a last-bit difference in a float
# activation or a scale moves a quantized value by 1 at a rounding edge,
# and a flip then propagates through the layers after it; so only the
# first layer that flips is held: by 1, in at most INT8_FIRST_FLIP_SHARE
# of its values. The share over all layers and the image error are printed.
INT8_FIRST_FLIP_SHARE = 1e-3
EXPORT_TOL = 1e-5  # an artifact against the live program, of its largest output
# phase 19: the command line. synth-data renders CLI_SUBJECTS x 9 cameras
# (8 training items each) and a CelebA layout of CLI_PRETRAIN_IMAGES JPEGs;
# train takes CLI_TRAIN_STEPS steps (metrics logged at 10 and 20: steps
# 11-20 are the rate's window), eagerly and CLI_DISPATCH per dispatch
CLI_SUBJECTS = 4
CLI_PRETRAIN_IMAGES = 96
CLI_PRETRAIN_BATCH = 16
CLI_TRAIN_STEPS = 20
CLI_DISPATCH = 2
# the CLI's pretrain (phase 16): 544 training and 64 validation
# images, validation every 5 steps, 2 epochs then a resume to 3, the
# learning rate's milestones at epochs 1 and 2
DETECTOR_OVERRIDES = ["pretrain.train_data_ratio=0.85", "pretrain.validation_data_ratio=0.1",
                      "pretrain.log_step_of_batchs=5", "pretrain.num_epochs=2",
                      "pretrain.learning_rate_scheduler_milestone=(1,2)"]

# phase 20: scale-out. (a) SCALE_EAGER_STEPS eager steps and one K = 2
# dispatch through run_gan_training with and without a world-of-one NCCL
# mesh, the states within SCALE_STATE_ULPS of each leaf's largest (phase
# 7's bar: with one rank the all-reduce adds nothing and divides by 1);
# SCALE_TIMED_STEPS steps per timing turn. (b) the detector's step on two
# gloo ranks against one process: the parameters' movement within the
# card-against-CPU bar of tests/test_torch_cuda.py (the seeded MobileNetV2
# is ill-conditioned in f32; the CPU tests measured 8.7e-3 for two ranks
# against float64) and the loss within 1e-3 of itself; SCALE_GAN_STEPS
# full-size steps per rank. (c) the CLI's train under torchrun on a
# protocol of SCALE_SUBJECTS subjects.
SCALE_EAGER_STEPS = 2
SCALE_STATE_ULPS = TRAIN_F32_GRAD_ULPS
SCALE_TIMED_STEPS = 5
SCALE_DETECTOR_MOVE_REL_L2 = 5e-2
SCALE_DETECTOR_LOSS_RTOL = 1e-3
SCALE_GAN_STEPS = 2
SCALE_SUBJECTS = 2
# phase 21: the model axis. (b) TP_GAN_STEPS full-size bf16 steps on two
# model ranks against one process. Adam's first steps move each weight by
# about lr * sign(g), so a weight whose gradient is within bf16's noise of
# 0 moves by +lr in one run and -lr in another: two bf16 runs that round
# differently (the model ranks' partial sums, the bias added after the
# gather) land far apart in the parameters' movement even when both are
# right. The bar is that noise, measured in the same call: the ranks'
# movement within TP_NOISE_FACTOR times the distance between one
# process's bf16 and f32 (TF32 off) runs, in relative L2 (two runs each
# that far from a third are at most twice that far from each other).
# Each rank's parameters + Adam below TP_BYTES_SHARE of one process's
# (tests/test_parallel.py:181).
TP_GAN_STEPS = 2
TP_NOISE_FACTOR = 2.0
TP_BYTES_SHARE = 0.8

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
    each shape launched and through its plan whether it copied 16 bytes at
    a time or element by element; an f32 bias beside bf16; f32 on an x
    misaligned by 4 bytes (guarded) and at y exactly 0; the refusals."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.examples import conv_ab
    from tpgan_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32
    slope = conv_ab.NEGATIVE_SLOPE
    cases = ([(*s, "bfloat16", "tma_wgmma", True, None) for s in conv_ab.SHAPES]
             + [(*c, None) for c in CONV_CHECKS]
             + [(*s, "bfloat16", "mma_sync", True, "mma_sync") for s in conv_ab.SHAPES])
    for *shape, dname, variant, vec, forced in cases:
        x, k, b = conv_ab.make_inputs(tuple(shape), dev, getattr(torch, dname))
        x[0, shape[1] // 2, shape[2] // 2, 0] = float("nan")
        plan = kernels.conv3x3_plan(*shape, x.dtype, x.data_ptr() % 16, k.data_ptr() % 16)
        if plan.vec != vec:
            raise AssertionError(f"conv3x3 {shape} {dname}: the plan copies "
                                 f"{'16 bytes' if plan.vec else 'element-wise'}, expected "
                                 f"{'16 bytes' if vec else 'element-wise'}")
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
        log(f"kernel check: conv3x3_bias_lrelu {tuple(shape)} {dname} [{variant}, "
            f"{'16-byte' if vec else 'guarded'}]: max|kernel - plain| {err:.3e} of max|plain| "
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

    x, k, b = conv_ab.make_inputs((2, 16, 16, 64, 64), dev, torch.float32)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    plan = kernels.conv3x3_plan(*x.shape, 64, x.dtype, shifted.data_ptr() % 16)
    before = kernels.conv3x3_variant_counts()["f32"]
    err = conv_ab.check_against_plain(kernels.conv3x3_bias_lrelu(shifted, k, b, slope),
                                      kernels.conv3x3_bias_lrelu_plain(x, k, b, slope))
    if plan.vec or kernels.conv3x3_variant_counts()["f32"] != before + 1:
        raise AssertionError(f"conv3x3 f32 on an x 4 bytes off 16: plan {plan}, launched "
                             f"{kernels.conv3x3_variant_counts()['f32'] - before} f32")
    errors["conv3x3_bias_lrelu"] = max(errors["conv3x3_bias_lrelu"], err)
    log(f"kernel check: conv3x3_bias_lrelu (2, 16, 16, 64, 64) float32, x {shifted.data_ptr() % 16} "
        f"bytes off 16 [f32, guarded]: max|kernel - plain| {err:.3e}, within limits")
    for cin in (8, 5):  # 16-byte copies and guarded
        x = torch.from_numpy(np.random.RandomState(3).randn(1, 4, 5, cin).astype(np.float32)).to(dev)
        k = torch.zeros(3, 3, cin, 4, device=dev)
        b = torch.tensor([0.0, -0.0, -1.5, 2.0], device=dev)
        got = kernels.conv3x3_bias_lrelu(x, k, b, 0.2)
        want = kernels.conv3x3_bias_lrelu_plain(x, k, b, 0.2)
        if not (torch.equal(got, want) and torch.equal(got.signbit(), want.signbit())):
            raise AssertionError(f"conv3x3 f32 at y = 0 (Cin {cin}): {got[0, 0, 0].tolist()} "
                                 f"against {want[0, 0, 0].tolist()}")
    log("kernel check: conv3x3_bias_lrelu float32 at y exactly 0 and -0 (Cin 8 and 5): "
        "equal to the plain version, signs included")

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
    if copies != {k: v * TRAIN_STEPS for k, v in COPIES_PER_STEP.items()}:
        raise AssertionError(f"train path's layout copies {copies}, expected "
                             f"{COPIES_PER_STEP} per step")
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

    lines, bf16_rates = [], {}
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
                bf16_rates[batch] = rates
                line += (f", {rates['graphed']:.1f} images/s graphed against {rates['eager']:.1f} "
                         f"eager ({bench.SCAN_LEN} dependent forwards per timed dispatch, best "
                         f"of 3)")
            lines.append(line)
        del fns
        torch.cuda.empty_cache()
    _f32_exact(False)
    log(f"graphed synthesis: {'; '.join(lines)} {tag}")
    return bf16_rates


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


def _pretrain_cli(dev, args, cfg, ck, resume, device_data):
    """``python -m tpgan_tpu_torch pretrain`` in this process, as a user
    calls it: ``cli.main`` with ``args`` (``--set`` overrides) and the
    checkpoint directory. Returns (the final state and the steps per
    epoch that ``run_pretrain`` was given, the log directory)."""
    from tpgan_tpu_torch import cli
    from tpgan_tpu_torch.train import pretrain

    seen = {}

    def recorder(*a, **k):
        seen["state"], seen["spe"] = real(*a, **k), k["steps_per_epoch"]
        return seen["state"]

    real = pretrain.run_pretrain
    argv = ["pretrain", "--checkpoint", ck, *args, "--device", str(dev)]
    argv += ["--device-data"] if device_data else []
    argv += ["--resume"] if resume else []
    with mock.patch.object(pretrain, "run_pretrain", recorder):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli pretrain {argv} failed")
    return seen["state"], seen["spe"], os.path.join(cfg.pretrain.log_root_dir,
                                                     cfg.pretrain.model_name)


def run_detector_pretrain(dev, tag, root, txt, name, overrides):
    """Phase 16 (4): the CLI's ``pretrain`` (``cli.main``), 2 epochs then
    ``--resume`` to 3: metrics finite, the parameters moved, the
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
    args = [a for kv in base for a in ("--set", kv)]
    device_data = "device" in name
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    state, spe, log_dir = _pretrain_cli(dev, args, cfg, ck, False, device_data)
    first_s = time.perf_counter() - t0
    first_step = state.step
    init = build_detector(cfg, dev, seed=0)
    moved = sum(int((a != b).sum()) for a, b in zip(state.model.parameters(), init.parameters()))
    if first_step != 2 * spe or latest_step(ck) != first_step or not moved:
        raise AssertionError(f"{name}: {first_step} steps ({spe} per epoch), newest checkpoint "
                             f"{latest_step(ck)}, {moved} parameter elements moved")
    cfg3 = flat_override(cfg, ["pretrain.num_epochs=3"])
    t0 = time.perf_counter()
    resumed, _, _ = _pretrain_cli(dev, [*args, "--set", "pretrain.num_epochs=3"], cfg3, ck, True,
                                  device_data)
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


def in_frame_detector(device, size, seed=0):
    """The full detector (f32, eval mode) with weights from ``seed`` and
    its location biases drawn inside a ``size`` frame: its points fall on
    the image, so the crops, the refine window and the nose vote see real
    geometry (the seeded head's zero biases put every point in a corner)."""
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.train.pretrain import build_detector

    det = build_detector(make_config(), device, seed=seed)
    gen = torch.Generator(device="cpu").manual_seed(seed + 1)
    with torch.no_grad():
        for name, conv in det.ssd_head.named_children():
            if name.startswith("loc"):
                bias = torch.empty(conv.bias.shape).uniform_(0.15 * size, 0.85 * size,
                                                            generator=gen)
                conv.bias.copy_(bias)
    return det.eval()


def softmax_picks(cls):
    """Per image and part, the anchor the top-1 decode takes (the argmax
    over anchors of the part's softmax score, float64 on the host)."""
    import torch

    return torch.argmax(torch.softmax(cls.double().cpu(), dim=-1), dim=1)[:, :4]


def check_frontalize_parity(dev, tag, images):
    """Phase 17 (a): the resampler, the preprocessing, ``detect_lm5``
    (TTA, refine, a nose prior) and the f32 frontalize program on the card
    against the CPU, TF32 off; the bf16 face against the f32 one."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.jit_preprocess import preprocess_for_synthesis
    from tpgan_tpu_torch.entry import DETECTOR_SIZE
    from tpgan_tpu_torch.frontalize import detect_lm5, letterbox_batch, make_frontalize_fn
    from tpgan_tpu_torch.ops.resize import resize, scale_and_translate
    from tpgan_tpu_torch.train.gan_trainer import build_generator
    from tpgan_tpu_torch.train.pretrain import fit_nose_prior

    _f32_exact(True)
    cpu = torch.device("cpu")
    u8 = images[:FRONT_CHECK_BATCH]
    x = u8.float() / 255.0
    gaps = {}
    for method in ("lanczos3", "linear", "nearest"):
        got = resize(x, (FRONT_CHECK_BATCH, 128, 128, 3), method).cpu()
        want = resize(x.cpu(), (FRONT_CHECK_BATCH, 128, 128, 3), method)
        gaps[method] = float((got - want).abs().max())
    s, t = torch.tensor([0.4, 2.5]), torch.tensor([[-30.0, 12.5], [-400.0, -700.0]])
    gaps["scale_and_translate"] = float((scale_and_translate(x, (256, 256), s.to(dev), t.to(dev),
                                                             "linear").cpu()
                                         - scale_and_translate(x.cpu(), (256, 256), s, t, "linear"))
                                        .abs().max())
    lm68 = torch.from_numpy(np.random.RandomState(3).uniform(100, 400, (FRONT_CHECK_BATCH, 68, 2))
                            .astype(np.float32))
    got = preprocess_for_synthesis(u8, lm68.to(dev))
    want = preprocess_for_synthesis(u8.cpu(), lm68)
    gaps["preprocess"] = max(float((got[k].cpu() - v).abs().max()) for k, v in want.items())
    if gaps["nearest"] != 0 or max(gaps.values()) > FRONT_RESAMPLE_TOL:
        raise AssertionError(f"frontalize: the resampler on the card against the CPU {gaps}")

    det = in_frame_detector(dev, DETECTOR_SIZE)
    det_cpu = copy.deepcopy(det).to(cpu)
    prior = fit_nose_prior(np.random.RandomState(4).uniform(60, 200, (256, 4, 2)))
    opts = dict(detector_size=DETECTOR_SIZE, tta=True, refine=True, nose_prior=prior)
    boxed, _, _ = letterbox_batch(u8, DETECTOR_SIZE, True)
    boxed = torch.cat([boxed, torch.flip(boxed, dims=[2])])
    with torch.inference_mode():
        picks = [softmax_picks(m(b.permute(0, 3, 1, 2).contiguous())[1])
                 for m, b in ((det, boxed), (det_cpu, boxed.cpu()))]
    lm = [detect_lm5(m, im, **opts) for m, im in ((det, u8), (det_cpu, u8.cpu()))]
    lm_gap = float((lm[0][0].cpu() - lm[1][0]).abs().max())
    score_gap = float((lm[0][2].cpu() - lm[1][2]).abs().max())
    on_frame = bool(((lm[1][0] > 0) & (lm[1][0] < torch.tensor([640.0, 480.0]))).all())
    if (not torch.equal(picks[0], picks[1]) or lm_gap > FRONT_LM_TOL
            or score_gap > FRONT_SCORE_TOL or not torch.equal(lm[0][1].cpu(), lm[1][1])):
        raise AssertionError(f"frontalize: detect_lm5 on the card against the CPU: picks equal "
                             f"{torch.equal(picks[0], picks[1])}, lm5 {lm_gap} px, scores "
                             f"{score_gap}, valid equal {torch.equal(lm[0][1].cpu(), lm[1][1])}")

    cfg32 = make_config({"compute_dtype": "float32"})
    gen = build_generator(cfg32, dev, seed=0)
    gen_cpu = build_generator(cfg32, cpu, seed=0)
    gen_cpu.load_state_dict(gen.state_dict())
    z = torch.from_numpy(np.random.RandomState(5).standard_normal((FRONT_CHECK_BATCH, 64))
                         .astype(np.float32))
    face = make_frontalize_fn(cfg32, det, gen, **opts)(u8, z)[0]
    face_cpu = make_frontalize_fn(cfg32, det_cpu, gen_cpu, **opts)(u8.cpu(), z)[0]
    scale = float(face_cpu.abs().max())
    face_gap = float((face.cpu() - face_cpu).abs().max())
    cfg16 = make_config({"compute_dtype": "bfloat16"})
    face16 = make_frontalize_fn(cfg16, det, gen, **opts)(u8, z)[0]
    bf16_gap = float((face16.float() - face).abs().max())
    if face_gap > FRONT_F32_TOL * scale or bf16_gap > BF16_REL_DIFF * scale:
        raise AssertionError(f"frontalize: the face on the card against the CPU {face_gap} "
                             f"(limit {FRONT_F32_TOL} x {scale}); bf16 against f32 {bf16_gap}")
    _f32_exact(False)
    log(f"frontalize (a): card against CPU, f32, TF32 off, {FRONT_CHECK_BATCH} frames of 480x640: "
        f"resampler and preprocessing max|diff| {gaps} (limit {FRONT_RESAMPLE_TOL}, nearest 0); "
        f"detect_lm5 (TTA, refine, nose prior) decode picks equal "
        f"({int(picks[0].numel())} part x image), lm5 {lm_gap:.3e} px (limit {FRONT_LM_TOL}), "
        f"scores {score_gap:.3e}, points on the frames {on_frame}; face {face_gap:.3e} of max "
        f"{scale:.4f} (limit {FRONT_F32_TOL:.0e} x max); bf16 face against f32 {bf16_gap:.4f} "
        f"(limit {BF16_REL_DIFF:.0%} of max) {tag}")
    del gen, gen_cpu, det_cpu
    return det


def time_calls(fn, args, calls):
    """Seconds per call of ``fn(*args)``, ``calls`` back to back after two
    warm calls, one synchronise at the end (host clock)."""
    import torch

    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls


def latencies(fn, args, samples):
    """(median, the highest percentile with ten samples beyond it, its
    name) of ``samples`` calls each timed alone, in ms."""
    import torch

    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    lat = []
    for _ in range(samples):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    hi = samples - 11
    return statistics.median(lat), lat[hi], f"p{round(100 * (hi + 1) / samples)}"


def run_frontalize(dev, tag, synth_rates):
    """Phase 17: full-stack frontalization. The main path first (counts
    reset just before, read just after): ``frontalize_entry()``'s eager
    program answers FRONT_REQUESTS requests of 8 uint8 frames; then (a)
    card against CPU, (b) the graph against eager and a replay's trace,
    (c) speed and memory, (d) ``make_full_inference_fn`` once. Returns the
    main path's launches and {form: (images/s at batch 8, batch-1 median
    and p90 latency in ms)}."""
    import numpy as np
    import torch

    from tpgan_tpu_torch import api
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.jit_preprocess import make_synthesis_pipeline
    from tpgan_tpu_torch.entry import DETECTOR_SIZE, frames, frontalize_entry
    from tpgan_tpu_torch.frontalize import make_frontalize_fn, make_graphed_frontalize_fn
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.train.gan_trainer import build_generator, make_synthesize_fn

    start = time.perf_counter()
    fn, (images, z) = frontalize_entry()
    kernels.reset_launch_counts()
    outs = [fn(images, z) for _ in range(FRONT_REQUESTS)]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {**dict.fromkeys(launches, 0), "fuse_parts": 3 * FRONT_REQUESTS}
    b = images.shape[0]
    for fake, lm5, scores in outs:
        if (fake.shape != (b, 128, 128, 3) or fake.dtype != torch.bfloat16
                or lm5.shape != (b, 5, 2) or scores.shape != (b, 4)
                or not all(bool(torch.isfinite(t.float()).all()) for t in (fake, lm5, scores))):
            raise AssertionError(f"frontalize_entry gave {tuple(fake.shape)} {fake.dtype}, lm5 "
                                 f"{tuple(lm5.shape)}, scores {tuple(scores.shape)} or "
                                 "non-finite values")
    if launches != want:
        raise AssertionError(f"frontalize launches {launches}, expected {want}")
    log(f"frontalize: frontalize_entry() answered {FRONT_REQUESTS} requests of {b} uint8 frames "
        f"of 480x640 (detector 256 f32, generator full size bf16); launches {launches} {tag}")
    del fn, outs

    # (a) card against CPU
    det = check_frontalize_parity(dev, tag, images)

    # (b) the graph: replays bit-equal to eager, f32 and bf16; a replay's trace
    other = torch.as_tensor(frames(b, seed=9), device=dev)
    forms = {}
    for dname in ("float32", "bfloat16"):
        _f32_exact(dname == "float32")
        cfg = make_config({"compute_dtype": dname})
        gen = build_generator(cfg, dev, seed=0)
        eager = make_frontalize_fn(cfg, det, gen, detector_size=DETECTOR_SIZE)
        graphed = make_graphed_frontalize_fn(cfg, det, gen, detector_size=DETECTOR_SIZE)
        graphed(other, z)  # the capture, on frames of its own
        kernels.reset_launch_counts()
        got = graphed(images, z)
        torch.cuda.synchronize()
        replay_launches = sum(kernels.launch_counts().values())
        wanted = eager(images, z)
        record = [r["fuse_parts"] for r in graphed.launches().values()]
        if (not all(torch.equal(g, w) for g, w in zip(got, wanted)) or replay_launches
                or record != [3]):
            gaps = [float((g.float() - w.float()).abs().max()) for g, w in zip(got, wanted)]
            raise AssertionError(f"frontalize {dname}: graphed against eager max|diff| {gaps}; "
                                 f"wrapper launches over a replay {replay_launches}; the "
                                 f"capture's record {record}")
        forms[dname] = (eager, graphed)
        if dname == "float32":
            del eager, graphed, gen
            torch.cuda.empty_cache()
    _f32_exact(False)
    eager, graphed = forms.pop("bfloat16")
    names = {"fuse_parts": ["fuse_parts_kernel"]}
    stats = profile(lambda: graphed(images, z), 1, f"graphed bf16 frontalize batch {b}",
                    "forward", tag, names)
    check_traced(stats, "one graphed frontalize", {"fuse_parts_kernel": 3})
    log(f"frontalize (b): graphed == eager in f32 and bf16 on frames other than the capture's; "
        f"the trace of one replay holds 3 fuse kernels, the wrappers launched none {tag}")

    # (c) speed and memory: batch 8 images/s, batch 1 latency, the pipeline
    rows = {}
    for form, f in (("eager", eager), ("graphed", graphed)):
        torch.cuda.reset_peak_memory_stats()
        dt = time_calls(f, (images, z), FRONT_TIMED)
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profile(lambda: f(images, z), 3, f"{form} bf16 frontalize batch {b}", "forward",
                       tag, names)
        med, hi, hi_name = latencies(f, (images[:1], z[:1]), FRONT_LATENCY)
        rows[form] = (b / dt, med, hi, peak, prof)
    cfg16 = make_config({"compute_dtype": "bfloat16"})
    gen16 = build_generator(cfg16, dev, seed=0)
    pipeline = make_synthesis_pipeline(make_synthesize_fn(cfg16, gen16))
    lm68 = torch.from_numpy(np.random.RandomState(6).uniform(150, 350, (b, 68, 2))
                            .astype(np.float32)).to(dev)
    torch.cuda.reset_peak_memory_stats()
    pipe_rate = b / time_calls(pipeline, (images, lm68, z), FRONT_TIMED)
    pipe_peak = torch.cuda.max_memory_allocated() / 2**30
    pipe_prof = profile(lambda: pipeline(images, lm68, z), 3, f"graphed synthesis pipeline batch "
                        f"{b}", "forward", tag, names)
    parts = []
    for form, (rate, med, hi, peak, prof) in rows.items():
        busy = "not measured" if prof is None else (
            f"{prof['kernels']:.0f} kernels/forward, device idle {prof['idle']:.0%}")
        parts.append(f"{form} {rate:.1f} images/s at batch {b}, batch 1 latency median "
                     f"{med:.2f} ms {hi_name} {hi:.2f} ms, peak {peak:.2f} GiB, {busy}")
    busy = "not measured" if pipe_prof is None else (
        f"{pipe_prof['kernels']:.0f} kernels/forward, device idle {pipe_prof['idle']:.0%}")
    log(f"frontalize (c): {'; '.join(parts)}; make_synthesis_pipeline graphed (uint8 frames + "
        f"68 landmarks) {pipe_rate:.1f} images/s at batch {b}, peak {pipe_peak:.2f} GiB, {busy}; "
        f"phase 13's graphed synthesis (patches given) {synth_rates[BATCH]['graphed']:.1f} "
        f"images/s at batch {BATCH} {tag}")
    del eager, graphed, pipeline, forms

    # (d) make_full_inference_fn once, float frames in [0, 1] as it expects
    infer = api.make_full_inference_fn(cfg16, gen16, det, detector_input_size=DETECTOR_SIZE)
    out = infer(images.float() / 255.0, z)
    torch.cuda.synchronize()
    if out.shape != (b, 128, 128, 3) or not torch.isfinite(out.float()).all():
        raise AssertionError(f"make_full_inference_fn gave {tuple(out.shape)} or non-finite values")
    log(f"frontalize (d): make_full_inference_fn at full width, batch {b}: "
        f"{tuple(out.shape)} {out.dtype}, finite; phase 17 took "
        f"{time.perf_counter() - start:.1f} s {tag}")
    del infer, gen16, det
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {form: row[:3] for form, row in rows.items()}


def synthesis_request(dev, batch, seed):
    """A synthesis batch (``synthetic_gan_batch`` of ``seed``) and z from a
    seeded generator, on the card."""
    import torch

    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops.quant import SYNTHESIS_KEYS

    inputs = {k: torch.as_tensor(v, device=dev)
              for k, v in synthetic_gan_batch(batch, seed=seed).items() if k in SYNTHESIS_KEYS}
    z = torch.randn(batch, 64, device=dev, generator=torch.Generator(device=dev).manual_seed(seed))
    return inputs, z


def quantized_inputs(model, synthesize, batch, z):
    """``synthesize(batch, z)`` and, per int8 conv of ``model`` in call
    order, its quantized input (on the host)."""
    from tpgan_tpu_torch.ops import quant

    records = []
    hooks = [m.register_forward_hook(
        lambda mod, args, _out: records.append(mod.quantize(args[0]).cpu()))
        for m in model.modules() if isinstance(m, quant.Int8Conv)]
    try:
        out = synthesize(batch, z)
    finally:
        for h in hooks:
            h.remove()
    return out, records


def flip_stats(got, want):
    """Flips of quantized values between two runs' per-layer records: the
    first layer with a flip (index, share, largest flip), the share over
    all layers and the largest layer share."""
    first, flipped, total, worst = None, 0, 0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape:
            raise AssertionError(f"quantized inputs of layer {i}: {tuple(a.shape)} / "
                                 f"{tuple(b.shape)}")
        d = (a.int() - b.int()).abs()
        n = int((d > 0).sum())
        if n and first is None:
            first = (i, n / d.numel(), int(d.max()))
        flipped += n
        total += d.numel()
        worst = max(worst, n / d.numel())
    return first, flipped / total, worst


def _flips(got, want):
    """(share of values that differ, largest difference) of two int8 tensors."""
    if got.shape != want.shape:
        raise AssertionError(f"int8 tensors of shapes {tuple(got.shape)} / {tuple(want.shape)}")
    d = (got.int() - want.int()).abs()
    return int((d > 0).sum()) / d.numel(), int(d.max())


def int8_layers_against_cpu(cpu_model, card_model, batch, z, dev):
    """Every int8 conv of ``card_model`` (on the card) fed the float input
    its twin in ``cpu_model`` (the same program on the CPU) got in the
    CPU's synthesis of ``batch``: per conv, the flips (share, largest) of
    its quantized weight and of its quantized input against the CPU's,
    whether its int32 sums of the CPU's int8 input equal the CPU's, and
    the largest error of its rescale of the CPU's sums against the CPU's
    output, over that output's largest magnitude."""
    import torch

    from tpgan_tpu_torch.ops import quant
    from tpgan_tpu_torch.train.gan_trainer import synthesize_fn_of

    convs = {n: m for n, m in cpu_model.named_modules() if isinstance(m, quant.Int8Conv)}
    twins = dict(card_model.named_modules())
    seen = {}
    hooks = [m.register_forward_hook(
        lambda _mod, args, out, n=n: seen.setdefault(n, []).append((args[0], out)))
        for n, m in convs.items()]
    try:
        synthesize_fn_of(cpu_model)(batch, z)
    finally:
        for h in hooks:
            h.remove()
    if set(seen) != set(convs) or any(len(v) != 1 for v in seen.values()):
        raise AssertionError(f"int8 (b): {len(seen)} of {len(convs)} int8 convs ran once each")
    rows = []
    with torch.inference_mode():
        for name, conv in convs.items():
            twin = twins[name]
            (x, y), = seen[name]
            x_q = conv.quantize(x)
            acc = conv.accumulate(x_q)
            y_card = twin.rescale(acc.to(dev), y.dtype).cpu()
            rows.append({
                "name": name,
                "weight_flips": _flips(twin.weight_q.cpu(), conv.weight_q),
                "input_flips": _flips(twin.quantize(x.to(dev)).cpu(), x_q),
                "sums_equal": torch.equal(twin.accumulate(x_q.to(dev)).cpu(), acc),
                "rescale_rel": float((y_card - y).abs().max())
                / max(float(y.abs().max()), 1e-30)})
    return rows


def int8_layers_outside_bars(rows):
    """The rows of :func:`int8_layers_against_cpu` outside the per-layer bars."""
    def flips_ok(share_largest):
        return share_largest[0] <= INT8_LAYER_FLIP_SHARE and share_largest[1] <= 1

    return [r for r in rows
            if not (flips_ok(r["weight_flips"]) and flips_ok(r["input_flips"])
                    and r["sums_equal"] and r["rescale_rel"] <= INT8_RESCALE_REL)]


def run_int8(dev, tag, synth_rates, front_rates):
    """Phase 18: int8 synthesis and the serving export on the card. The
    main paths first (counts reset just before, read just after):
    ``int8_entry()``'s int8 synthesis answers INT8_REQUESTS requests of 8,
    then (a) the three int8 modes eager and graphed at batch 8 and 128,
    (b) card against CPU, (c) the per-layer A/B, (d) the int8 frontalize
    program (its eager requests a main path of their own), (e) the
    export round trips. Returns the main paths' launches (summed)."""
    import numpy as np
    import torch

    from tpgan_tpu_torch import bench, serving
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.jit_preprocess import preprocess_for_synthesis_lm5
    from tpgan_tpu_torch.entry import DETECTOR_SIZE, frames, int8_entry
    from tpgan_tpu_torch.examples import int8_variants_probe
    from tpgan_tpu_torch.frontalize import (
        detect_lm5,
        make_frontalize_fn,
        make_graphed_frontalize_fn,
    )
    from tpgan_tpu_torch.models import generator as generator_module
    from tpgan_tpu_torch.ops import kernels, quant
    from tpgan_tpu_torch.train.gan_trainer import (
        build_generator,
        make_int8_synthesize_fn,
        make_synthesize_fn,
        synthesize_fn_of,
    )
    from tpgan_tpu_torch.train.pretrain import build_detector

    start = time.perf_counter()
    _f32_exact(False)
    fn, (batch, z) = int8_entry()
    kernels.reset_launch_counts()
    outs = [fn(batch, z) for _ in range(INT8_REQUESTS)]
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {**dict.fromkeys(launches, 0), "fuse_parts": 3 * INT8_REQUESTS}
    for o in outs:
        if o.shape != (BATCH, 128, 128, 3) or o.dtype != torch.bfloat16 or not torch.isfinite(
                o.float()).all():
            raise AssertionError(f"int8_entry gave {tuple(o.shape)} {o.dtype} or non-finite values")
    if launches != want:
        raise AssertionError(f"int8 synthesis launches {launches}, expected {want}")
    log(f"int8: int8_entry() answered {INT8_REQUESTS} requests of {BATCH} (full size, bf16, "
        f"every conv int8 x int8 -> int32 through torch._int_mm); launches {launches} {tag}")
    del fn, outs

    # (a) the int8 modes, eager and graphed, at batch 8 and 128
    lines = []
    names = {"fuse_parts": ["fuse_parts_kernel"]}
    for mode in INT8_MODES:
        fns = bench.build_synthesizers(mode, dev)  # calibrated on one bench batch of 16
        for b in (BATCH, 128):
            fns["graphed"](*synthesis_request(dev, b, 1))  # the capture, on its own batch
            inputs, zb = synthesis_request(dev, b, 2)
            kernels.reset_launch_counts()
            got = fns["graphed"](inputs, zb)
            torch.cuda.synchronize()
            replay = sum(kernels.launch_counts().values())
            kernels.reset_launch_counts()
            eager = fns["eager"](inputs, zb)
            torch.cuda.synchronize()
            eager_launches = kernels.launch_counts()
            record = fns["graphed"].launches()[b]["fuse_parts"]
            if (not torch.equal(got, eager) or replay or record != 3
                    or eager_launches["fuse_parts"] != 3):
                raise AssertionError(
                    f"{mode} B={b}: graphed against eager max|diff| "
                    f"{float((got.float() - eager.float()).abs().max())}; wrapper launches "
                    f"over a replay {replay}; the capture's record {record}; eager "
                    f"{eager_launches}")
            torch.cuda.reset_peak_memory_stats()
            scan, repeats = (bench.SCAN_LEN, 2) if b == BATCH else (INT8_SCAN_128, 1)
            rates = {form: bench.measure(fns[form], b, dev, scan, repeats)
                     for form in ("graphed", "eager")}
            peak = torch.cuda.max_memory_allocated() / 2**30
            busy = ""
            if b == BATCH:
                stats = profile(lambda: fns["graphed"](inputs, zb), 1,
                                f"graphed {mode} synthesis batch {b}", "forward", tag, names)
                check_traced(stats, f"one graphed {mode} forward", {"fuse_parts_kernel": 3})
                eager_prof = profile(lambda: fns["eager"](inputs, zb), 2,
                                     f"eager {mode} synthesis batch {b}", "forward", tag, names)
                busy = ("" if eager_prof is None else
                        f", {eager_prof['kernels']:.0f} kernels/forward eager "
                        f"({eager_prof['busy_ms']:.2f} ms busy, idle {eager_prof['idle']:.0%}), "
                        f"graphed {stats['busy_ms']:.2f} ms busy")
            bf16 = synth_rates[b]
            lines.append(f"{mode} B={b}: graphed {rates['graphed']:.1f} eager {rates['eager']:.1f} "
                         f"images/s (bf16, phase 13: {bf16['graphed']:.1f} / {bf16['eager']:.1f}), "
                         f"peak {peak:.2f} GiB{busy}; replay == eager, K1 3 per eager forward and "
                         f"3 in a replay's trace")
        del fns
        torch.cuda.empty_cache()
    for line in lines:
        log(f"int8 (a): {line} {tag}")
    log(f"int8 (a): {time.perf_counter() - start:.1f} s into phase 18")

    # (b) card against CPU: one layer's int32 sums; the f32 int8 synthesis
    rng = np.random.RandomState(18)
    for name, (c, h, k, s, pad, dil) in INT8_LAYER_CHECKS.items():
        x_q = torch.from_numpy(rng.randint(-127, 128, (2, c, h, h)).astype(np.int8))
        mats = quant.pack_int8_weight(torch.from_numpy(
            rng.randint(-127, 128, (64, c, k, k)).astype(np.int8)))
        args = ((k, k), (s, s), (pad, pad), (dil, dil))
        cpu = quant.int8_conv_accumulate(x_q, mats, *args)
        card = quant.int8_conv_accumulate(x_q.to(dev), mats.to(dev), *args)
        if not torch.equal(cpu, card.cpu()):
            raise AssertionError(f"int8 (b): {name}'s int32 sums differ on the card")
    _f32_exact(True)
    cfg32 = make_config({"compute_dtype": "float32"})
    cpu = torch.device("cpu")
    gens = {dev: build_generator(cfg32, dev, seed=0)}
    gens[cpu] = copy.deepcopy(gens[dev]).cpu()  # the card's weights
    zs = [np.random.RandomState(30).standard_normal((INT8_CHECK_BATCH, 64)).astype(np.float32)]
    calib = bench.bench_batch(INT8_CHECK_BATCH, "cpu")
    request, zr = synthesis_request("cpu", INT8_CHECK_BATCH, 3)
    runs = {}
    for d, gen in gens.items():
        scales = quant.calibrate_synthesis(cfg32, gen, [calib], zs=zs)
        model = quant.make_int8_model(cfg32, gen, scales)
        out, recs = quantized_inputs(model, synthesize_fn_of(model), request, zr)
        runs[d.type] = (scales, out.cpu(), recs,
                        make_synthesize_fn(cfg32, gen)(request, zr).cpu())
        del model
    (s_card, o_card, q_card, f_card), (s_cpu, o_cpu, q_cpu, _f) = runs["cuda"], runs["cpu"]
    calib_rel = max(abs(float(s_card[k]) - float(s_cpu[k])) / float(s_cpu[k]) for k in s_cpu)
    first, share, worst = flip_stats(q_card, q_cpu)
    image_mae = float((o_card - o_cpu).abs().mean())
    quant_mae = float((o_card - f_card).abs().mean())
    layers = int8_layers_against_cpu(quant.make_int8_model(cfg32, gens[cpu], s_cpu),
                                     quant.make_int8_model(cfg32, gens[dev], s_cpu),
                                     request, zr, dev)
    bad = int8_layers_outside_bars(layers)
    ok = (not bad and (first is None or (first[2] == 1 and first[1] <= INT8_FIRST_FLIP_SHARE))
          and bool(torch.isfinite(o_card).all()))
    log(f"int8 (b): int32 sums equal on the card and the CPU ({', '.join(INT8_LAYER_CHECKS)}); "
        f"each of the {len(layers)} int8 convs of the f32 synthesis (batch {INT8_CHECK_BATCH}, "
        f"the CPU's scales) fed the CPU run's float input: weight flips share max "
        f"{max(r['weight_flips'][0] for r in layers):.2e} largest "
        f"{max(r['weight_flips'][1] for r in layers)}, input flips share max "
        f"{max(r['input_flips'][0] for r in layers):.2e} largest "
        f"{max(r['input_flips'][1] for r in layers)} (bars: share <= {INT8_LAYER_FLIP_SHARE}, "
        f"largest 1), int32 sums of the CPU's int8 input equal in "
        f"{sum(r['sums_equal'] for r in layers)}/{len(layers)} (bar: all), rescale of the CPU's "
        f"sums max rel {max(r['rescale_rel'] for r in layers):.2e} (bar {INT8_RESCALE_REL}); "
        f"{len(bad)} outside {[r['name'] for r in bad[:5]]} {tag}")
    log(f"int8 (b): the whole f32 int8 synthesis, each side calibrated and quantized on its "
        f"own: calibration max rel {calib_rel:.2e}; flips: first at layer "
        f"{None if first is None else first[0]} share {0 if first is None else first[1]:.2e} "
        f"max {0 if first is None else first[2]} (bars: max 1, share <= "
        f"{INT8_FIRST_FLIP_SHARE}); propagated: all layers {share:.2e}, worst layer "
        f"{worst:.2e}; image MAE card-CPU {image_mae:.2e} against the int8-float MAE "
        f"{quant_mae:.2e} {tag}")
    if not ok:
        raise AssertionError("int8 (b): the card's int8 synthesis is outside its bars against "
                             "the CPU")
    del gens[cpu], runs, layers
    _f32_exact(False)
    log(f"int8 (b): {time.perf_counter() - start:.1f} s into phase 18")

    # (c) the per-layer A/B: int8 conv (quantize, columns, _int_mm, rescale) against cuDNN bf16
    rows = int8_variants_probe.layer_ab(dev, iters=INT8_AB_ITERS, log=lambda line: None)
    log(f"int8 (c): per-layer A/B at batch {int8_variants_probe.LAYER_BATCH}, us per call, "
        f"bf16 cuDNN against int8 (kind, input, weight, calls per forward) {tag}")
    for r in rows:
        log(f"int8 (c):   {r['kind']:15s} {str(r['input']):20s} {str(r['weight']):18s} "
            f"x{r['calls_per_forward']}  bf16 {r['bf16_us']:9.2f}  int8 {r['int8_us']:9.2f}  "
            f"{r['int8_over_bf16']:6.2f}x  {r['winner']}")
    summary = int8_variants_probe.summary(rows)
    log(f"int8 (c): {json.dumps(summary)}; {time.perf_counter() - start:.1f} s into phase 18 "
        f"{tag}")

    # (d) the int8 frontalize program: frontalize_entry's, the generator stage int8
    cfg16 = make_config({"compute_dtype": "bfloat16"})
    det = build_detector(cfg16, dev, seed=0)
    gen16 = build_generator(cfg16, dev, seed=0)
    images = torch.as_tensor(frames(BATCH, seed=0), device=dev)
    zf = torch.as_tensor(np.random.RandomState(1).standard_normal((BATCH, 64)).astype(np.float32),
                         device=dev)
    lm5 = detect_lm5(det.eval(), images, detector_size=DETECTOR_SIZE)[0]
    scales16 = quant.calibrate_synthesis(cfg16, gen16, [preprocess_for_synthesis_lm5(images, lm5)])
    opts = dict(detector_size=DETECTOR_SIZE, quant_scales=scales16)
    eager = make_frontalize_fn(cfg16, det, gen16, **opts)
    kernels.reset_launch_counts()
    fouts = [eager(images, zf) for _ in range(FRONT_REQUESTS)]
    torch.cuda.synchronize()
    front_launches = kernels.launch_counts()
    if front_launches != {**dict.fromkeys(front_launches, 0), "fuse_parts": 3 * FRONT_REQUESTS}:
        raise AssertionError(f"int8 frontalize launches {front_launches}")
    graphed = make_graphed_frontalize_fn(cfg16, det, gen16, **opts)
    graphed(torch.as_tensor(frames(BATCH, seed=9), device=dev), zf)  # the capture
    if not all(torch.equal(g, w) for g, w in zip(graphed(images, zf), fouts[0])):
        raise AssertionError("int8 frontalize: graphed differs from eager")
    rate = BATCH / time_calls(graphed, (images, zf), FRONT_TIMED)
    med, hi, hi_name = latencies(graphed, (images[:1], zf[:1]), FRONT_LATENCY)
    g17 = front_rates["graphed"]
    log(f"int8 (d): frontalize_entry's program with the int8 generator: {FRONT_REQUESTS} eager "
        f"requests, launches {front_launches}; graphed == eager; graphed {rate:.1f} images/s at "
        f"batch {BATCH}, batch 1 latency median {med:.2f} ms {hi_name} {hi:.2f} ms (bf16, "
        f"phase 17: {g17[0]:.1f} images/s, {g17[1]:.2f} / {g17[2]:.2f} ms); "
        f"{time.perf_counter() - start:.1f} s into phase 18 {tag}")
    launches = {k: launches[k] + front_launches[k] for k in launches}
    del eager, graphed, fouts, gen16

    # (e) export: synthesis (f32, int8) and frontalize (int8); the bf16-stored
    # and f32 frontalize artifacts are held on the CPU (tests/test_torch_serving.py)
    _f32_exact(True)
    gen32 = gens[dev]
    req, zq = synthesis_request(dev, BATCH, 4)
    checked = []

    def fuse_equal(*parts):
        got = kernels.fuse_parts(*parts)
        checked.append(torch.equal(got, kernels.fuse_parts_plain(*parts)))
        return got

    with mock.patch.object(generator_module, "fuse_parts", fuse_equal):
        live32 = make_synthesize_fn(cfg32, gen32)(req, zq)
    if checked != [True] * 3:
        raise AssertionError(f"int8 (e): K1 against the plain fuse of the f32 synthesis {checked}")
    scales32 = quant.calibrate_synthesis(cfg32, gen32, [bench.bench_batch(16, dev)])
    lives = {"f32": live32, "int8": make_int8_synthesize_fn(cfg32, gen32, scales32)(req, zq)}
    root = tempfile.mkdtemp(prefix="tpgan_export_")
    report = []
    try:
        for name, kw in (("f32", {}), ("int8", {"quant_scales": scales32})):
            path = os.path.join(root, f"synthesis_{name}.pt2")
            t0 = time.perf_counter()
            serving.export_synthesis(cfg32, gen32, path, batch=BATCH, **kw)
            t_export = time.perf_counter() - t0
            out = serving.load_synthesis(path)(req, zq)
            err = float((out.float() - lives[name].float()).abs().max())
            scale = float(lives[name].float().abs().max())
            if err > EXPORT_TOL * scale:
                raise AssertionError(f"int8 (e): the {name} synthesis artifact is {err} off the "
                                     f"live program (max {scale})")
            report.append(f"synthesis {name}: {os.path.getsize(path) / 2**20:.1f} MiB, export "
                          f"{t_export:.1f} s, max|artifact - live| {err:.2e} of max {scale:.3f}")
        path = os.path.join(root, "frontalize_int8.pt2")
        live = make_frontalize_fn(cfg32, det, gen32, detector_size=DETECTOR_SIZE,
                                  quant_scales=scales32)(images, zf)
        t0 = time.perf_counter()
        serving.export_frontalize(cfg32, det, gen32, path, batch=BATCH,
                                  input_hw=tuple(images.shape[1:3]),
                                  detector_size=DETECTOR_SIZE, quant_scales=scales32)
        t_export = time.perf_counter() - t0
        fake, lm5_a, _scores = serving.load_synthesis(path)(images, zf)
        err = float((fake - live[0]).abs().max())
        lm_err = float((lm5_a - live[1]).abs().max())
        if err > EXPORT_TOL * float(live[0].abs().max()) or lm_err > 1e-4:
            raise AssertionError(f"int8 (e): the int8 frontalize artifact: face {err}, "
                                 f"lm5 {lm_err} px off the live program")
        report.append(f"frontalize int8 ({images.shape[1]}x{images.shape[2]} uint8 "
                      f"frames): {os.path.getsize(path) / 2**20:.1f} MiB, export "
                      f"{t_export:.1f} s, face {err:.2e}, lm5 {lm_err:.2e} px")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if gen32.plain_fuse or not all(p.requires_grad for p in gen32.parameters()):
        raise AssertionError("int8 (e): an export changed the caller's generator")
    log(f"int8 (e): {'; '.join(report)}; K1 == plain fuse on the f32 synthesis's three fuses "
        f"(the artifacts' fuse is the plain one); the exported generator untouched {tag}")
    _f32_exact(False)
    gen_aot = build_generator(cfg16, dev, seed=0)
    t0 = time.perf_counter()
    aot = serving.aot_compile_synthesis(cfg16, gen_aot, batch=BATCH)
    torch.cuda.synchronize()
    t_aot = time.perf_counter() - t0
    t0 = time.perf_counter()
    aot(req, zq)
    torch.cuda.synchronize()
    first_aot = (time.perf_counter() - t0) * 1e3
    fresh = make_synthesize_fn(cfg16, build_generator(cfg16, dev, seed=1))
    t0 = time.perf_counter()
    fresh(req, zq)
    torch.cuda.synchronize()
    first_eager = (time.perf_counter() - t0) * 1e3
    log(f"int8 (e): aot_compile_synthesis at batch {BATCH}: {t_aot:.2f} s ahead, then a first "
        f"request of {first_aot:.2f} ms, against make_synthesize_fn's first request "
        f"{first_eager:.2f} ms (bf16; the process has run cuDNN's shapes before); phase 18 took "
        f"{time.perf_counter() - start:.1f} s {tag}")
    del aot, fresh, gen_aot, gens, det
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _cli(argv, what, walls):
    """``python -m tpgan_tpu_torch <argv>`` in this process (``cli.main``,
    so the wrappers' counts are read here): its stdout's lines, its wall
    time (set-up included) under ``walls[what]``; fails unless it returns
    0."""
    import io

    from tpgan_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    walls[what] = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {what}: {argv} returned {rc}")
    return out.getvalue().strip().splitlines()


def _counted(fn, totals, want, what):
    """``fn()`` with the wrappers' counts set to 0 just before and read just
    after; they must equal ``want``, and they add to ``totals``."""
    import torch

    from tpgan_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    if launches != {**dict.fromkeys(launches, 0), **want}:
        raise AssertionError(f"cli {what}: launches {launches}, expected {want}")
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    return result


def run_cli(dev, tag):
    """Phase 19: the command line, ``tpgan_tpu_torch.cli.main`` in this
    process at full width (fm 1.0): synth-data; train (bf16, batch 16,
    from ``--packed --device-data``) eager and then with
    ``--steps-per-dispatch 2``; synthesize, eval, pretrain, frontalize and
    an f32 export from the checkpoints those runs wrote; then
    ``python3 -m tpgan_tpu_torch synthesize`` in a fresh process, and one
    with ``CUDA_VISIBLE_DEVICES=`` (exit 3). Returns the wrappers'
    launches of the in-process runs."""
    import argparse

    import numpy as np
    import torch

    from tpgan_tpu_torch import cli, serving
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.imageio import read_png, write_jpeg, write_png
    from tpgan_tpu_torch.data.synthetic_faces import (
        ALL_CAMERA_YAWS,
        landmarks68_string,
        render_face,
    )
    from tpgan_tpu_torch.train.checkpoint import latest_step
    from tpgan_tpu_torch.train.gan_trainer import GRAPH_WARMUP_CALLS, make_synthesize_fn

    start = time.perf_counter()
    walls, totals, notes = {}, {}, []
    device = ["--device", str(dev)]
    with tempfile.TemporaryDirectory() as root:
        # 1. the procedural protocols, rendered and packed (host only)
        line = _cli(["synth-data", "--out", root, "--protocol", "both", "--subjects",
                     str(CLI_SUBJECTS), "--pretrain-images", str(CLI_PRETRAIN_IMAGES), "--pack"],
                    "synth-data", walls)
        data = json.loads(line[-1])
        if data["gan_train_items"] != 8 * CLI_SUBJECTS:
            raise AssertionError(f"cli synth-data: {data}")

        # 2. train, full width, bf16, batch 16, from the pack in device memory
        runs = {}
        for name, k in (("eager", 1), ("graphed", CLI_DISPATCH)):
            ck, logs = os.path.join(root, f"ck_{name}"), os.path.join(root, f"logs_{name}")
            argv = ["train", "--packed", data["gan_packed"], "--device-data", "--steps",
                    str(CLI_TRAIN_STEPS), "--steps-per-dispatch", str(k), "--checkpoint", ck,
                    "--log-dir", logs, "--set", f"train.batch_size={TRAIN_BATCH}",
                    "--set", "train.yaw_weight_gamma=1.0", *device]
            steps = CLI_TRAIN_STEPS if k == 1 else GRAPH_WARMUP_CALLS  # eager ones
            _counted(lambda: _cli(argv, f"train {name}", walls), totals,
                     {n: v * steps for n, v in PER_STEP.items() if v}, f"train {name}")
            with open(os.path.join(logs, "metrics.jsonl")) as f:
                rows = [json.loads(r) for r in f]
            bad = [(r["step"], m) for r in rows for m, v in r.items() if not np.isfinite(v)]
            if latest_step(ck) != CLI_TRAIN_STEPS or [r["step"] for r in rows] != [10, 20] \
                    or bad:
                raise AssertionError(f"cli train {name}: checkpoint {latest_step(ck)}, metrics "
                                     f"at {[r['step'] for r in rows]}, non-finite {bad}")
            runs[name] = rows[-1]["imgs_per_sec"]
        ck = os.path.join(root, "ck_eager")

        # 3. synthesize from that checkpoint
        img, lm5 = render_face(3, ALL_CAMERA_YAWS["140"], 200)
        probe, probe_jpg = os.path.join(root, "probe.png"), os.path.join(root, "probe_q92.jpg")
        write_png(probe, img)
        write_jpeg(probe_jpg, img, quality=92)
        with open(os.path.join(root, "lm.txt"), "w") as f:
            f.write(landmarks68_string(lm5))
        synth_args = ["synthesize", "--image", probe, "--landmarks",
                      os.path.join(root, "lm.txt"), "--checkpoint", ck]
        out_png = os.path.join(root, "frontal.png")
        _counted(lambda: _cli([*synth_args, "--output", out_png, *device], "synthesize", walls),
                 totals, {"fuse_parts": 3}, "synthesize")
        face = read_png(out_png)
        if face.shape != (128, 128, 3) or face.dtype != np.uint8 or face.std() == 0:
            raise AssertionError(f"cli synthesize: {face.shape} {face.dtype}")

        # 4. eval on the rendered list
        batches = -(-data["gan_train_items"] // TRAIN_BATCH)
        line = _counted(lambda: _cli(["eval", "--img-list", data["gan_img_list"], "--checkpoint",
                                      ck, "--batch-size", str(TRAIN_BATCH), *device],
                                     "eval", walls),
                        totals, {"fuse_parts": 3 * batches}, "eval")
        scores = json.loads(line[-1])
        if not (np.isfinite(scores["psnr"]) and -1 <= scores["ssim"] <= 1
                and scores["num_images"] == data["gan_train_items"]
                and len(scores["per_camera"]) == 8):
            raise AssertionError(f"cli eval: {scores}")
        notes.append(f"eval psnr {scores['psnr']:.3f} ssim {scores['ssim']:.4f} over "
                     f"{scores['num_images']} items")

        # 5. a short pretrain from the rendered CelebA layout, in device memory
        det = os.path.join(root, "det")
        _counted(lambda: _cli(["pretrain", "--device-data", "--checkpoint", det,
                               "--set", f"pretrain.data_root_dir={data['pretrain_root']}",
                               "--set", f"pretrain.log_root_dir={os.path.join(root, 'dlogs')}",
                               "--set", f"pretrain.batch_size={CLI_PRETRAIN_BATCH}",
                               "--set", "pretrain.num_epochs=1",
                               "--set", "pretrain.train_data_ratio=0.8",
                               "--set", "pretrain.validation_data_ratio=0.1",
                               "--set", "pretrain.log_step_of_batchs=2", *device],
                              "pretrain", walls),
                 totals, {}, "pretrain")
        if not latest_step(det):
            raise AssertionError("cli pretrain wrote no checkpoint")

        # 6. frontalize with both checkpoints, a PNG and a JPEG frame
        front = os.path.join(root, "front")
        line = _counted(lambda: _cli(["frontalize", "--image", probe, "--image", probe_jpg,
                                      "--detector-checkpoint", det, "--checkpoint", ck,
                                      "--output", front, *device], "frontalize", walls),
                        totals, {"fuse_parts": 6}, "frontalize")
        names = ["probe_frontal.png", "probe_q92_frontal.png"]
        shapes = [read_png(os.path.join(front, n)).shape for n in names]
        if len(line) != 2 or shapes != [(128, 128, 3)] * 2 or sorted(os.listdir(front)) != names:
            raise AssertionError(f"cli frontalize: {line}, {os.listdir(front)}")
        notes.append(f"frontalize: {line[0].split(': ', 1)[1]}")

        # 7. an f32 export that loads back equal to the live program
        pt2 = os.path.join(root, "synthesis.pt2")
        f32 = ["--set", "compute_dtype=float32"]
        _f32_exact(True)
        _counted(lambda: _cli(["export", "--checkpoint", ck, "--batch", "2", "--output", pt2,
                               *f32, *device], "export", walls), totals, {}, "export")
        cfg = make_config({"compute_dtype": "float32"})
        live = make_synthesize_fn(cfg, cli.eval_generator(
            cfg, argparse.Namespace(checkpoint=ck, g_weights="auto"), dev))
        batch, z = serving.example_inputs(cfg, 2, dev)
        gen = torch.Generator(device=dev).manual_seed(7)
        batch = {k: torch.rand(v.shape, generator=gen, device=dev) * 2 - 1
                 for k, v in batch.items()}
        z = torch.randn(z.shape, generator=gen, device=dev)
        want, got = live(batch, z), serving.load_synthesis(pt2)(batch, z)
        torch.cuda.synchronize()
        diff = float((got - want).abs().max())
        _f32_exact(False)
        if not diff <= EXPORT_TOL * float(want.abs().max()):
            raise AssertionError(f"cli export: the artifact is {diff} off the live program")
        notes.append(f"export f32 {os.path.getsize(pt2) / 2**20:.1f} MiB, loaded back "
                     f"max|diff| {diff:.2e} against the live program")
        del live, want, got

        # a fresh process: python3 -m tpgan_tpu_torch, cold
        here = os.path.dirname(os.path.abspath(__file__))
        sub_png = os.path.join(root, "sub.png")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tpgan_tpu_torch", *synth_args, "--output",
                               sub_png], cwd=here, capture_output=True, text=True, timeout=300)
        walls["python3 -m synthesize (fresh process)"] = time.perf_counter() - t0
        if proc.returncode != 0 or proc.stdout.strip() != f"wrote {sub_png}":
            raise AssertionError(f"python3 -m tpgan_tpu_torch synthesize: rc {proc.returncode}, "
                                 f"{proc.stdout[-500:]} {proc.stderr[-2000:]}")
        sub = read_png(sub_png).astype(int)
        gap = int(np.abs(sub - face.astype(int)).max())
        if gap > BF16_REL_DIFF * 255:
            raise AssertionError(f"python3 -m synthesize is {gap} levels off the in-process one")
        notes.append(f"python3 -m synthesize {gap} levels from the in-process PNG")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "tpgan_tpu_torch", "eval", "--img-list",
                               data["gan_img_list"]], cwd=here, capture_output=True, text=True,
                              timeout=120, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        walls["python3 -m eval, CUDA_VISIBLE_DEVICES= (exit 3)"] = time.perf_counter() - t0
        if proc.returncode != 3 or "tpgan_tpu_torch eval: no CUDA device" not in proc.stderr:
            raise AssertionError(f"without a visible card: rc {proc.returncode}, "
                                 f"{proc.stderr[-500:]}")
    gc.collect()
    torch.cuda.empty_cache()
    log(f"cli: train full size bf16 batch {TRAIN_BATCH} from --packed --device-data, "
        f"imgs_per_sec of steps 11-{CLI_TRAIN_STEPS}: eager {runs['eager']:.1f}, "
        f"--steps-per-dispatch {CLI_DISPATCH} (graph replays) {runs['graphed']:.1f}; "
        f"{'; '.join(notes)} {tag}")
    log("cli: wall per subcommand (in this process, set-up and checkpoint reads and writes "
        "included; the fresh process imports, builds and restores too): " + ", ".join(
            f"{k} {v:.1f} s" for k, v in walls.items()))
    log(f"cli: wrapper launches {totals}; phase 19 took {time.perf_counter() - start:.1f} s "
        f"{tag}")
    return {k: totals.get(k, 0) for k in PER_STEP}


# --------------------------------------------------------------------------
# phase 20: scale-out, the data axis (parallel/, the synced BatchNorm,
# run_gan_training(mesh=)). NCCL takes one rank per card, so on one card
# the two-rank runs are gloo's (host-staged collectives): they run the
# real path in each rank, and no rate of theirs is a data-parallel rate.


def _scale_rank(rank, n):
    """A rank of phase 20 (b), in one spawned process: the detector's step
    (``_detector_step_params``) in f32, then the GAN steps
    (``_scale_gan_steps``) as bf16 asks."""
    import torch

    from tpgan_tpu_torch.config import MeshConfig
    from tpgan_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MeshConfig(data=n))
    _f32_exact(True)
    detector = _detector_step_params(torch.device("cuda"), mesh)
    _f32_exact(False)
    gc.collect()
    torch.cuda.empty_cache()
    return detector, _scale_gan_steps(rank, mesh)


def _detector_step_params(dev, mesh):
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_pretrain_batch
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    cfg = make_config({})
    state, model, opt = create_pretrain_state(cfg, seed=0, device=dev)
    step = make_pretrain_step(cfg, model, opt, mesh=mesh)
    batch = synthetic_pretrain_batch(DETECTOR_BATCH, DETECTOR_SIZE, seed=0)
    rows = slice(None) if mesh is None else mesh.rows(DETECTOR_BATCH)
    gen = torch.Generator(device=dev).manual_seed(0)
    _state, metrics = step(state, batch["image"][rows], batch["label"][rows], gen)
    return ({k: float(v) for k, v in metrics.items()},
            {k: p.detach().cpu().numpy() for k, p in model.named_parameters()})


def _scale_gan_steps(rank, mesh):
    """The full-size bf16 GAN step on ``mesh``, this rank's 8 rows of a
    global batch of 16, SCALE_GAN_STEPS steps. Returns the metrics, the
    wrappers' launches of the steps (counts set to 0 just before) and the
    ms per step (host-staged gloo collectives included)."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.parallel import place, replicated
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

    dev = torch.device("cuda")
    cfg = make_config({"compute_dtype": "bfloat16"})
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
    place(state, replicated(mesh))
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    batch = synthetic_gan_batch(TRAIN_BATCH, seed=0, num_classes=cfg.G.num_classes)
    batch = {k: torch.as_tensor(v[mesh.rows(TRAIN_BATCH)], device=dev) for k, v in batch.items()}
    generator = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(SCALE_GAN_STEPS):
        state, metrics = step(state, batch, generator)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / SCALE_GAN_STEPS
    launches = kernels.launch_counts()
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"rank {rank}: metrics {metrics}")
    return {"metrics": metrics, "launches": launches, "ms": ms,
            "rows": mesh.rows(TRAIN_BATCH).start}


def _state_gap_ulps(a, b):
    """The largest |a - b| over the leaves of two GAN states, in ulps of
    each leaf's largest |value| in ``b``: {name: ulps}, its worst first."""
    import torch

    def leaves(s):
        out = {f"gen.{k}": v for k, v in s.gen.state_dict().items()}
        out.update({f"disc.{k}": v for k, v in s.disc.state_dict().items()})
        out.update({f"ema.{k}": v for k, v in s.g_ema_params.items()})
        return out

    la, lb = leaves(a), leaves(b)
    gaps = {}
    for name, want in lb.items():
        if not want.is_floating_point():
            if not torch.equal(la[name], want):
                raise AssertionError(f"{name} differs: {la[name]} vs {want}")
            continue
        scale = float(want.abs().max())
        ulp = float(torch.finfo(want.dtype).eps) * max(scale, float(torch.finfo(want.dtype).tiny))
        gaps[name] = float((la[name].float() - want.float()).abs().max()) / ulp
    return dict(sorted(gaps.items(), key=lambda kv: -kv[1]))


def _allreduce_device_ms(fn, iters):
    """(device ms per call of the NCCL kernels in a profile of ``fn``, their
    names); (None, []) when the profiler recorded no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not device:
        return None, []
    nccl = [e for e in device if "nccl" in e.name.lower()]
    return (sum(e.time_range.elapsed_us() for e in nccl) / iters / 1e3,
            sorted({e.name[:60] for e in nccl}))


def scale_out_nccl(dev, tag):
    """Phase 20 (a): a world of one over NCCL in this process, full size,
    bf16, batch 16. ``run_gan_training`` for SCALE_EAGER_STEPS eager steps
    and for one dispatch of K = 2 graphed steps (the NCCL all-reduces
    captured), each with ``mesh=make_mesh(...)`` and without, from the same
    seeded state (deterministic cuDNN): the states within
    SCALE_STATE_ULPS of each leaf's largest. Then ms per step with and
    without the mesh, in turns, and the all-reduce's device time from a
    profile. Returns the wrappers' launches of the mesh runs."""
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.ops import kernels
    from tpgan_tpu_torch.parallel import make_mesh
    from tpgan_tpu_torch.parallel.distributed import free_port, maybe_initialize, shutdown
    from tpgan_tpu_torch.train.gan_trainer import (
        GRAPH_WARMUP_CALLS,
        create_gan_state,
        make_gan_train_step,
    )
    from tpgan_tpu_torch.train.loop import run_gan_training

    cfg = make_config({"compute_dtype": "bfloat16", "train": {"batch_size": TRAIN_BATCH}})
    batches = [synthetic_gan_batch(TRAIN_BATCH, seed=600 + i, num_classes=cfg.G.num_classes)
               for i in range(4)]
    totals = dict.fromkeys(PER_STEP, 0)
    runs = {}  # (K, with the mesh) -> the final state

    def run(k, mesh):
        steps = SCALE_EAGER_STEPS if k == 1 else k
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        runs[k, mesh is not None] = run_gan_training(cfg, iter(batches), steps=steps,
                                                     steps_per_dispatch=k, device=dev, mesh=mesh)
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        want = {n: v * (steps if k == 1 else GRAPH_WARMUP_CALLS) for n, v in PER_STEP.items()}
        if launches != want:
            raise AssertionError(f"scale-out (a) K={k} mesh={mesh}: launches {launches}, "
                                 f"expected {want}")
        if mesh is not None:
            for n, v in launches.items():
                totals[n] += v

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    for k in (1, 2):  # without a process group: no mesh at all
        run(k, None)
    maybe_initialize(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl",
                     device_index=dev.index or 0, timeout_s=300)
    try:
        mesh = make_mesh(cfg.mesh)
        if mesh.shape != {"data": 1, "model": 1} or mesh.backend != "nccl":
            raise AssertionError(f"scale-out (a): mesh {mesh}")
        worst = {}
        for k in (1, 2):
            run(k, mesh)
            gaps = _state_gap_ulps(runs[k, True], runs[k, False])
            worst[k] = next(iter(gaps.items()))
            if worst[k][1] > SCALE_STATE_ULPS:
                raise AssertionError(f"scale-out (a) K={k}: the mesh run's state is "
                                     f"{list(gaps.items())[:4]} ulps of each leaf's largest "
                                     f"off the plain run's (bar {SCALE_STATE_ULPS})")
        runs.clear()
        torch.backends.cudnn.deterministic = False

        gc.collect()
        torch.cuda.empty_cache()
        state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
        steps = {"plain": make_gan_train_step(cfg, gen, disc, g_opt, d_opt),
                 "mesh": make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)}
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batches[0].items()}
        generator = torch.Generator(device=dev).manual_seed(0)
        box = [state]

        def step_once(name):
            box[0], _m = steps[name](box[0], batch, generator)

        for name in steps:
            step_once(name)
        times = {name: [] for name in steps}
        for name in ("plain", "mesh", "mesh", "plain"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SCALE_TIMED_STEPS):
                step_once(name)
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3 / SCALE_TIMED_STEPS)
        ar_ms, ar_names = _allreduce_device_ms(lambda: step_once("mesh"), 2)
        del steps, box, state, gen, disc, g_opt, d_opt
    finally:
        shutdown()
    log(f"scale-out (a): world of 1 over NCCL, full size bf16 batch {TRAIN_BATCH}: "
        f"run_gan_training with mesh=make_mesh(...) against without, from the same seeded "
        f"state (deterministic cuDNN): {SCALE_EAGER_STEPS} eager steps, worst leaf "
        f"{worst[1][0]} {worst[1][1]:.2f} ulps of its largest; K=2 graphed (the NCCL "
        f"all-reduces captured), worst {worst[2][0]} {worst[2][1]:.2f} ulps (bar "
        f"{SCALE_STATE_ULPS}) {tag}")
    log(f"scale-out (a): eager step, {SCALE_TIMED_STEPS} steps per turn, turns plain, mesh, "
        f"mesh, plain: without the mesh {[round(t, 2) for t in times['plain']]} ms/step, with "
        f"the mesh {[round(t, 2) for t in times['mesh']]} ms/step; all-reduce device time "
        + (f"{ar_ms:.4f} ms/step in NCCL kernels {ar_names}" if ar_names else
           "0: no NCCL kernel ran in the profiled steps (one rank's all-reduce launches none)"
           if ar_ms is not None else "not measured (the profiler recorded no device time)")
        + f" {tag}")
    return totals, {"plain_ms": statistics.median(times["plain"]),
                    "mesh_ms": statistics.median(times["mesh"]), "allreduce_ms": ar_ms}


def scale_out_gloo(dev, tag):
    """Phase 20 (b): two ranks over gloo on this one card. JAX's dryrun
    for two devices (``entry.dryrun_multichip(2, backend="gloo")``, whose
    layout is JAX's ``{data: 1, model: 2}``: the fm 0.25 f32 step against
    one process, the full-size synthesis under tp); the data axis's
    detector f32 pretrain step (synced BatchNorm) at 256,
    2 x 32 rows, against one process at 64; the full-size bf16 GAN step,
    2 x 8 rows, SCALE_GAN_STEPS steps, each rank's K1, K1 backward, K2
    and K2 backward launches. Returns the launches of both ranks' GAN
    steps."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.entry import dryrun_multichip
    from tpgan_tpu_torch.parallel.distributed import spawn

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = dryrun_multichip(2, backend="gloo")
    worst = max(abs(dry["metrics"][k] - v) / (1e-3 + 1e-3 * abs(v))
                for k, v in dry["single"].items())
    log(f"scale-out (b): dryrun_multichip(2, backend='gloo') on the card, JAX's layout "
        f"{dry['mesh']}: fm 0.25 f32 step at batch 4 against one process, worst metric at "
        f"{worst:.3f} of the bar 1e-3 + 1e-3|ref|; full-size f32 synthesis under tp max|delta| "
        f"{dry['synthesis_max_abs_delta']:.2e} (bar 5e-4); {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ranks = spawn(_scale_rank, 2, backend="gloo", device="cuda", args=(2,), timeout_s=600)
    gan = [r[1] for r in ranks]
    ranks = [r[0] for r in ranks]
    _f32_exact(True)
    start_params = {k: p.detach().cpu().numpy() for k, p in
                    _fresh_detector_params(dev).items()}
    single, params = _detector_step_params(dev, None)
    _f32_exact(False)
    for r in ranks[1:]:
        if r[0] != ranks[0][0]:
            raise AssertionError(f"scale-out (b) detector: ranks disagree {r[0]} {ranks[0][0]}")
    move = lambda p: np.concatenate([(p[k] - start_params[k]).ravel() for k in start_params])
    gap = float(np.linalg.norm(move(ranks[0][1]) - move(params)) / np.linalg.norm(move(params)))
    loss_gap = abs(ranks[0][0]["loss"] - single["loss"]) / abs(single["loss"])
    if gap > SCALE_DETECTOR_MOVE_REL_L2 or loss_gap > SCALE_DETECTOR_LOSS_RTOL:
        raise AssertionError(f"scale-out (b) detector: 2 x 32 rows against one process at 64: "
                             f"movement {gap:.3e} (bar {SCALE_DETECTOR_MOVE_REL_L2}), loss "
                             f"{loss_gap:.3e} (bar {SCALE_DETECTOR_LOSS_RTOL})")
    log(f"scale-out (b): detector f32 pretrain step at {DETECTOR_SIZE}, synced BatchNorm, 2 x "
        f"{DETECTOR_BATCH // 2} rows over gloo against one process at {DETECTOR_BATCH}: loss "
        f"{ranks[0][0]['loss']:.6f} vs {single['loss']:.6f} ({loss_gap:.2e} of it), parameter "
        f"movement {gap:.3e} in relative L2 (bar {SCALE_DETECTOR_MOVE_REL_L2}); the ranks' "
        f"process (this and the GAN steps below) {time.perf_counter() - t0:.1f} s")

    ranks = gan
    want = {n: v * SCALE_GAN_STEPS for n, v in PER_STEP.items()}
    for r, out in enumerate(ranks):
        if out["launches"] != want:
            raise AssertionError(f"scale-out (b) GAN rank {r}: launches {out['launches']}, "
                                 f"expected {want}")
    if ranks[0]["metrics"] != ranks[1]["metrics"]:
        raise AssertionError(f"scale-out (b) GAN: the ranks' global metrics differ "
                             f"{ranks[0]['metrics']} {ranks[1]['metrics']}")
    log(f"scale-out (b): full-size bf16 GAN step, 2 ranks x {TRAIN_BATCH // 2} rows over gloo "
        f"on one card (host-staged collectives: not a data-parallel rate): "
        f"{[round(r['ms'], 1) for r in ranks]} ms/step over {SCALE_GAN_STEPS} steps; g_loss "
        f"{ranks[0]['metrics']['g_loss']:.4f}; launches per rank "
        f"{[{n: v for n, v in r['launches'].items() if v} for r in ranks]} {tag}")
    return {n: sum(r["launches"][n] for r in ranks) for n in PER_STEP}


def _fresh_detector_params(dev):
    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.train.pretrain import build_detector

    return dict(build_detector(make_config({}), dev, seed=0).named_parameters())


def scale_out_torchrun(dev, tag):
    """Phase 20 (c): ``python3 -m torch.distributed.run --standalone
    --nproc-per-node 1 -m tpgan_tpu_torch train --set mesh.data=1`` in a
    fresh interpreter (full size, bf16, batch 16, from a packed protocol
    in device memory), then ``mesh.data=2`` on that world of one, which
    must exit non-zero with make_mesh's message."""
    from tpgan_tpu_torch.train.checkpoint import latest_step

    here = os.path.dirname(os.path.abspath(__file__))
    walls = {}
    with tempfile.TemporaryDirectory() as root:
        line = _cli(["synth-data", "--out", root, "--protocol", "gan", "--subjects",
                     str(SCALE_SUBJECTS), "--pack"], "synth-data", walls)
        packed = json.loads(line[-1])["gan_packed"]
        runs = {}
        for data in (1, 2):
            ck = os.path.join(root, f"ck{data}")
            argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                    "--nproc-per-node", "1", "-m", "tpgan_tpu_torch", "train", "--packed", packed,
                    "--device-data", "--steps", "2", "--checkpoint", ck, "--log-dir",
                    os.path.join(root, f"logs{data}"), "--set", f"mesh.data={data}",
                    "--set", f"train.batch_size={TRAIN_BATCH}"]
            t0 = time.perf_counter()
            proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=300)
            runs[data] = (proc, time.perf_counter() - t0, latest_step(ck))
    ok, wall, step = runs[1]
    if ok.returncode != 0 or step != 2:
        raise AssertionError(f"torchrun train mesh.data=1: rc {ok.returncode}, checkpoint {step}: "
                             f"{ok.stdout[-1000:]} {ok.stderr[-3000:]}")
    bad, bad_wall, bad_step = runs[2]
    if bad.returncode == 0 or "mesh 2x1 does not cover 1 devices" not in bad.stderr \
            or bad_step is not None:
        raise AssertionError(f"torchrun train mesh.data=2 on a world of one: rc "
                             f"{bad.returncode}, checkpoint {bad_step}: {bad.stderr[-3000:]}")
    log(f"scale-out (c): torchrun --nproc-per-node 1 -m tpgan_tpu_torch train --set "
        f"mesh.data=1: 2 full-size bf16 steps at batch {TRAIN_BATCH}, checkpoint 2, "
        f"{wall:.1f} s in a fresh interpreter; mesh.data=2 on that world of one: rc "
        f"{bad.returncode} with make_mesh's 'mesh 2x1 does not cover 1 devices' "
        f"({bad_wall:.1f} s) {tag}")


def run_scale_out(dev, tag):
    """Phase 20: (a) a world of one over NCCL, (b) two ranks over gloo on
    this card, (c) torchrun in a fresh interpreter; (d) every process the
    phase started has exited (``spawn`` joins its ranks, the torchrun
    processes are waited for). Returns (the wrappers' launches of (a)'s
    mesh runs, of (b)'s two GAN ranks, (a)'s timings)."""
    from tpgan_tpu_torch.data.pipeline import stop_worker_server

    start = time.perf_counter()
    before = set(children())
    nccl_launches, timings = scale_out_nccl(dev, tag)
    gloo_launches = scale_out_gloo(dev, tag)
    scale_out_torchrun(dev, tag)
    # the resource tracker the spawned ranks' queue started (multiprocessing
    # stops it only when this process exits)
    stop_worker_server()
    left = {pid: c for pid, c in children().items() if pid not in before and c[0] != "Z"}
    if left:
        raise AssertionError(f"scale-out: processes left running {left}")
    log(f"scale-out: phase 20 took {time.perf_counter() - start:.1f} s")
    return nccl_launches, gloo_launches, timings


# --------------------------------------------------------------------------
# phase 21: the model axis (parallel/tensor_parallel.py). NCCL takes one
# rank per card, so on one card the ranks are gloo's: the gathers and sums
# go through the host, and no rate of theirs is a tensor-parallel rate.


def _tp_gan_state(dev, mesh, compute_dtype="bfloat16"):
    """The full-size GAN state (seed 0) in ``compute_dtype``, its step and
    the batch of 16 (seed 0) on ``dev``; on a ``mesh``, placed by JAX's
    default rule."""
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_gan_batch
    from tpgan_tpu_torch.parallel import place, shard_gan_state
    from tpgan_tpu_torch.train.gan_trainer import create_gan_state, make_gan_train_step

    cfg = make_config({"compute_dtype": compute_dtype})
    state, gen, disc, g_opt, d_opt = create_gan_state(cfg, seed=0, device=dev)
    if mesh is not None:
        place(state, shard_gan_state(mesh, state))
    step = make_gan_train_step(cfg, gen, disc, g_opt, d_opt, mesh=mesh)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in
             synthetic_gan_batch(TRAIN_BATCH, seed=0, num_classes=cfg.G.num_classes).items()}
    return state, step, batch


def _gan_params(state):
    """{model.name: the parameter on the host, float32}."""
    return {f"{m}.{n}": p.detach().float().cpu() for m in ("gen", "disc")
            for n, p in getattr(state, m).named_parameters()}


def _params_opt_bytes(state):
    from tpgan_tpu_torch.parallel import per_device_bytes

    return per_device_bytes((list(state.gen.parameters()), list(state.disc.parameters()),
                             state.g_opt, state.d_opt))


def _tp_steps(state, step, batch, dev):
    """TP_GAN_STEPS steps (the generator seeded 0), timed: (metrics of the
    last, ms per step, the wrappers' launches, peak device bytes)."""
    import torch

    from tpgan_tpu_torch.ops import kernels

    generator = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TP_GAN_STEPS):
        state, metrics = step(state, batch, generator)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / TP_GAN_STEPS
    return ({k: float(v) for k, v in metrics.items()}, ms, kernels.launch_counts(),
            torch.cuda.max_memory_allocated())


def _movement_gap(got, start, want):
    """{model: the relative L2 distance between the parameters' movement
    from ``start`` in ``got`` and in ``want``} (host dicts of
    ``_gan_params``; the squares summed in float64)."""
    import numpy as np

    out = {}
    for model in ("gen", "disc"):
        num = den = 0.0
        for key in (k for k in start if k.startswith(model + ".")):
            a, b = got[key] - start[key], want[key] - start[key]
            num += float(((a - b).double() ** 2).sum())
            den += float((b.double() ** 2).sum())
        out[model] = float(np.sqrt(num / den))
    return out


def _tp_rank(rank, reference):
    """A rank of phase 21 (b) and (c), in one spawned process: the
    full-size bf16 GAN steps on {data: 1, model: 2} (the parameters
    gathered whole and held against one process's file ``reference``),
    then the detector's f32 step."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.config import MeshConfig
    from tpgan_tpu_torch.parallel import make_mesh, whole
    from tpgan_tpu_torch.parallel.tensor_parallel import sharded_layers

    dev = torch.device("cuda")
    mesh = make_mesh(MeshConfig(data=1, model=2))
    state, step, batch = _tp_gan_state(dev, mesh)
    kinds = [layer.tp.kind for m in (state.gen, state.disc) for _n, layer in sharded_layers(m)
             if layer.tp is not None]
    metrics, ms, launches, peak = _tp_steps(state, step, batch, dev)
    if not all(np.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"rank {rank}: metrics {metrics}")
    nbytes = _params_opt_bytes(state)
    with whole(state):
        got = _gan_params(state)
    ref = torch.load(reference, map_location="cpu", weights_only=True)
    gaps = _movement_gap(got, ref["start"], ref["end"])
    del ref, got, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    _f32_exact(True)
    detector = _tp_detector_step(dev, mesh)
    _f32_exact(False)
    return {"metrics": metrics, "ms": ms, "launches": launches, "peak": peak,
            "bytes": nbytes, "gaps": gaps, "detector": detector,
            "kinds": {k: kinds.count(k) for k in ("column", "row")}}


def _tp_detector_step(dev, mesh):
    """The detector's f32 step at 256 (phase 20's, batch DETECTOR_BATCH);
    on a mesh with a model axis, placed by JAX's default rule. Returns the
    metrics and the whole parameters after the step."""
    import torch

    from tpgan_tpu_torch.config import make_config
    from tpgan_tpu_torch.data.synthetic import synthetic_pretrain_batch
    from tpgan_tpu_torch.parallel import infer_param_shardings, place, whole
    from tpgan_tpu_torch.train.pretrain import create_pretrain_state, make_pretrain_step

    cfg = make_config({})
    state, model, opt = create_pretrain_state(cfg, seed=0, device=dev)
    if mesh is not None:
        place(state, infer_param_shardings(mesh, state))
    step = make_pretrain_step(cfg, model, opt, mesh=mesh)
    batch = synthetic_pretrain_batch(DETECTOR_BATCH, DETECTOR_SIZE, seed=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    _state, metrics = step(state, batch["image"], batch["label"], gen)
    with whole(model):
        params = {k: p.detach().cpu().numpy() for k, p in model.named_parameters()}
    return {k: float(v) for k, v in metrics.items()}, params


def tp_dryrun(dev, tag):
    """Phase 21 (a): ``entry.dryrun_multichip(4, backend="gloo")``."""
    import torch

    from tpgan_tpu_torch.entry import dryrun_multichip

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dry = dryrun_multichip(4, backend="gloo")
    if dry["mesh"] != {"data": 2, "model": 2}:
        raise AssertionError(f"model axis (a): dryrun_multichip(4) laid out {dry['mesh']}")
    worst = max(abs(dry["metrics"][k] - v) / (1e-3 + 1e-3 * abs(v))
                for k, v in dry["single"].items())
    log(f"model axis (a): dryrun_multichip(4, backend='gloo') on the card, mesh {dry['mesh']}: "
        f"fm 0.25 f32 step (min_shard_dim 64) at batch 8 against one process, worst metric at "
        f"{worst:.3f} of the bar 1e-3 + 1e-3|ref|; full-size f32 synthesis under dp+tp "
        f"max|delta| {dry['synthesis_max_abs_delta']:.2e} (bar 5e-4, TF32 off); params + Adam "
        f"per rank {[round(m, 2) for m in dry['params_opt_mib']]} MiB against "
        f"{dry['unsharded_params_opt_mib']:.2f} MiB in one process; "
        f"{time.perf_counter() - t0:.1f} s {tag}")
    return dry


def tp_ranks(dev, tag):
    """Phase 21 (b) and (c): one process's full-size bf16 steps (the
    reference, written to a file), then two gloo ranks on this card
    running the same steps on {data: 1, model: 2} and the detector's
    step; the detector's one-process step last. Returns the launches of
    both ranks' GAN steps."""
    import numpy as np
    import torch

    from tpgan_tpu_torch.parallel.distributed import spawn

    gc.collect()
    torch.cuda.empty_cache()
    state, step, batch = _tp_gan_state(dev, None)
    start = _gan_params(state)
    single_metrics, single_ms, single_launches, single_peak = _tp_steps(state, step, batch, dev)
    single_bytes = _params_opt_bytes(state)
    end = _gan_params(state)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    _f32_exact(True)  # the f32 twin: the bf16 run's own distance from f32
    state, step, batch = _tp_gan_state(dev, None, "float32")
    _tp_steps(state, step, batch, dev)
    floor = _movement_gap(_gan_params(state), start, end)
    _f32_exact(False)
    del state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        reference = os.path.join(root, "reference.pt")
        torch.save({"start": start, "end": end}, reference)
        del start, end
        ranks = spawn(_tp_rank, 2, backend="gloo", device="cuda", args=(reference,),
                      timeout_s=600)
    wall = time.perf_counter() - t0
    metric_gap = {k: abs(ranks[0]["metrics"][k] - v) / max(abs(v), 1e-12)
                  for k, v in single_metrics.items()}
    worst = max(metric_gap, key=metric_gap.get)
    log(f"model axis (b): full-size bf16 GAN step, batch {TRAIN_BATCH}, {{data: 1, model: 2}} "
        f"over gloo on one card (host-staged gathers and sums: not a tensor-parallel rate), "
        f"{ranks[0]['kinds']} sharded weights: {[round(r['ms'], 1) for r in ranks]} ms/step "
        f"against {single_ms:.1f} in one process, over {TP_GAN_STEPS} steps; g_loss "
        f"{ranks[0]['metrics']['g_loss']:.4f} vs {single_metrics['g_loss']:.4f} (worst metric "
        f"{worst} {metric_gap[worst]:.2e} of itself); parameter movement against one process's "
        f"{[{m: f'{g:.3e}' for m, g in r['gaps'].items()} for r in ranks]} in relative L2, one "
        f"process's bf16 run from its f32 twin {({m: f'{g:.3e}' for m, g in floor.items()})} "
        f"(bar {TP_NOISE_FACTOR}x); params + Adam per rank "
        f"{[round(r['bytes'] / 2**20, 1) for r in ranks]} MiB against "
        f"{single_bytes / 2**20:.1f} MiB ({ranks[0]['bytes'] / single_bytes:.3f}); peak "
        f"allocated per rank {[round(r['peak'] / 2**30, 2) for r in ranks]} GiB against "
        f"{single_peak / 2**30:.2f} GiB; launches per rank "
        f"{[{n: v for n, v in r['launches'].items() if v} for r in ranks]}; the ranks' "
        f"process {wall:.1f} s {tag}")
    want = {n: v * TP_GAN_STEPS for n, v in PER_STEP.items()}
    if single_launches != want:
        raise AssertionError(f"model axis (b): one process's launches {single_launches}")
    for r, out in enumerate(ranks):
        if out["launches"] != want:
            raise AssertionError(f"model axis (b) rank {r}: launches {out['launches']}, "
                                 f"expected {want}")
        if out["metrics"] != ranks[0]["metrics"]:
            raise AssertionError(f"model axis (b): the ranks' metrics differ {out['metrics']} "
                                 f"{ranks[0]['metrics']}")
        if any(out["gaps"][m] > TP_NOISE_FACTOR * floor[m] for m in floor):
            raise AssertionError(f"model axis (b) rank {r}: parameter movement {out['gaps']} off "
                                 f"one process's bf16 run in relative L2, more than "
                                 f"{TP_NOISE_FACTOR} x its distance from f32 {floor}")
        if out["bytes"] >= TP_BYTES_SHARE * single_bytes:
            raise AssertionError(f"model axis (b) rank {r}: {out['bytes']} bytes of parameters + "
                                 f"Adam against {single_bytes} in one process")

    _f32_exact(True)
    start_params = {k: p.detach().cpu().numpy() for k, p in
                    _fresh_detector_params(dev).items()}
    single, params = _tp_detector_step(dev, None)
    _f32_exact(False)
    move = lambda p: np.concatenate([(p[k] - start_params[k]).ravel() for k in start_params])
    gaps = [float(np.linalg.norm(move(out["detector"][1]) - move(params))
                  / np.linalg.norm(move(params))) for out in ranks]
    loss_gaps = [abs(out["detector"][0]["loss"] - single["loss"]) / abs(single["loss"])
                 for out in ranks]
    log(f"model axis (c): detector f32 pretrain step at {DETECTOR_SIZE}, batch "
        f"{DETECTOR_BATCH}, {{data: 1, model: 2}} over gloo against one process: loss "
        f"{ranks[0]['detector'][0]['loss']:.6f} vs {single['loss']:.6f} "
        f"({[f'{g:.2e}' for g in loss_gaps]} of it), parameter movement "
        f"{[f'{g:.3e}' for g in gaps]} in relative L2 (bar {SCALE_DETECTOR_MOVE_REL_L2}) {tag}")
    if max(gaps) > SCALE_DETECTOR_MOVE_REL_L2 or max(loss_gaps) > SCALE_DETECTOR_LOSS_RTOL:
        raise AssertionError(f"model axis (c) detector: movement {gaps} (bar "
                             f"{SCALE_DETECTOR_MOVE_REL_L2}), loss {loss_gaps} (bar "
                             f"{SCALE_DETECTOR_LOSS_RTOL})")
    return {n: sum(r["launches"][n] for r in ranks) for n in PER_STEP}


def tp_torchrun(dev, tag):
    """Phase 21 (d): ``python3 -m torch.distributed.run --standalone
    --nproc-per-node 1 -m tpgan_tpu_torch train --set mesh.model=2`` in a
    fresh interpreter: a world of one cannot hold a model axis of 2, and
    the run exits non-zero with make_mesh's message before any data."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as root:
        ck = os.path.join(root, "ck")
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1", "-m", "tpgan_tpu_torch", "train", "--steps", "1",
                "--checkpoint", ck, "--log-dir", os.path.join(root, "logs"),
                "--set", "mesh.model=2"]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=here, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        wrote = os.path.exists(ck)
    if proc.returncode == 0 or "1 devices not divisible by model=2" not in proc.stderr or wrote:
        raise AssertionError(f"torchrun train mesh.model=2 on a world of one: rc "
                             f"{proc.returncode}, checkpoint dir {wrote}: {proc.stderr[-3000:]}")
    log(f"model axis (d): torchrun --nproc-per-node 1 -m tpgan_tpu_torch train --set "
        f"mesh.model=2: rc {proc.returncode} with make_mesh's '1 devices not divisible by "
        f"model=2' ({wall:.1f} s) {tag}")


def run_model_axis(dev, tag):
    """Phase 21: (a) the dryrun on {data: 2, model: 2}, (b) + (c) two model
    ranks' full-size GAN steps and detector step, (d) the CLI's refusal
    under torchrun; (e) every process the phase started has exited.
    Returns the wrappers' launches of (b)'s two ranks."""
    from tpgan_tpu_torch.data.pipeline import stop_worker_server

    start = time.perf_counter()
    before = set(children())
    tp_dryrun(dev, tag)
    launches = tp_ranks(dev, tag)
    tp_torchrun(dev, tag)
    stop_worker_server()
    left = {pid: c for pid, c in children().items() if pid not in before and c[0] != "Z"}
    if left:
        raise AssertionError(f"model axis: processes left running {left}")
    log(f"model axis: phase 21 took {time.perf_counter() - start:.1f} s")
    return launches


def run_conv_ab(dev, tag):
    """Phase 9, K3's one path: ``conv_ab.run`` in bf16 and f32 at the three
    A/B shapes, its launches held to its calls per variant, and profiles of
    one kernel call and one cuDNN call at the dominant shape in each dtype.
    Returns (the path's launch counts, its bf16 row and its f32 row at
    (8, 128, 128, 64, 64))."""
    import torch

    from tpgan_tpu_torch.examples import conv_ab
    from tpgan_tpu_torch.ops import kernels

    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    ab_rows = conv_ab.run(dev, log=log)  # one JSON line per shape and dtype
    torch.cuda.synchronize()
    ab_launches = kernels.launch_counts()
    ab_variants = kernels.conv3x3_variant_counts()
    calls = {v: sum(r["kernel_calls"] for r in ab_rows if r["variant"] == v)
             for v in ("tma_wgmma", "f32")}
    mma_calls = sum(r["mma_sync_calls"] for r in ab_rows)
    want_rows = [(s_, d) for s_ in conv_ab.SHAPES for d in ("bfloat16", "float32")]
    if [(tuple(r["shape"]), r["dtype"]) for r in ab_rows] != want_rows or any(
            r["variant"] != ("f32" if r["dtype"] == "float32" else "tma_wgmma") for r in ab_rows):
        raise AssertionError("conv A/B rows: "
                             f"{[(r['shape'], r['dtype'], r['variant']) for r in ab_rows]}")
    total = calls["tma_wgmma"] + calls["f32"] + mma_calls
    if ab_launches != {**dict.fromkeys(ab_launches, 0), "conv3x3_bias_lrelu": total}:
        raise AssertionError(f"conv A/B launches {ab_launches}, expected {total} conv3x3 only")
    if ab_variants != {"tma_wgmma": calls["tma_wgmma"], "mma_sync": mma_calls, "f32": calls["f32"]}:
        raise AssertionError(f"conv A/B variants {ab_variants}: expected {calls['tma_wgmma']} "
                             f"tma_wgmma, {mma_calls} mma_sync and {calls['f32']} f32")
    log(f"conv A/B: {len(conv_ab.SHAPES)} shapes x bf16 and f32, {calls['tma_wgmma']} tma_wgmma "
        f"+ {mma_calls} mma_sync + {calls['f32']} f32 calls = launches {ab_variants} {tag}")
    for r in ab_rows:
        if r["dtype"] == "float32":
            log(f"time: conv3x3_bias_lrelu {tuple(r['shape'])} float32 [f32]: kernel "
                f"{r['kernel_us']:.2f} us, cuDNN (TF32 off) {r['cudnn_us']:.2f} us, plain "
                f"{r['plain_us']:.2f} us, bound {r['bound_us']:.2f} us ({r['bound_by']}; "
                f"{r['bound_us'] / r['kernel_us']:.0%} of bound; {r['cuda_vs_cudnn']:.2f}x cuDNN) {tag}")
    # (8, 128, 128, 64, 64): the shape the JAX package calls dominant
    conv_row, f32_row = ab_rows[0], ab_rows[1]
    for dtype, variant in ((torch.bfloat16, "tma_wgmma"), (torch.float32, "f32")):
        dname = str(dtype).replace("torch.", "")
        x, k, b = conv_ab.make_inputs(conv_ab.SHAPES[0], dev, dtype)
        weight = kernels.conv3x3_weight_oihw(k)
        cudnn_call = lambda: kernels.conv3x3_bias_lrelu_cudnn(x, weight, b, conv_ab.NEGATIVE_SLOPE)
        kernel_call = lambda: kernels.conv3x3_bias_lrelu(x, k, b, conv_ab.NEGATIVE_SLOPE)
        kernel_call()
        profile(kernel_call, 20, f"K3 {variant} {conv_ab.SHAPES[0]} {dname}", "call", tag,
                {"K3": [f"conv3x3_{variant}_kernel"]})
        with conv_ab.library_settings():  # the A/B's: cuDNN's algorithm is already chosen
            cudnn_call()
            profile(cudnn_call, 20, f"cuDNN conv + epilogue {conv_ab.SHAPES[0]} {dname}"
                    f"{' (TF32 off)' if dtype == torch.float32 else ''}", "call", tag,
                    {"conv": ["fprop", "conv", "sgemm"], "bias add": ["Functor_add"],
                     "leaky_relu": ["leaky_relu"]})
        del x, k, b, weight
    return ab_launches, conv_row, f32_row


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
    return {"busy_ms": busy_us / iters / 1e3, "kernels": len(kern) / iters, "traced": traced,
            "idle": 1 - busy_us / wall_us}


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

    # ---- 9. conv A/B: K3 against cuDNN's conv + epilogue, bf16 and f32 ----
    ab_launches, conv_row, f32_row = run_conv_ab(dev, tag)

    # ---- 10-13. the loop, multi-step, options, graphed synthesis ----
    torch.cuda.empty_cache()
    loop_launches, loop_rates = run_loop(dev, tag, train_rates[TRAIN_BATCH][0])
    run_multi_step_f32(dev)
    graphed_rates = time_graphed_step(dev, tag, train_rates)
    run_options(dev, tag, train_rates[TRAIN_BATCH][1])
    synth_rates = run_graphed_synthesis(dev, tag)

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

    # ---- 17. full-stack frontalization: uint8 frames to faces ----
    gc.collect()
    torch.cuda.empty_cache()
    front_launches, front_rates = run_frontalize(dev, tag, synth_rates)

    # ---- 18. int8 synthesis and the serving export ----
    gc.collect()
    torch.cuda.empty_cache()
    int8_launches = run_int8(dev, tag, synth_rates, front_rates)

    # ---- 19. the command line, in this process and in fresh ones ----
    gc.collect()
    torch.cuda.empty_cache()
    cli_launches = run_cli(dev, tag)

    # ---- 20. scale-out: the data axis over NCCL and gloo, and torchrun ----
    gc.collect()
    torch.cuda.empty_cache()
    nccl_launches, gloo_launches, _scale_times = run_scale_out(dev, tag)

    # ---- 21. the model axis: tensor parallelism over gloo ranks ----
    gc.collect()
    torch.cuda.empty_cache()
    tp_launches = run_model_axis(dev, tag)

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
        # 3 samples' forwards) + frontalize (2 requests) + int8 (2 synthesis
        # and 2 frontalize requests) + the CLI (20 eager train steps, the
        # graphed run's warm-up steps, synthesize, eval, frontalize) + the
        # scale-out (the world-of-one NCCL loop's 2 eager steps and its
        # graphed run's warm-up steps; both gloo ranks' 2 GAN steps) + the
        # model axis (both tensor-parallel ranks' 2 GAN steps); the graph
        # replays run no wrapper (the traces of phases 11, 13, 17 and 18
        # show their kernels)
        "launches": (serve_launches[name] + train_launches[name] + loop_launches[name]
                     + front_launches[name] + int8_launches[name] + cli_launches[name]
                     + nccl_launches[name] + gloo_launches[name] + tp_launches[name]),
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
        # the f32 kernel at the same shape (CUDA cores; cuDNN with TF32 off)
        "f32_ms": f32_row["kernel_us"] / 1e3,
        "f32_bound_ms": f32_row["bound_us"] / 1e3,
        "f32_library_ms": f32_row["cudnn_us"] / 1e3,
    })
    log("launches by path: " + "; ".join(
        f"{name} serve {serve_launches[name]}, train {train_launches[name]}, loop "
        f"{loop_launches[name]}, frontalize {front_launches[name]}, int8 {int8_launches[name]}, "
        f"cli {cli_launches[name]}, scale-out nccl {nccl_launches[name]}, scale-out gloo "
        f"(2 ranks) {gloo_launches[name]}, model axis (2 ranks) {tp_launches[name]}"
        for name in spec))
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
