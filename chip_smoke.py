#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``tpgan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each of which exits non-zero on failure:

1. card      — name and power limit, as nvidia-smi reports them;
2. build     — compiles every CUDA kernel from ``tpgan_tpu_torch/csrc/``;
3. kernels   — each kernel against its plain PyTorch version on the card,
               at the shapes the synthesis path gives it (``torch.equal``,
               NaN case included);
4. serve     — the full-size (fm=1.0, deconv) generator in bf16 from a
               seeded init answers 4 requests of batch 8 through
               ``build_generator`` / ``make_synthesize_fn``; every kernel
               of the path must have launched (3 fuses per forward);
5. f32 check — the same forward in f32 (TF32 off, deterministic cuDNN),
               once through the kernel and once with the plain fuse
               forced in: max|diff| <= 1e-6;
6. timings   — each kernel against its plain version and its byte bound
               at batch 8 and 128; synthesis latency (median and the
               highest percentile with ten samples beyond it) and
               images/s at batch 8 and 128; a profiler breakdown of the
               batch-8 forward.

Ends with a ``{"kernels": [...]}`` line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line. Imports nothing of
JAX; needs one GPU.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from unittest import mock

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
FUSE_SHAPES = (  # (channels, dtype name): the three fuses of one forward
    (64, "bfloat16"),  # LocalPathway features, compute dtype
    (3, "bfloat16"),  # fake patches, compute dtype
    (3, "float32"),  # ground-truth patches, input dtype
)
REQUESTS = 4
BATCH = 8
F32_MAX_DIFF = 1e-6
# bf16 keeps 8 mantissa bits: the bf16 serving output may differ from the
# f32 one by a few percent of the output's range (the CPU test's bound)
BF16_REL_DIFF = 0.05


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


def same(a, b) -> bool:
    import torch

    return torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


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
        info = [l.strip() for l in ptxas.read_text().splitlines() if "registers" in l] if ptxas.exists() else []
        log(f"  {source} -> {path.name} {'; '.join(info) or '(cached build)'}")

    # ---- 3. each kernel against its plain version ----
    max_err = 0.0
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
            finite = ~want.isnan()
            max_err = max(max_err, float((got[finite].float() - want[finite].float()).abs().max()))
            log(f"kernel check: fuse_parts B={BATCH} C={c} {dname} nan={nan}: equal")
    try:
        kernels.fuse_parts(*parts[:3], parts[3].transpose(2, 3).contiguous().transpose(2, 3))
        raise AssertionError("fuse_parts accepted a non-contiguous CUDA part")
    except ValueError:
        log("kernel check: non-contiguous CUDA input raises (no fallback)")

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
    kernels.FUSE_LAUNCHES = 0
    t0 = time.perf_counter()
    outputs = [synthesize(b, z) for b, z in requests]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = {"fuse_parts": kernels.FUSE_LAUNCHES}
    for o in outputs:
        if o.shape != (BATCH, 128, 128, 3) or o.dtype != torch.bfloat16:
            raise AssertionError(f"request gave {tuple(o.shape)} {o.dtype}")
        if not torch.isfinite(o.float()).all():
            raise AssertionError("request gave non-finite values")
    if launches["fuse_parts"] != 3 * REQUESTS:
        raise AssertionError(f"fuse_parts launched {launches['fuse_parts']} times, "
                             f"expected {3 * REQUESTS}")
    log(f"serve: {REQUESTS} requests x batch {BATCH}, bf16, full size, "
        f"{serve_s * 1e3:.1f} ms incl. first-call set-up; launches {launches} {tag}")

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
    del synth32, with_kernel, with_plain

    # ---- 6. timings ----
    per_call = []
    for batch in (BATCH, 128):
        for c, dname in FUSE_SHAPES:
            dtype = getattr(torch, dname)
            parts = make_parts(batch, c, dtype, seed=1, device=dev)
            nbytes = sum(p.numel() for p in parts) * parts[0].element_size()
            nbytes += batch * c * 128 * 128 * parts[0].element_size()
            # rotate copies past the 50 MB L2, as the main path meets cold parts
            copies = [parts] + [[p.clone() for p in parts]
                                for _ in range(max(0, math.ceil(200e6 / nbytes) - 1))]
            it = iter(range(10**9))
            k_ms = gpu_time_ms(lambda: kernels._launch_fuse(copies[next(it) % len(copies)]), 200)
            p_ms = gpu_time_ms(lambda: kernels.fuse_parts_plain(*copies[next(it) % len(copies)]), 50)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            per_call.append(dict(batch=batch, channels=c, dtype=dname, ms=k_ms, plain_ms=p_ms,
                                 bound_ms=bound_ms, bytes=nbytes))
            log(f"time: fuse_parts B={batch} C={c} {dname}: kernel {k_ms * 1e3:.2f} us, "
                f"plain {p_ms * 1e3:.2f} us, byte bound {bound_ms * 1e3:.2f} us "
                f"({nbytes / 1e6:.2f} MB; {bound_ms / k_ms:.0%} of bound) {tag}")
            del parts, copies

    # latency: each forward timed alone (host clock, synchronised);
    # throughput: forwards back to back with one synchronise at the end
    for batch, samples in ((BATCH, 100), (128, 20)):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_gan_batch(batch, seed=7).items()
             if k in ("img", "left_eye", "right_eye", "nose", "mouth")}
        z = torch.zeros(batch, cfg.G.zdim, device=dev)
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

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    b8 = {k: torch.as_tensor(v, device=dev) for k, v in requests[0][0].items()
          if k in ("img", "left_eye", "right_eye", "nose", "mouth")}
    z8 = torch.as_tensor(requests[0][1], device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            synthesize(b8, z8)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    if busy_us > 0:
        by_name = {}
        for e in kern:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        fuse_us = sum(v for k, v in by_name.items() if "fuse_parts_kernel" in k)
        log(f"profile: bf16 batch {BATCH}, 3 forwards: wall {wall_us / 3e3:.2f} ms/forward, "
            f"device busy {busy_us / 3e3:.2f} ms/forward ({busy_us / wall_us:.0%}; idle "
            f"{1 - busy_us / wall_us:.0%}), {len(kern) // 3} kernels/forward, fuse_parts "
            f"{fuse_us / 3:.1f} us/forward ({fuse_us / busy_us:.2%} of busy) {tag}")
        for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log(f"profile:   {us / 3e3:8.3f} ms/forward  {name[:110]}")
    else:
        log("profile: the profiler recorded no device time (not measured)")

    main_path = [p for p in per_call if p["batch"] == BATCH]
    kernel_line = {"kernels": [{
        "name": "fuse_parts",
        "route": "cuda",
        "source": "tpgan_tpu_torch/csrc/fuse_parts.cu",
        "replaces": "tpgan_tpu/ops/pallas_kernels.py:64",
        "launches": launches["fuse_parts"],
        "max_abs_err": max_err,
        # one forward's three fuses at batch 8 (C=64 bf16, C=3 bf16, C=3 f32)
        "ms": sum(p["ms"] for p in main_path),
        "plain_ms": sum(p["plain_ms"] for p in main_path),
        "bound_ms": sum(p["bound_ms"] for p in main_path),
        "bound_by": "bytes",
        "library_ms": None,
    }]}
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
