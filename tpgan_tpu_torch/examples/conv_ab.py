"""A/B: the hand-written Hopper conv3x3+bias+LeakyReLU kernel (K3,
``tpgan_tpu_torch/csrc/conv3x3.cu``) against cuDNN's conv + epilogue.

The port's counterpart of ``examples/pallas_conv_ab.py``, at its three
head-area shapes and with its inputs (``RandomState(0)`` normals, weights
x0.05, slope 0.2), in bf16 and in f32. Per shape and dtype it checks the
kernel the plan picks (``kernels.conv3x3_plan``: ``tma_wgmma`` in bf16 at
these shapes, the CUDA-core ``f32`` kernel in f32) and, in bf16, the
general ``mma_sync`` kernel against the plain version, then prints one
JSON line: µs per call of the kernel, of ``mma_sync`` (timed in turns
with it: mma_sync, kernel, kernel, mma_sync), of cuDNN (f32 with TF32
off) and of the plain version (CUDA events after a sleep kernel, inputs
rotated past the 50 MB L2), convs/s, the bound and the card's name and
power limit.

    python -m tpgan_tpu_torch.examples.conv_ab              # on cuda
    python -m tpgan_tpu_torch.examples.conv_ab --device cpu # plain version; no times

Without a GPU it raises unless ``--device cpu`` is given; on the CPU it
checks and prints the bounds but measures no time ("not measured": null).
"""

from __future__ import annotations

import argparse
import contextlib
import json
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from tpgan_tpu_torch.ops import kernels
from tpgan_tpu_torch.utils import timing
from tpgan_tpu_torch.utils.device import resolve_device

SHAPES = (
    # (batch, H, W, Cin, Cout): the 128x128 head area, plus a mid-resolution
    # block and a low-resolution wide one (examples/pallas_conv_ab.py)
    (8, 128, 128, 64, 64),
    (8, 64, 64, 128, 128),
    (32, 32, 32, 256, 256),
)
DTYPES = (torch.bfloat16, torch.float32)
NEGATIVE_SLOPE = 0.2
ITERS = {"kernel": 100, "mma_sync": 100, "cudnn": 100, "plain": 10}
# The kernel against its plain version, per element: within one bf16 ulp
# (both round an f32 sum of the same products, taken in another order),
# plus 1e-6 of the largest output for the sums that cancel to near 0; f32
# within 1e-5 of the largest output.
BF16_REL = 2.0**-7
BF16_FLOOR = 1e-6
F32_ATOL = 1e-5

Shape = Tuple[int, int, int, int, int]


def make_inputs(shape: Shape, device, dtype=torch.bfloat16, seed: int = 0):
    """(x, kernel, bias) as ``examples/pallas_conv_ab.py`` makes them:
    x (B, H, W, Cin) and bias ~ N(0, 1), kernel (3, 3, Cin, Cout) ~
    0.05 N(0, 1), drawn in f32 with numpy and cast to ``dtype``."""
    b, h, w, cin, cout = shape
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in (x, k, bias))


def work(shape: Shape, dtype=torch.bfloat16) -> Tuple[int, int]:
    """(bytes, FLOPs) of one call: x, kernel and bias read once, y written
    once; two operations per multiply-add."""
    b, h, w, cin, cout = shape
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = size * (b * h * w * (cin + cout) + 9 * cin * cout + cout)
    return nbytes, 2 * b * h * w * 9 * cin * cout


def bound(shape: Shape, dtype=torch.bfloat16) -> Tuple[float, str]:
    """(least µs on an H100, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over the peak, bf16 on the
    tensor cores, f32 on the CUDA cores."""
    nbytes, flops = work(shape, dtype)
    peak = timing.BF16_FLOPS if dtype == torch.bfloat16 else timing.F32_FLOPS
    t_bytes, t_ops = nbytes / timing.HBM_BYTES_PER_S, flops / peak
    return max(t_bytes, t_ops) * 1e6, "bytes" if t_bytes >= t_ops else "operations"


def check_against_plain(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over the finite elements; raises AssertionError
    unless the NaNs sit at the same places and every element is within the
    limits above for its dtype."""
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"got {got.dtype} {tuple(got.shape)}, want {want.dtype} "
                             f"{tuple(want.shape)}")
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"NaNs differ: {int(got.isnan().sum())} against "
                             f"{int(want.isnan().sum())}")
    finite = ~want.isnan()
    g, w = got[finite].float(), want[finite].float()
    if w.numel() == 0:
        return 0.0
    diff, top = (g - w).abs(), float(w.abs().max())
    if want.dtype == torch.bfloat16:
        limit = BF16_REL * w.abs() + BF16_FLOOR * top
    else:
        limit = torch.full_like(w, F32_ATOL * top)
    bad = ~(diff <= limit)
    if bad.any():
        i = int((diff - limit).argmax())
        raise AssertionError(f"{int(bad.sum())} of {w.numel()} elements off the plain version; "
                             f"worst {float(g[i])} against {float(w[i])} (limit "
                             f"{float(limit[i]):.3e}, max|want| {top:.4g})")
    return float(diff.max())


@contextlib.contextmanager
def library_settings():
    """cuDNN picks its fastest algorithm; f32 stays full f32 (no TF32) in
    cuDNN and in the plain version's matmuls, as in the kernel."""
    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.benchmark = True
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def measure(shape: Shape, device: torch.device, dtype=torch.bfloat16) -> dict:
    """Check the kernel against its plain version at one shape and, on the
    card, time it, the bf16 ``mma_sync`` kernel, cuDNN and the plain
    version. ``kernel_calls`` counts the calls made through
    ``kernels.conv3x3_bias_lrelu`` (on the card, its launches, of
    ``plan``'s variant); ``mma_sync_calls`` those of the forced
    ``mma_sync`` kernel (bf16 on the card only)."""
    on_card = device.type == "cuda"
    x, k, b = make_inputs(shape, device, dtype)
    plan = kernels.conv3x3_plan(*shape, dtype)
    calls = {"kernel": 0, "mma_sync": 0}

    def kernel(x_):
        calls["kernel"] += 1
        return kernels.conv3x3_bias_lrelu(x_, k, b, NEGATIVE_SLOPE)

    def mma_sync(x_):
        calls["mma_sync"] += 1
        return kernels._launch_conv3x3(x_, k, b, NEGATIVE_SLOPE, variant="mma_sync")

    # the general bf16 kernel beside the plan's, where that is another one
    race = on_card and plan.variant == "tma_wgmma"
    with library_settings():
        weight = kernels.conv3x3_weight_oihw(k)
        want = kernels.conv3x3_bias_lrelu_plain(x, k, b, NEGATIVE_SLOPE)
        err = check_against_plain(kernel(x), want)
        lib = kernels.conv3x3_bias_lrelu_cudnn(x, weight, b, NEGATIVE_SLOPE)
        row = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
               "negative_slope": NEGATIVE_SLOPE, "device": device.type,
               "variant": plan.variant, "plan": plan._asdict(), "max_abs_err": err,
               "mma_sync_max_abs_err": check_against_plain(mma_sync(x), want) if race else None,
               "cudnn_max_abs_err": float((lib.float() - want.float()).abs().max())}
        times = dict.fromkeys(("kernel_us", "mma_sync_us", "cudnn_us", "plain_us"))
        if on_card:
            copies = timing.rotated(x.clone, work(shape, dtype)[0])
            turn = iter(range(10**9))
            pick = lambda: copies[next(turn) % len(copies)]
            times["cudnn_us"] = 1e3 * timing.gpu_time_ms(
                lambda: kernels.conv3x3_bias_lrelu_cudnn(pick(), weight, b, NEGATIVE_SLOPE),
                ITERS["cudnn"])
            order = ("mma_sync", "kernel", "kernel", "mma_sync") if race else ("kernel",)
            turns = {"kernel": [], "mma_sync": []}
            for name in order:
                fn = kernel if name == "kernel" else mma_sync
                turns[name].append(1e3 * timing.gpu_time_ms(lambda: fn(pick()), ITERS[name]))
            row["turns_us"] = turns
            times["kernel_us"] = sum(turns["kernel"]) / len(turns["kernel"])
            if race:
                times["mma_sync_us"] = sum(turns["mma_sync"]) / len(turns["mma_sync"])
            times["plain_us"] = 1e3 * timing.gpu_time_ms(
                lambda: kernels.conv3x3_bias_lrelu_plain(pick(), k, b, NEGATIVE_SLOPE),
                ITERS["plain"])
            del copies
    if on_card:
        row.update(cudnn_convs_per_s=1e6 / times["cudnn_us"],
                   cuda_convs_per_s=1e6 / times["kernel_us"],
                   cuda_vs_cudnn=times["cudnn_us"] / times["kernel_us"],
                   mma_sync_vs_kernel=times["mma_sync_us"] / times["kernel_us"] if race else None)
    else:  # no device time on the CPU: not measured
        row.update(cudnn_convs_per_s=None, cuda_convs_per_s=None, cuda_vs_cudnn=None,
                   mma_sync_vs_kernel=None)
    bound_us, bound_by = bound(shape, dtype)
    row.update(times, bound_us=bound_us, bound_by=bound_by, kernel_calls=calls["kernel"],
               mma_sync_calls=calls["mma_sync"], card=timing.card_info() if on_card else None)
    return row


def run(
    device: Optional[Union[str, torch.device]] = None,
    shapes: Sequence[Shape] = SHAPES,
    log=print,
) -> List[dict]:
    """The A/B at every shape in bf16 and f32: one dict per shape and
    dtype (``measure``), each printed as a JSON line through ``log``."""
    device = resolve_device(device)
    rows = []
    for shape in shapes:
        for dtype in DTYPES:
            row = measure(shape, device, dtype)
            log(json.dumps(row))
            rows.append(row)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
