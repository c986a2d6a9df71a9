"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, its autograd wrapper and its launch counter.

``fuse_parts`` — the LocalFuser scatter-max, forward and backward
(source: ``tpgan_tpu_torch/csrc/fuse_parts.cu``).

* Replaces the TPU kernel ``tpgan_tpu/ops/pallas_kernels.py::
  _fuse_pallas_raw`` (body ``_make_fuse_kernel``), reached through
  ``fuse_parts_pallas``, and its backward ``_fuse_bwd`` (plain jnp there).
* Bound: bytes. Forward at B=8, C=64 bf16: 6.2 MB of parts read, 16.8 MB
  of canvas written, about 6.9 us at 3.35 TB/s. Backward: parts read and
  grads written (6,016 px each per plane) and g read over the union of
  the slots (5,358 px), 34,780 bytes per bf16 plane: 35.6 MB and 10.6 us
  at B=16, C=64; 42.5 us at B=64. At C=3 both are bound by the launch.
* Design: the forward is the gather form, staged — a block copies one or
  two planes' parts into shared memory with 16-byte ``cp.async``
  (``fuse_parts_plan``), then writes each canvas pixel once as max(0,
  covering parts), 16 bytes per store; no zero-fill pass, no atomics. The
  backward is one launch for the four parts (``fuse_parts_bwd_plan``): a
  block stages a band of one plane's part rows and the 16-byte chunks of
  g over the slots, recomputes the canvas from the staged parts (autograd
  keeps only the parts, not the canvas), and writes grad = g where part
  >= out, else 0, in 16-byte stores (ties share; NaN gets 0, as
  ``torch.where`` gives). It reads g as autograd hands it when its rows
  are dense (a channel slice of a ``torch.cat``'s gradient, for one); any
  other layout is copied once and counted in ``copy_counts()``.

``symmetry_tv_losses`` — the fused symmetry + total-variation reduction,
forward and backward (source: ``tpgan_tpu_torch/csrc/sym_tv.cu``).

* Replaces ``_sym_tv_sums_raw`` (body ``_make_sym_tv_kernel``), reached
  through ``symmetry_tv_losses``, and its backward ``_sym_tv_bwd``.
* Bound: bytes. Forward: one read of x, 1.57 MB at B=16 bf16 (0.47 us),
  6.3 MB at B=64 (1.9 us), so a launch is most of its cost. Backward: x
  read and dx written, 3.1 MB at B=16 (0.94 us), 12.6 MB at B=64 (3.8 us).
* Design: the forward is one deterministic launch (``sym_tv_plan``):
  16-byte chunks of rows per thread, per-block partials, and the last
  block to finish (an atomic ticket, no float atomics) sums them in block
  order and writes the sums and the two means into one 5-float buffer.
  The backward (``sym_tv_bwd_plan``) reads the upstream scalars from
  device memory and takes sign(0) = +1, JAX's abs rule; its "banded"
  kernel gives each image row to a group of lanes, one 16-byte chunk per
  lane, which walks a band of rows with the rows above and below in
  registers, takes the mirrored chunk and the left and right neighbours
  by warp shuffles and stores 16 bytes per lane; other shapes and
  misaligned tensors take its "general" kernel, one element per thread.
  ``sym_tv_bwd_variant_counts`` counts the launches of each; both are
  bit-equal to ``sym_tv_bwd_plain``.

``conv3x3_bias_lrelu`` — the fused 3x3 conv + bias + LeakyReLU, forward
only (source: ``tpgan_tpu_torch/csrc/conv3x3.cu``).

* Replaces ``conv3x3_bias_lrelu_pallas`` (body ``_make_conv3x3_kernel``),
  which no model calls: its one path is the A/B against the library conv,
  ``tpgan_tpu_torch/examples/conv_ab.py``.
* Bound at the A/B's dominant shape (8, 128, 128, 64 -> 64) bf16: x read
  and y written once, 33.6 MB (10.0 us), against 9.66 GFLOP (9.8 us).
* Design: an implicit GEMM (M = B*H*W, N = Cout, K = 9*Cin) that reads the
  halo as zeros (no padded copy); bias and LeakyReLU on the f32
  accumulators. ``conv3x3_plan`` picks one of three kernels: bf16 with
  Cin and Cout multiples of 8 and 16-byte-aligned pointers takes
  ``tma_wgmma`` (TMA loads of 128-pixel image rectangles per tap, zero-
  filled outside x; ``wgmma`` from a producer-fed ``mbarrier`` ring; a TMA
  store of the tile); other bf16 takes ``mma_sync``; f32 runs on CUDA
  cores. ``conv3x3_variant_counts`` counts the launches of each.

Layout: contiguous NCHW for K1 and K2, as the port's modules emit it; NHWC
x and HWIO weight for K3, the JAX function's. f32 and bf16. A CPU tensor
runs the plain version; a CUDA tensor launches the kernel or raises (wrong
dtype, layout, build or launch error) — there is no fallback. No wrapper
syncs with the host or copies to it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tpgan_tpu_torch.ops import _build
from tpgan_tpu_torch.ops.geometry import CANVAS_SIZE, PART_GEOMETRY, PART_NAMES

# Launches of each kernel in this process. Only the CUDA launch paths add
# to them, so a run can show that the main path went through the kernels.
_LAUNCHES = dict.fromkeys(
    ("fuse_parts", "fuse_parts_bwd", "sym_tv", "sym_tv_bwd", "conv3x3_bias_lrelu"), 0
)

# Launches of K3 per kernel variant (``conv3x3_plan``); each also counts
# once under "conv3x3_bias_lrelu" above.
_CONV3X3_VARIANTS = dict.fromkeys(("tma_wgmma", "mma_sync", "f32"), 0)

# Launches of the K2 backward per kernel variant (``sym_tv_bwd_plan``);
# each also counts once under "sym_tv_bwd" above.
_SYM_TV_BWD_VARIANTS = dict.fromkeys(("banded", "general"), 0)

# Copies a wrapper made before a launch: the fuse backward's of a g whose
# rows are not dense.
_COPIES = dict.fromkeys(("fuse_parts_bwd_g",), 0)
_COUNTERS = (_LAUNCHES, _CONV3X3_VARIANTS, _SYM_TV_BWD_VARIANTS, _COPIES)

FUSE_SOURCE = "fuse_parts.cu"
SYM_TV_SOURCE = "sym_tv.cu"
CONV3X3_SOURCE = "conv3x3.cu"
_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches so far}: the wrapper calls that launched a
    kernel.

    Inside a CUDA graph a wrapper runs once, while the graph is captured,
    and launches nothing then; its kernel launches at every replay, where
    no wrapper runs. So a capture is taken out of these counts and kept as
    the graph's record of one replay (:func:`captured_launches`), and
    replays count nothing here: a profiler trace of the replays shows
    their kernels."""
    return dict(_LAUNCHES)


def conv3x3_variant_counts() -> Dict[str, int]:
    """{K3 variant: launches so far}."""
    return dict(_CONV3X3_VARIANTS)


def sym_tv_bwd_variant_counts() -> Dict[str, int]:
    """{K2 backward variant: launches so far}."""
    return dict(_SYM_TV_BWD_VARIANTS)


def copy_counts() -> Dict[str, int]:
    """{input: copies a wrapper made of it before a launch, so far}."""
    return dict(_COPIES)


def reset_launch_counts() -> None:
    """Set the launch, variant and copy counts to 0."""
    for counts in _COUNTERS:
        for name in counts:
            counts[name] = 0


class CapturedLaunches:
    """What the wrappers recorded while a CUDA graph was captured:
    ``per_replay`` holds the kernel launches (as :func:`launch_counts`
    names them) that each replay of the graph makes."""

    def __init__(self) -> None:
        self.per_replay: Dict[str, int] = dict.fromkeys(_LAUNCHES, 0)


@contextlib.contextmanager
def captured_launches() -> Iterator[CapturedLaunches]:
    """Around a CUDA graph's capture: the launches the wrappers record
    inside go into the yielded :class:`CapturedLaunches`, and the launch,
    variant and copy counts are put back as they were (a capture runs no
    kernel)."""
    before = [dict(c) for c in _COUNTERS]
    record = CapturedLaunches()
    try:
        yield record
    finally:
        record.per_replay = {k: n - before[0][k] for k, n in _LAUNCHES.items()}
        for counts, b in zip(_COUNTERS, before):
            counts.update(b)


def _check_launchable(name: str, tensors: Sequence[torch.Tensor], layout: str = "NCHW") -> str:
    """The entry-point suffix for the first tensor's dtype; raises on a
    dtype or layout the kernel does not take."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous {layout} tensors")
    return _DTYPE_SUFFIX[dtype]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, name: str) -> None:
    """Raise on a non-zero entry-point code: a cudaError, or from K3's TMA
    path 9999 (no cuTensorMapEncodeTiled) or 10000 + a CUresult."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _dispatch(x: torch.Tensor, name: str) -> bool:
    """True to launch the CUDA kernel, False to run the plain version."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu, got {x.device}")


# --------------------------------------------------------------------------
# fuse_parts
# --------------------------------------------------------------------------

def _slots() -> List[Tuple[int, int, int, int]]:
    """(top, left, h, w) per part, in part order."""
    return [
        (top, left, h, w)
        for (h, w), (top, left) in (PART_GEOMETRY[n] for n in PART_NAMES)
    ]


def _geometry_arg():
    return (ctypes.c_int * 16)(*[v for slot in _slots() for v in slot])


# The forward kernel stages at most this many bytes of parts per block:
# two bf16 planes (12,032 bytes each) or one f32 plane (24,064 bytes).
FUSE_STAGE_BYTES = 24 * 1024
# Launches of fewer plane groups than this split each plane into row bands
# (2, 4, ... up to 16), so that a C=3 launch still has blocks enough to
# fill the card: for the forward four per SM of an H100 (132 SMs), the
# best of 1-16 bands at B=8 in bf16 (C=64 and C=3) and f32 (C=3) on the
# card; for the backward (one plane per block) two per SM, the best of
# 1-16 bands at B=16 and 64, C=64 and 3, bf16.
FUSE_FILL_BLOCKS = 4 * 132
FUSE_BWD_FILL_BLOCKS = 2 * 132
FUSE_MAX_BANDS = 16


class FusePlan(NamedTuple):
    planes_per_block: int  # 1 or 2, what the kernel is compiled for
    bands: int  # row bands per plane: blocks along the canvas's rows
    blocks: int
    smem_bytes: int  # dynamic shared memory of one block


def _fill_bands(groups: int, fill: int) -> int:
    """The fewest row bands (a power of two, up to ``FUSE_MAX_BANDS``) that
    give ``groups`` plane groups ``fill`` blocks."""
    bands = 1
    while groups * bands < fill and bands < FUSE_MAX_BANDS:
        bands *= 2
    return bands


@functools.lru_cache(maxsize=None)  # called on every launch: no host work after the first
def fuse_parts_plan(planes: int, dtype: torch.dtype) -> FusePlan:
    """The forward kernel's launch for ``planes`` = B*C canvas planes: as
    many planes per block (up to 2) as fit in ``FUSE_STAGE_BYTES``, the
    last block taking the remainder, in ``_fill_bands`` row bands."""
    plane_bytes = sum(h * w for (h, w), _ in PART_GEOMETRY.values()) * dtype.itemsize
    per_block = max(1, min(2, FUSE_STAGE_BYTES // plane_bytes))
    groups = -(-planes // per_block)
    bands = _fill_bands(groups, FUSE_FILL_BLOCKS)
    return FusePlan(per_block, bands, groups * bands, per_block * plane_bytes)


class FuseBwdPlan(NamedTuple):
    bands: int  # blocks per plane, along the rows some slot covers
    band_rows: int  # canvas rows per band
    blocks: int
    smem_bytes: int  # dynamic shared memory of one block: part rows and g rows


def fuse_bwd_g_window(itemsize: int) -> Tuple[int, int]:
    """(first column, width) of the canvas columns whose g the backward
    stages per row: the slots' column span, widened to 16-byte chunks."""
    per = 16 // itemsize
    lo = min(left for _t, left, _h, _w in _slots())
    hi = max(left + w for _t, left, _h, w in _slots())
    return lo // per * per, -(-hi // per) * per - lo // per * per


@functools.lru_cache(maxsize=None)
def fuse_parts_bwd_plan(planes: int, dtype: torch.dtype) -> FuseBwdPlan:
    """The backward kernel's launch for ``planes`` = B*C planes: one plane
    per block, the rows some slot covers (18-103) split into
    ``_fill_bands(planes, FUSE_BWD_FILL_BLOCKS)`` bands of ``band_rows``
    rows (the last may be shorter). A block stages each part's rows in its
    band (at most min(h, band_rows) of them) and ``band_rows`` rows of the
    g window (``fuse_bwd_g_window``)."""
    slots = _slots()
    row_lo = min(top for top, _l, _h, _w in slots)
    span = max(top + h for top, _l, h, _w in slots) - row_lo
    band_rows = -(-span // _fill_bands(planes, FUSE_BWD_FILL_BLOCKS))
    bands = -(-span // band_rows)
    staged = sum(min(h, band_rows) * w for _t, _l, h, w in slots)
    staged += band_rows * fuse_bwd_g_window(dtype.itemsize)[1]
    return FuseBwdPlan(bands, band_rows, planes * bands, staged * dtype.itemsize)


def check_parts(parts: Sequence[torch.Tensor]) -> None:
    """Raise unless the four parts are NCHW maps of their slot sizes with
    one batch, channel count, dtype and device."""
    b, c = parts[0].shape[:2]
    for name, part in zip(PART_NAMES, parts):
        (h, w), _ = PART_GEOMETRY[name]
        if part.dim() != 4:
            raise ValueError(f"{name} must be NCHW, got shape {tuple(part.shape)}")
        if part.shape[2] != h or part.shape[3] != w:
            raise ValueError(
                f"{name} must be {h}x{w} (HxW), got {part.shape[2]}x{part.shape[3]}"
            )
        if part.shape[:2] != (b, c):
            raise ValueError(
                f"{name} has batch/channels {tuple(part.shape[:2])}, expected {(b, c)}"
            )
        if part.dtype != parts[0].dtype or part.device != parts[0].device:
            raise ValueError("all four parts must share one dtype and device")


def fuse_parts_plain(
    le: torch.Tensor, re: torch.Tensor, no: torch.Tensor, mo: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch fuse: zero canvas, then max each part into its slot
    (``torch.maximum`` propagates NaN, as ``jnp.maximum`` does)."""
    b, c = le.shape[:2]
    out = le.new_zeros(b, c, CANVAS_SIZE, CANVAS_SIZE)
    for part, (top, left, h, w) in zip((le, re, no, mo), _slots()):
        slot = out[:, :, top : top + h, left : left + w]
        out[:, :, top : top + h, left : left + w] = torch.maximum(slot, part)
    return out


def fuse_parts_bwd_plain(
    parts: Sequence[torch.Tensor], out: torch.Tensor, g: torch.Tensor
) -> List[torch.Tensor]:
    """Plain backward, the port of ``_fuse_bwd``: each part gets g where
    part >= out in its slot (ties share), in the part's dtype; ``out`` is
    the fused canvas of ``parts``."""
    grads = []
    for part, (top, left, h, w) in zip(parts, _slots()):
        out_slot = out[:, :, top : top + h, left : left + w]
        g_slot = g[:, :, top : top + h, left : left + w]
        grads.append(
            torch.where(part >= out_slot, g_slot, torch.zeros_like(g_slot)).to(part.dtype)
        )
    return grads


@functools.lru_cache(maxsize=None)
def _fuse_lib() -> ctypes.CDLL:
    lib = _build.load(FUSE_SOURCE)
    # planes, geometry, canvas, then the plan's ints, then the stream
    head = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    for suffix in _DTYPE_SUFFIX.values():
        fwd = getattr(lib, f"tpgan_fuse_parts_{suffix}")
        fwd.argtypes = [ctypes.c_void_p] * 5 + head + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"tpgan_fuse_parts_bwd_{suffix}")
        # parts, g, g's batch and channel strides, channels, grads
        bwd.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_longlong,
                        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)] \
            + head + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


def _launch_fuse(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    le = parts[0]
    suffix = _check_launchable("fuse_parts", parts)
    b, c = le.shape[:2]
    if b * c * CANVAS_SIZE * CANVAS_SIZE >= 2**31:
        raise ValueError(f"fuse_parts kernel uses 32-bit indices; B*C={b * c} is too large")
    out = torch.empty((b, c, CANVAS_SIZE, CANVAS_SIZE), dtype=le.dtype, device=le.device)
    if out.numel() == 0:
        return out
    fn = getattr(_fuse_lib(), f"tpgan_fuse_parts_{suffix}")
    plan = fuse_parts_plan(b * c, le.dtype)
    with torch.cuda.device(le.device):
        err = fn(*(p.data_ptr() for p in parts), out.data_ptr(), b * c, _geometry_arg(),
                 CANVAS_SIZE, plan.planes_per_block, plan.bands, _stream())
    _raise_on(err, "fuse_parts")
    _LAUNCHES["fuse_parts"] += 1
    return out


def _launch_fuse_bwd(parts: Sequence[torch.Tensor], g: torch.Tensor) -> List[torch.Tensor]:
    """The backward kernel: the canvas is recomputed from the parts. ``g``
    is taken as autograd hands it, in the parts' dtype, when its rows are
    dense (strides 128 and 1 in H and W; any batch and channel strides);
    any other layout is made contiguous first, one copy counted in
    ``copy_counts()["fuse_parts_bwd_g"]`` — the kernel still runs."""
    suffix = _check_launchable("fuse_parts backward", parts)
    b, c = parts[0].shape[:2]
    if g.dtype != parts[0].dtype:
        raise TypeError(f"fuse_parts backward: g is {g.dtype}, the parts {parts[0].dtype}")
    if tuple(g.shape) != (b, c, CANVAS_SIZE, CANVAS_SIZE) or g.device != parts[0].device:
        raise ValueError(f"fuse_parts backward: g is {tuple(g.shape)} on {g.device}, expected "
                         f"{(b, c, CANVAS_SIZE, CANVAS_SIZE)} on {parts[0].device}")
    if g.stride(3) != 1 or g.stride(2) != CANVAS_SIZE:
        g = g.contiguous()
        _COPIES["fuse_parts_bwd_g"] += 1
    grads = [torch.empty_like(p) for p in parts]
    if b * c == 0:
        return grads
    fn = getattr(_fuse_lib(), f"tpgan_fuse_parts_bwd_{suffix}")
    plan = fuse_parts_bwd_plan(b * c, g.dtype)
    parts_arg = (ctypes.c_void_p * 4)(*(p.data_ptr() for p in parts))
    grads_arg = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in grads))
    with torch.cuda.device(g.device):
        err = fn(parts_arg, g.data_ptr(), g.stride(0), g.stride(1), c, grads_arg, b * c,
                 _geometry_arg(), CANVAS_SIZE, plan.band_rows, plan.smem_bytes, _stream())
    _raise_on(err, "fuse_parts backward")
    _LAUNCHES["fuse_parts_bwd"] += 1
    return grads


class _FuseParts(torch.autograd.Function):
    """Saves only the four parts: the backward recomputes the canvas (in
    the kernel on the card, with ``fuse_parts_plain`` on the CPU), so the
    canvas can be freed once its consumer is done with it."""

    @staticmethod
    def forward(ctx, le, re, no, mo):
        parts = (le, re, no, mo)
        ctx.save_for_backward(*parts)
        if _dispatch(le, "fuse_parts"):
            return _launch_fuse(parts)
        return fuse_parts_plain(*parts)

    @staticmethod
    def backward(ctx, g):
        parts = ctx.saved_tensors
        if _dispatch(parts[0], "fuse_parts backward"):
            return tuple(_launch_fuse_bwd(parts, g))
        return tuple(fuse_parts_bwd_plain(parts, fuse_parts_plain(*parts), g))


def fuse_parts(
    le: torch.Tensor, re: torch.Tensor, no: torch.Tensor, mo: torch.Tensor
) -> torch.Tensor:
    """Scatter-max the four NCHW part maps onto the (B, C, 128, 128)
    canvas: the CUDA kernels on a CUDA tensor, the plain versions on a CPU
    tensor; differentiable (the backward of ``_fuse_bwd``)."""
    check_parts((le, re, no, mo))
    return _FuseParts.apply(le, re, no, mo)


# --------------------------------------------------------------------------
# symmetry + total variation
# --------------------------------------------------------------------------

def _sym_tv_counts(shape) -> Tuple[int, int, int]:
    """(n_sym, n_h, n_w): the element counts of the three means."""
    b, c, h, w = shape
    return b * c * h * w, b * c * (h - 1) * w, b * c * h * (w - 1)


def _normalise(sums: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    n_sym, n_h, n_w = _sym_tv_counts(shape)
    return sums[0] / n_sym, sums[1] / n_h + sums[2] / n_w


def sym_tv_sums_plain(x: torch.Tensor) -> torch.Tensor:
    """The three f32 sums (Σ|x − flip_W x|, Σ|Δ_H x|, Σ|Δ_W x|) of an NCHW
    x, as a (3,) tensor."""
    x = x.float()
    return torch.stack([
        (x - x.flip(3)).abs().sum(),
        (x[:, :, 1:] - x[:, :, :-1]).abs().sum(),
        (x[..., 1:] - x[..., :-1]).abs().sum(),
    ])


def symmetry_tv_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain (symmetry, total variation), JAX's normalisation
    (``pallas_kernels.py:212-218``)."""
    return _normalise(sym_tv_sums_plain(x), x.shape)


def _jax_sign(d: torch.Tensor) -> torch.Tensor:
    """+1 where d >= 0, else -1 (JAX's abs rule; NaN gives -1)."""
    return torch.where(d >= 0, 1.0, -1.0)


def sym_tv_bwd_plain(
    x: torch.Tensor, g_sym: torch.Tensor, g_tv: torch.Tensor
) -> torch.Tensor:
    """Plain backward: d(g_sym·sym + g_tv·tv)/dx with sign(0) = +1, in f32,
    rounded once to x's dtype. Summed in the kernel's order:
    (sym + tv_h) + tv_w, each bracket an exact small integer times its
    scale."""
    n_sym, n_h, n_w = _sym_tv_counts(x.shape)
    xf = x.float()
    # tensor / tensor: a true division, as the kernel's (torch turns a
    # division by a Python number into a product with its reciprocal)
    count = lambda n: torch.full((), float(n), dtype=torch.float32, device=x.device)
    a, b, c = g_sym.float() / count(n_sym), g_tv.float() / count(n_h), g_tv.float() / count(n_w)
    mirror = xf.flip(3)
    d_sym = a * (_jax_sign(xf - mirror) - _jax_sign(mirror - xf))
    sh = _jax_sign(xf[:, :, 1:] - xf[:, :, :-1])
    kh = torch.zeros_like(xf)
    kh[:, :, 1:] += sh
    kh[:, :, :-1] -= sh
    sw = _jax_sign(xf[..., 1:] - xf[..., :-1])
    kw = torch.zeros_like(xf)
    kw[..., 1:] += sw
    kw[..., :-1] -= sw
    return ((d_sym + b * kh) + c * kw).to(x.dtype)


def _check_image(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[2] < 2 or x.shape[3] < 2:
        raise ValueError(f"symmetry_tv_losses takes NCHW with H, W >= 2, got {tuple(x.shape)}")


SYM_TV_THREADS = 256  # threads per block of the forward kernel
# At most one block per 256-thread slot of an H100 (132 SMs x 2,048
# threads); a larger x takes more than one chunk per thread.
SYM_TV_MAX_BLOCKS = 8 * 132


class SymTVPlan(NamedTuple):
    chunk: int  # elements per thread item: 16 bytes' worth, or 1
    blocks: int


@functools.lru_cache(maxsize=None)
def sym_tv_plan(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                x_ptr_mod16: int = 0) -> SymTVPlan:
    """The forward kernel's launch for an NCHW x: 16-byte chunks of rows
    when W is a multiple of one and x is 16-byte aligned, else single
    elements; one thread per item, up to ``SYM_TV_MAX_BLOCKS`` blocks.
    The grid depends on the shape alone, so the summation order does."""
    b, c, h, w = shape
    per = 16 // dtype.itemsize
    chunk = per if w % per == 0 and x_ptr_mod16 == 0 else 1
    items = b * c * h * w // chunk
    return SymTVPlan(chunk, max(1, min(-(-items // SYM_TV_THREADS), SYM_TV_MAX_BLOCKS)))


# The banded backward kernel's compiled band lengths (rows a lane group
# walks), and the blocks a launch should reach: the longest band whose
# grid still has SYM_TV_BWD_FILL_BLOCKS blocks is taken. On the card
# 1-row bands were the fastest at B=16 (bf16) and B=8 (f32), 4-row bands
# at B=64 (bf16); 2-row bands were fastest at no shape timed and 8-row
# bands slower at every one, so neither is compiled.
SYM_TV_BWD_BAND_ROWS = (1, 4)
SYM_TV_BWD_FILL_BLOCKS = 2 * 132
SYM_TV_BWD_MAX_LANES = 32  # a row's chunks stay inside one warp
# The general kernel grid-strides over elements with at most this many blocks
SYM_TV_BWD_MAX_BLOCKS = 8 * 132


class SymTVBwdPlan(NamedTuple):
    variant: str  # "banded" or "general"
    lanes_per_row: int  # banded: lanes per row group, a power of two (0: general)
    band_rows: int  # banded: rows each group walks (0: general)
    blocks: int


@functools.lru_cache(maxsize=None)
def sym_tv_bwd_plan(shape: Tuple[int, int, int, int], dtype: torch.dtype,
                    x_mod16: int = 0, dx_mod16: int = 0) -> SymTVBwdPlan:
    """The backward kernel's launch for an NCHW x. ``banded`` when W is a
    multiple of a 16-byte chunk, a row has at most 32 chunks and x and dx
    are 16-byte aligned: one lane per chunk, rows in groups of the next
    power of two of lanes (a bf16 or f32 row of 128: 16 or 32), each
    group one band of ``band_rows`` rows of one plane, the longest band of
    ``SYM_TV_BWD_BAND_ROWS`` (not longer than H) whose grid still has
    ``SYM_TV_BWD_FILL_BLOCKS`` blocks, else the shortest. Otherwise
    ``general``: one element per thread, up to ``SYM_TV_BWD_MAX_BLOCKS``.
    Both index in 32 bits: 2^31 elements or more raise ``ValueError``."""
    b, c, h, w = shape
    if b * c * h * w >= 2**31:
        raise ValueError(f"symmetry_tv_losses backward kernel uses 32-bit indices; x {shape} "
                         "is too large")
    per = 16 // dtype.itemsize
    chunks = w // per
    if w % per == 0 and chunks <= SYM_TV_BWD_MAX_LANES and x_mod16 == 0 and dx_mod16 == 0:
        lanes = 1 << (chunks - 1).bit_length()
        groups = SYM_TV_THREADS // lanes  # per block

        def blocks(band):
            return -(-b * c * -(-h // band) // groups)

        fits = [r for r in SYM_TV_BWD_BAND_ROWS if r <= h]
        band = max((r for r in fits if blocks(r) >= SYM_TV_BWD_FILL_BLOCKS), default=fits[0])
        return SymTVBwdPlan("banded", lanes, band, blocks(band))
    n = b * c * h * w
    return SymTVBwdPlan("general", 0, 0, max(1, min(-(-n // SYM_TV_THREADS), SYM_TV_BWD_MAX_BLOCKS)))


@functools.lru_cache(maxsize=None)
def _sym_tv_lib() -> ctypes.CDLL:
    lib = _build.load(SYM_TV_SOURCE)
    dims = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    for suffix in _DTYPE_SUFFIX.values():
        fwd = getattr(lib, f"tpgan_sym_tv_sums_{suffix}")
        fwd.argtypes = [ctypes.c_void_p] * 3 + dims + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"tpgan_sym_tv_bwd_{suffix}")
        # planes, h, w, then the plan's lanes per row, band rows and blocks
        bwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return lib


# Per device: the forward's scratch, an unsigned counter that every launch
# leaves at 0 and 3 f32 partials per block from element 4 on. Made once
# (zeroed) and reused by every call on the device's stream.
_SYM_TV_SCRATCH: Dict[torch.device, torch.Tensor] = {}


def _sym_tv_scratch(device: torch.device) -> torch.Tensor:
    if device not in _SYM_TV_SCRATCH:
        _SYM_TV_SCRATCH[device] = torch.zeros(4 + 3 * SYM_TV_MAX_BLOCKS, dtype=torch.int32,
                                              device=device)
    return _SYM_TV_SCRATCH[device]


def _launch_sym_tv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums (3,), sym, tv) from the forward kernel: views of one 5-float
    buffer."""
    suffix = _check_launchable("symmetry_tv_losses", [x])
    if x.numel() >= 2**31:
        raise ValueError(f"symmetry_tv_losses kernel uses 32-bit indices; x {tuple(x.shape)} "
                         "is too large")
    b, c, h, w = x.shape
    plan = sym_tv_plan(tuple(x.shape), x.dtype, x.data_ptr() % 16)
    out = torch.empty(5, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_sym_tv_lib(), f"tpgan_sym_tv_sums_{suffix}")(
            x.data_ptr(), out.data_ptr(), _sym_tv_scratch(x.device).data_ptr(), b * c, h, w,
            plan.blocks, plan.chunk, _stream(),
        )
    _raise_on(err, "symmetry_tv_losses")
    _LAUNCHES["sym_tv"] += 1
    return out[:3], out[3], out[4]


def _launch_sym_tv_bwd(
    x: torch.Tensor, g_sym: torch.Tensor, g_tv: torch.Tensor
) -> torch.Tensor:
    """dx from the backward kernel ``sym_tv_bwd_plan`` picks."""
    suffix = _check_launchable("symmetry_tv_losses backward", [x])
    for g in (g_sym, g_tv):
        if g.dtype != torch.float32 or g.numel() != 1 or g.device != x.device:
            raise TypeError("symmetry_tv_losses backward takes one f32 scalar per output "
                            f"on {x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    b, c, h, w = x.shape
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    plan = sym_tv_bwd_plan(tuple(x.shape), x.dtype, x.data_ptr() % 16, dx.data_ptr() % 16)
    g_sym, g_tv = g_sym.contiguous(), g_tv.contiguous()
    with torch.cuda.device(x.device):
        err = getattr(_sym_tv_lib(), f"tpgan_sym_tv_bwd_{suffix}")(
            x.data_ptr(), g_sym.data_ptr(), g_tv.data_ptr(), dx.data_ptr(), b * c, h, w,
            plan.lanes_per_row, plan.band_rows, plan.blocks, _stream(),
        )
    _raise_on(err, f"symmetry_tv_losses backward ({plan.variant})")
    _LAUNCHES["sym_tv_bwd"] += 1
    _SYM_TV_BWD_VARIANTS[plan.variant] += 1
    return dx


class _SymmetryTV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        if _dispatch(x, "symmetry_tv_losses"):
            _sums, sym, tv = _launch_sym_tv(x)
        else:
            sym, tv = symmetry_tv_plain(x)
        ctx.save_for_backward(x)
        return sym, tv

    @staticmethod
    def backward(ctx, g_sym, g_tv):
        (x,) = ctx.saved_tensors
        if _dispatch(x, "symmetry_tv_losses backward"):
            return _launch_sym_tv_bwd(x, g_sym, g_tv)
        return sym_tv_bwd_plain(x, g_sym, g_tv)


def symmetry_tv_losses(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(symmetry loss, total-variation loss) of an NCHW image batch as f32
    0-d tensors: sym = mean |x − flip_W x|, tv = mean |Δ_H x| + mean |Δ_W x|
    — the CUDA kernels on a CUDA tensor, the plain versions on a CPU
    tensor; differentiable, with JAX's gradient at ties."""
    _check_image(x)
    return _SymmetryTV.apply(x)


# --------------------------------------------------------------------------
# conv3x3 + bias + LeakyReLU
# --------------------------------------------------------------------------

def _check_conv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise unless x is (B, H, W, Cin), kernel (3, 3, Cin, Cout) of x's
    dtype and bias (Cout,), every size at least 1, all on one device."""
    if x.dim() != 4 or kernel.dim() != 4 or tuple(kernel.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_bias_lrelu takes NHWC x and (3, 3, Cin, Cout) kernel, got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    if tuple(bias.shape) != (kernel.shape[3],):
        raise ValueError(f"bias must be ({kernel.shape[3]},), got {tuple(bias.shape)}")
    if min(x.shape) < 1 or kernel.shape[3] < 1:
        raise ValueError(f"conv3x3_bias_lrelu takes sizes >= 1, got x {tuple(x.shape)}, "
                         f"Cout {kernel.shape[3]}")
    if kernel.dtype != x.dtype:
        # the Pallas kernel does not cast either (the XLA form does)
        raise TypeError(f"conv3x3_bias_lrelu: x is {x.dtype} but the kernel {kernel.dtype}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("x, kernel and bias must be on one device")


def conv3x3_bias_lrelu_plain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.01
) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain PyTorch, independent of any
    conv library: nine shifted f32 matmuls over a zero-padded f32 copy of
    x, then the f32 bias and LeakyReLU (NaN stays NaN), cast to x's dtype."""
    b, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    k = kernel.float()
    acc = torch.zeros((b, h, w, kernel.shape[3]), dtype=torch.float32, device=x.device)
    for dh in range(3):
        for dw in range(3):
            acc += xp[:, dh : dh + h, dw : dw + w, :] @ k[dh, dw]
    y = acc + bias.float()
    return torch.where(y >= 0, y, negative_slope * y).to(x.dtype)


def conv3x3_weight_oihw(kernel: torch.Tensor) -> torch.Tensor:
    """The HWIO kernel as an OIHW weight in channels-last memory, the
    layout cuDNN takes beside a channels-last input (one copy)."""
    return kernel.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)


def conv3x3_bias_lrelu_cudnn(
    x: torch.Tensor, weight_oihw: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.01
) -> torch.Tensor:
    """The library call of the same function, a yardstick of time and never
    on the port's path: ``F.conv2d`` (cuDNN on the card) on x's zero-copy
    channels-last NCHW view with the bias, then ``F.leaky_relu`` in place;
    returns the NHWC view. In bf16 the conv rounds before the epilogue, so
    it matches the kernel only loosely."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight_oihw, bias.to(x.dtype), padding=1)
    return F.leaky_relu(y, negative_slope, inplace=True).permute(0, 2, 3, 1)


CONV3X3_TILE_PIXELS = 128  # M rows of every K3 tile
CONV3X3_K_CHANNELS = 64  # channels per TMA box and k-block: 128 bytes of bf16
TMA_BOX_MAX = 256  # TMA's limit on each box dimension
TMA_SWIZZLE_BYTES = 128  # inner box bytes the 128-byte swizzle allows
CONV3X3_BN = (64, 128, 256)  # the tma_wgmma kernel's compiled N tiles


class Conv3x3Plan(NamedTuple):
    variant: str  # "tma_wgmma", "mma_sync" (bf16) or "f32"
    rows: int  # tma_wgmma: the M tile's pixel rectangle, rows x cols = 128
    cols: int  # (both 0 for the others, whose M tiles run over B*H*W flat)
    bn: int  # output channels per tile
    tiles_m: int
    tiles_n: int

    @property
    def box(self) -> Tuple[int, int, int, int]:
        """tma_wgmma's TMA box over x and y seen as (C, W, H, B)."""
        return (CONV3X3_K_CHANNELS, self.cols, self.rows, 1)


def conv3x3_plan(
    b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
    x_ptr_mod16: int = 0, w_ptr_mod16: int = 0,
) -> Conv3x3Plan:
    """Which K3 kernel a call launches, and its tiles. bf16 with Cin and
    Cout multiples of 8 (16-byte strides) and 16-byte-aligned x and weight
    takes ``tma_wgmma``: an M tile is a rows x cols rectangle of one image,
    cols the largest power of two <= min(W, 128); BN is the narrowest
    compiled width (64, 128, 256) that covers Cout, 256 beyond it (the
    fastest on the card at Cout 64, 128 and 256). Other bf16 takes
    ``mma_sync`` (128 x 64 tiles over B*H*W), f32 the CUDA-core kernel
    (64 x 64). There is no fallback between them."""
    if dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0 and x_ptr_mod16 == 0 \
            and w_ptr_mod16 == 0:
        cols = 1 << (min(w, CONV3X3_TILE_PIXELS).bit_length() - 1)
        rows = CONV3X3_TILE_PIXELS // cols
        bn = next((n for n in CONV3X3_BN if n >= cout), CONV3X3_BN[-1])
        return Conv3x3Plan("tma_wgmma", rows, cols, bn, b * -(-h // rows) * -(-w // cols),
                           -(-cout // bn))
    bm, bn = (128, 64) if dtype == torch.bfloat16 else (64, 64)
    variant = "mma_sync" if dtype == torch.bfloat16 else "f32"
    return Conv3x3Plan(variant, 0, 0, bn, -(-b * h * w // bm), -(-cout // bn))


@functools.lru_cache(maxsize=None)
def _conv3x3_lib() -> ctypes.CDLL:
    lib = _build.load(CONV3X3_SOURCE)
    head = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    for suffix in _DTYPE_SUFFIX.values():
        fn = getattr(lib, f"tpgan_conv3x3_bias_lrelu_{suffix}")
        fn.argtypes = head + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    fn = lib.tpgan_conv3x3_bias_lrelu_tma_wgmma
    fn.argtypes = head + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch_conv3x3(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, negative_slope: float,
    variant: Optional[str] = None,
) -> torch.Tensor:
    """K3 on the card, the kernel ``conv3x3_plan`` picks; ``variant=
    "mma_sync"`` runs the general bf16 kernel on any bf16 shape instead
    (the A/B times it beside the plan's)."""
    suffix = _check_launchable("conv3x3_bias_lrelu", [x, kernel, bias], layout="NHWC/HWIO")
    if bias.dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"conv3x3_bias_lrelu kernel takes a float32 or bfloat16 bias, got "
                        f"{bias.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, kernel, bias)):
        raise ValueError("conv3x3_bias_lrelu kernel is forward only: an input requires grad")
    b, h, w, cin = x.shape
    cout = kernel.shape[3]
    if b * h * w * max(cin, cout) >= 2**31 or 9 * cin * cout >= 2**31:
        raise ValueError(f"conv3x3_bias_lrelu kernel uses 32-bit indices; x {tuple(x.shape)} "
                         f"-> Cout {cout} is too large")
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    plan = conv3x3_plan(b, h, w, cin, cout, x.dtype, x.data_ptr() % 16, kernel.data_ptr() % 16)
    if variant is not None and variant != plan.variant:
        if variant != "mma_sync" or x.dtype != torch.bfloat16:
            raise ValueError(f"conv3x3_bias_lrelu: {variant} cannot take this call "
                             f"(the plan picks {plan.variant})")
        plan = plan._replace(variant=variant)
    lib = _conv3x3_lib()
    args = (x.data_ptr(), kernel.data_ptr(), bias.data_ptr(), int(bias.dtype == torch.float32),
            y.data_ptr(), b, h, w, cin, cout)
    with torch.cuda.device(x.device):
        if plan.variant == "tma_wgmma":
            err = lib.tpgan_conv3x3_bias_lrelu_tma_wgmma(
                *args, plan.rows, plan.cols, plan.bn, float(negative_slope), _stream())
        else:
            err = getattr(lib, f"tpgan_conv3x3_bias_lrelu_{suffix}")(
                *args, float(negative_slope), _stream())
    _raise_on(err, f"conv3x3_bias_lrelu ({plan.variant})")
    _LAUNCHES["conv3x3_bias_lrelu"] += 1
    _CONV3X3_VARIANTS[plan.variant] += 1
    return y


def conv3x3_bias_lrelu(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.01
) -> torch.Tensor:
    """3x3, stride 1, SAME (zero halo) conv of NHWC ``x`` with the HWIO
    ``kernel``, f32 accumulation, then ``+ bias`` and LeakyReLU with
    ``negative_slope``, in x's dtype — the CUDA kernel on a CUDA tensor,
    the plain version on a CPU tensor. Forward only."""
    _check_conv3x3(x, kernel, bias)
    if _dispatch(x, "conv3x3_bias_lrelu"):
        return _launch_conv3x3(x, kernel, bias, negative_slope)
    return conv3x3_bias_lrelu_plain(x, kernel, bias, negative_slope)
