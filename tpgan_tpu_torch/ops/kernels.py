"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, its autograd wrapper and its launch counter.

``fuse_parts`` — the LocalFuser scatter-max, forward and backward
(source: ``tpgan_tpu_torch/csrc/fuse_parts.cu``).

* Replaces the TPU kernel ``tpgan_tpu/ops/pallas_kernels.py::
  _fuse_pallas_raw`` (body ``_make_fuse_kernel``), reached through
  ``fuse_parts_pallas``, and its backward ``_fuse_bwd`` (plain jnp there).
* Bound: bytes. Forward at B=8, C=64 bf16: 6.2 MB of parts read, 16.8 MB
  of canvas written, about 6.9 us at 3.35 TB/s. Backward at B=64, C=64
  bf16: part, out slot, g slot and grad each touched once, 197 MB, about
  58.8 us. At C=3 both are bound by the launch.
* Design: the forward is the gather form — one thread per canvas element
  writes max(0, covering parts) once, each part element is read once; no
  zero-fill pass, no atomics. The backward is one launch over the
  elements of all four parts: grad = g where part >= out in its slot,
  else 0 (ties share; NaN gets 0, as ``torch.where`` gives).

``symmetry_tv_losses`` — the fused symmetry + total-variation reduction,
forward and backward (source: ``tpgan_tpu_torch/csrc/sym_tv.cu``).

* Replaces ``_sym_tv_sums_raw`` (body ``_make_sym_tv_kernel``), reached
  through ``symmetry_tv_losses``, and its backward ``_sym_tv_bwd``.
* Bound: bytes. Forward: one read of x, 6.3 MB at B=64 bf16 (1.9 us), so
  its two launches are its real cost. Backward: x read and dx written,
  12.6 MB (3.8 us).
* Design: a deterministic two-stage sum (per-block partials, then one
  block in a fixed order; no float atomics), normalised on the device;
  the backward is one elementwise pass that reads the upstream scalars
  from device memory and takes sign(0) = +1, JAX's abs rule.

Layout: contiguous NCHW, as the port's modules emit it; f32 and bf16. A
CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises (wrong dtype, layout, build or launch error) — there is no
fallback. No wrapper syncs with the host or copies to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from tpgan_tpu_torch.ops import _build
from tpgan_tpu_torch.ops.geometry import CANVAS_SIZE, PART_GEOMETRY, PART_NAMES

# Launches of each kernel in this process. Only the CUDA launch paths add
# to them, so a run can show that the main path went through the kernels.
_LAUNCHES = dict.fromkeys(("fuse_parts", "fuse_parts_bwd", "sym_tv", "sym_tv_bwd"), 0)

FUSE_SOURCE = "fuse_parts.cu"
SYM_TV_SOURCE = "sym_tv.cu"
_DTYPE_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def launch_counts() -> Dict[str, int]:
    """{kernel name: launches so far}."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def _check_launchable(name: str, tensors: Sequence[torch.Tensor]) -> str:
    """The entry-point suffix for the tensors' dtype; raises on a dtype or
    layout the kernel does not take."""
    dtype = tensors[0].dtype
    if dtype not in _DTYPE_SUFFIX:
        raise TypeError(f"{name} kernel takes float32 or bfloat16, got {dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel takes contiguous NCHW tensors")
    return _DTYPE_SUFFIX[dtype]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(err: int, name: str) -> None:
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
    part >= out in its slot (ties share), in the part's dtype."""
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
    tail = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    for suffix in _DTYPE_SUFFIX.values():
        fwd = getattr(lib, f"tpgan_fuse_parts_{suffix}")
        fwd.argtypes = [ctypes.c_void_p] * 5 + tail
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"tpgan_fuse_parts_bwd_{suffix}")
        bwd.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_void_p,
                        ctypes.POINTER(ctypes.c_void_p)] + tail
        bwd.restype = ctypes.c_int
    return lib


def _launch_fuse(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    le = parts[0]
    suffix = _check_launchable("fuse_parts", parts)
    b, c = le.shape[:2]
    if b * c * CANVAS_SIZE >= 2**31:
        raise ValueError(f"fuse_parts kernel grid too large for B*C={b * c}")
    out = torch.empty((b, c, CANVAS_SIZE, CANVAS_SIZE), dtype=le.dtype, device=le.device)
    if out.numel() == 0:
        return out
    fn = getattr(_fuse_lib(), f"tpgan_fuse_parts_{suffix}")
    with torch.cuda.device(le.device):
        err = fn(*(p.data_ptr() for p in parts), out.data_ptr(),
                 b * c, _geometry_arg(), CANVAS_SIZE, _stream())
    _raise_on(err, "fuse_parts")
    _LAUNCHES["fuse_parts"] += 1
    return out


def _launch_fuse_bwd(
    parts: Sequence[torch.Tensor], out: torch.Tensor, g: torch.Tensor
) -> List[torch.Tensor]:
    """The backward kernel. ``g`` arrives in the canvas dtype and may be
    non-contiguous (autograd hands on what the consumer produced): it is
    made contiguous here, one copy, never a fallback."""
    if g.dtype != out.dtype:
        raise TypeError(f"fuse_parts backward: g is {g.dtype}, the canvas {out.dtype}")
    g = g.contiguous()
    suffix = _check_launchable("fuse_parts backward", [*parts, out, g])
    grads = [torch.empty_like(p) for p in parts]
    if out.numel() == 0:
        return grads
    fn = getattr(_fuse_lib(), f"tpgan_fuse_parts_bwd_{suffix}")
    parts_arg = (ctypes.c_void_p * 4)(*(p.data_ptr() for p in parts))
    grads_arg = (ctypes.c_void_p * 4)(*(t.data_ptr() for t in grads))
    b, c = out.shape[:2]
    with torch.cuda.device(out.device):
        err = fn(parts_arg, out.data_ptr(), g.data_ptr(), grads_arg,
                 b * c, _geometry_arg(), CANVAS_SIZE, _stream())
    _raise_on(err, "fuse_parts backward")
    _LAUNCHES["fuse_parts_bwd"] += 1
    return grads


class _FuseParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, le, re, no, mo):
        parts = (le, re, no, mo)
        if _dispatch(le, "fuse_parts"):
            out = _launch_fuse(parts)
        else:
            out = fuse_parts_plain(*parts)
        ctx.save_for_backward(*parts, out)
        return out

    @staticmethod
    def backward(ctx, g):
        *parts, out = ctx.saved_tensors
        if _dispatch(out, "fuse_parts backward"):
            return tuple(_launch_fuse_bwd(parts, out, g))
        return tuple(fuse_parts_bwd_plain(parts, out, g))


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


@functools.lru_cache(maxsize=None)
def _sym_tv_lib() -> ctypes.CDLL:
    lib = _build.load(SYM_TV_SOURCE)
    lib.tpgan_sym_tv_rows_per_block.restype = ctypes.c_int
    dims = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    for suffix in _DTYPE_SUFFIX.values():
        fwd = getattr(lib, f"tpgan_sym_tv_sums_{suffix}")
        fwd.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + dims
        fwd.restype = ctypes.c_int
        bwd = getattr(lib, f"tpgan_sym_tv_bwd_{suffix}")
        bwd.argtypes = [ctypes.c_void_p] * 4 + dims
        bwd.restype = ctypes.c_int
    return lib


def _launch_sym_tv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sums (3,), sym, tv) from the forward kernel."""
    suffix = _check_launchable("symmetry_tv_losses", [x])
    b, c, h, w = x.shape
    lib = _sym_tv_lib()
    rows = b * c * h
    nblocks = -(-rows // lib.tpgan_sym_tv_rows_per_block())
    if not 0 < nblocks < 2**31:
        raise ValueError(f"symmetry_tv_losses kernel cannot take shape {tuple(x.shape)}")
    f32 = dict(dtype=torch.float32, device=x.device)
    partials = torch.empty(3 * nblocks, **f32)
    sums, sym, tv = torch.empty(3, **f32), torch.empty((), **f32), torch.empty((), **f32)
    with torch.cuda.device(x.device):
        err = getattr(lib, f"tpgan_sym_tv_sums_{suffix}")(
            x.data_ptr(), partials.data_ptr(), nblocks, sums.data_ptr(), sym.data_ptr(),
            tv.data_ptr(), b * c, h, w, _stream(),
        )
    _raise_on(err, "symmetry_tv_losses")
    _LAUNCHES["sym_tv"] += 1
    return sums, sym, tv


def _launch_sym_tv_bwd(
    x: torch.Tensor, g_sym: torch.Tensor, g_tv: torch.Tensor
) -> torch.Tensor:
    suffix = _check_launchable("symmetry_tv_losses backward", [x])
    for g in (g_sym, g_tv):
        if g.dtype != torch.float32 or g.numel() != 1 or g.device != x.device:
            raise TypeError("symmetry_tv_losses backward takes one f32 scalar per output "
                            f"on {x.device}, got {g.dtype} {tuple(g.shape)} on {g.device}")
    b, c, h, w = x.shape
    dx = torch.empty_like(x)
    g_sym, g_tv = g_sym.contiguous(), g_tv.contiguous()
    with torch.cuda.device(x.device):
        err = getattr(_sym_tv_lib(), f"tpgan_sym_tv_bwd_{suffix}")(
            x.data_ptr(), g_sym.data_ptr(), g_tv.data_ptr(), dx.data_ptr(), b * c, h, w,
            _stream(),
        )
    _raise_on(err, "symmetry_tv_losses backward")
    _LAUNCHES["sym_tv_bwd"] += 1
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
