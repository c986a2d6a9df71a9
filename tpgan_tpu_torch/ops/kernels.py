"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version, its autograd wrapper and its launch counter.

``fuse_parts`` — the LocalFuser scatter-max (source:
``tpgan_tpu_torch/csrc/fuse_parts.cu``).

* Replaces the TPU kernel ``tpgan_tpu/ops/pallas_kernels.py::
  _fuse_pallas_raw`` (body ``_make_fuse_kernel``), reached through
  ``fuse_parts_pallas``.
* Bound: bytes. At B=8, C=64 bf16 it reads 6.2 MB of parts and writes
  16.8 MB of canvas, about 6.9 us at 3.35 TB/s; at C=3 f32 about 0.6 us,
  so those calls are bound by the launch.
* Design: the gather form — one thread per canvas element writes
  max(0, covering parts) once and each part element is read once, against
  the five canvas-sized passes of the plain form. No zero-fill pass and
  no atomics.
* Layout: contiguous NCHW, as the port's modules emit it; f32 and bf16,
  all four parts of one dtype. The wrapper raises on anything else.

Dispatch: a CPU tensor runs :func:`fuse_parts_plain`; a CUDA tensor
launches the kernel or raises — there is no fallback. The backward is the
port of ``_fuse_bwd`` in plain torch (a part gets g wherever part >= out
in its slot, so ties share), as the JAX backward is plain jnp.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from tpgan_tpu_torch.ops import _build
from tpgan_tpu_torch.ops.geometry import CANVAS_SIZE, PART_GEOMETRY, PART_NAMES

# Launches of the fuse_parts kernel in this process; only the CUDA launch
# path adds to it, so a run can show the main path went through the kernel.
FUSE_LAUNCHES = 0

FUSE_SOURCE = "fuse_parts.cu"
_FUSE_ENTRY = {torch.float32: "tpgan_fuse_parts_f32", torch.bfloat16: "tpgan_fuse_parts_bf16"}


def _slots() -> List[Tuple[int, int, int, int]]:
    """(top, left, h, w) per part, in part order."""
    return [
        (top, left, h, w)
        for (h, w), (top, left) in (PART_GEOMETRY[n] for n in PART_NAMES)
    ]


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


@functools.lru_cache(maxsize=None)
def _fuse_lib() -> ctypes.CDLL:
    lib = _build.load(FUSE_SOURCE)
    for entry in _FUSE_ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib


def _launch_fuse(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    global FUSE_LAUNCHES
    le = parts[0]
    if le.dtype not in _FUSE_ENTRY:
        raise TypeError(f"fuse_parts kernel takes float32 or bfloat16, got {le.dtype}")
    if not all(p.is_contiguous() for p in parts):
        raise ValueError("fuse_parts kernel takes contiguous NCHW parts")
    b, c = le.shape[:2]
    if b * c * CANVAS_SIZE >= 2**31:
        raise ValueError(f"fuse_parts kernel grid too large for B*C={b * c}")
    out = torch.empty((b, c, CANVAS_SIZE, CANVAS_SIZE), dtype=le.dtype, device=le.device)
    if out.numel() == 0:
        return out
    geometry = (ctypes.c_int * 16)(*[v for slot in _slots() for v in slot])
    fn = getattr(_fuse_lib(), _FUSE_ENTRY[le.dtype])
    with torch.cuda.device(le.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            *(p.data_ptr() for p in parts), out.data_ptr(),
            b * c, geometry, CANVAS_SIZE, stream,
        )
    if err != 0:
        raise RuntimeError(f"fuse_parts kernel launch failed: cudaError {err}")
    FUSE_LAUNCHES += 1
    return out


class _FuseParts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, le, re, no, mo):
        parts = (le, re, no, mo)
        if le.device.type == "cuda":
            out = _launch_fuse(parts)
        elif le.device.type == "cpu":
            out = fuse_parts_plain(*parts)
        else:
            raise ValueError(f"fuse_parts runs on cuda or cpu, got {le.device}")
        ctx.save_for_backward(*parts, out)
        return out

    @staticmethod
    def backward(ctx, g):
        *parts, out = ctx.saved_tensors
        grads = []
        for part, (top, left, h, w) in zip(parts, _slots()):
            out_slot = out[:, :, top : top + h, left : left + w]
            g_slot = g[:, :, top : top + h, left : left + w]
            grads.append(
                torch.where(part >= out_slot, g_slot, torch.zeros_like(g_slot)).to(part.dtype)
            )
        return tuple(grads)


def fuse_parts(
    le: torch.Tensor, re: torch.Tensor, no: torch.Tensor, mo: torch.Tensor
) -> torch.Tensor:
    """Scatter-max the four NCHW part maps onto the (B, C, 128, 128)
    canvas: the CUDA kernel on a CUDA tensor, the plain version on a CPU
    tensor; differentiable (the backward of ``_fuse_bwd``)."""
    check_parts((le, re, no, mo))
    return _FuseParts.apply(le, re, no, mo)
