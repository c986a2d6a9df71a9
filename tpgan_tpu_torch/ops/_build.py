"""Build the port's CUDA kernels at first use, from the sources in
``tpgan_tpu_torch/csrc/`` alone.

Each source compiles with one ``nvcc`` call into a shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds). Libraries go to ``build/tpgan_tpu_torch/`` at the root of
the checkout, which ``.gitignore`` lists. A library's file name carries a
hash of its source and the flags, so an edited source is never served by
a stale build; ``nvcc``'s own output (``-Xptxas -v``: registers, shared
memory, spills) is kept beside it as ``<name>.log``.

The data pipeline's host library (``csrc/host/tpgan_host.cpp``) builds
the same way with ``g++`` (:func:`build_host`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpgan_tpu_torch"
SOURCES = ("fuse_parts.cu", "sym_tv.cu", "conv3x3.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600
HOST_SOURCE = "host/tpgan_host.cpp"
# no -march=native: the build directory is copied with the checkout, and
# a library tuned to one host's CPU could fault on another's
HOST_FLAGS = ("-O3", "-shared", "-fPIC")
HOST_TIMEOUT_S = 180


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path(source: str, flags: Sequence[str] = NVCC_FLAGS) -> Path:
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source not built yet — one ``nvcc`` process each, all
    started together — and return {source: library path}. Raises with
    the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for source in sources:
        lib = library_path(source)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[source] = (proc, tmp, lib)
    failures = []
    for source, (proc, tmp, lib) in running.items():
        try:
            text, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
            failures.append(f"{source}: nvcc timed out after {NVCC_TIMEOUT_S} s\n{text}")
            continue
        lib.with_suffix(".log").write_text(text)
        if proc.returncode != 0:
            failures.append(f"{source}: nvcc exited {proc.returncode}\n{text}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return {source: library_path(source) for source in sources}


def load(source: str) -> ctypes.CDLL:
    """The built library of ``source``, building it first if needed."""
    return ctypes.CDLL(str(build((source,))[source]))


def build_host() -> Path:
    """Compile the host library with ``g++`` unless it is built already,
    and return its path. Raises with the compiler's output if the build
    fails: the data path has no fallback."""
    lib = library_path(HOST_SOURCE, HOST_FLAGS)
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH to build "
                           f"{CSRC / HOST_SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a file of this process's own, renamed into place: data-loader
    # workers may build at the same time
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([cxx, *HOST_FLAGS, str(CSRC / HOST_SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=HOST_TIMEOUT_S)
    if proc.returncode != 0:
        raise RuntimeError(f"host library build failed ({cxx} exited {proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib
