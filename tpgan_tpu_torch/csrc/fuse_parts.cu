// LocalFuser scatter-max for NVIDIA Hopper (sm_90a), plain C ABI for ctypes.
//
// Replaces: tpgan_tpu/ops/pallas_kernels.py, _fuse_pallas_raw (kernel body
// _make_fuse_kernel), reached through fuse_parts_pallas. Python wrapper,
// plain PyTorch version and launch counter: tpgan_tpu_torch/ops/kernels.py.
//
// What it computes: per (image, channel) plane, a zero 128x128 canvas with
// four part maps max-blended into static slots (left eye, right eye, nose,
// mouth; the slots come from tpgan_tpu_torch/ops/geometry.py as a launch
// argument). So out = max(0, every part covering the pixel): negatives clamp
// to the zero background even inside a slot, and overlapping slots (the nose
// overlaps both eyes and the mouth) take the larger value.
//
// Layout: contiguous NCHW, the layout the port's modules emit. Parts are
// (B, C, h_k, w_k); the canvas is (B, C, S, S) with S = canvas size.
//
// Bound: bytes. At B=8, C=64 bf16 the parts are 6.2 MB and the canvas
// 16.8 MB, about 6.9 us at 3.35 TB/s; at C=3 in f32 about 0.6 us, below a
// launch's cost. Design: the gather form. One thread per canvas element
// (one block per canvas row of one plane, one thread per column) writes
// max(0, covering parts) exactly once, and each part element is read once,
// by the one thread whose pixel it covers. No zero-fill pass, no atomics,
// no shared memory: one write per canvas byte and one read per part byte,
// against the five canvas-sized passes of the jnp form.
//
// NaN: jnp.maximum propagates NaN and fmaxf does not, so nan_max does.
// The kernel launches on the caller's stream, does not synchronise and
// allocates nothing; each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kParts = 4;

struct Slot {
  int top, left, h, w;
};

struct Geometry {
  Slot slot[kParts];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // exact: v is one of the bf16 inputs or 0
}

// max that returns NaN when either side is NaN, as jnp.maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

template <typename T>
__global__ void fuse_parts_kernel(const T* __restrict__ le, const T* __restrict__ re,
                                  const T* __restrict__ no, const T* __restrict__ mo,
                                  T* __restrict__ out, Geometry geo, int canvas) {
  const int64_t row = blockIdx.x;  // plane * canvas + y
  const int x = threadIdx.x;
  const int64_t plane = row / canvas;
  const int y = static_cast<int>(row - plane * canvas);
  const T* parts[kParts] = {le, re, no, mo};
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const Slot s = geo.slot[k];
    const int py = y - s.top;
    const int px = x - s.left;
    if (py >= 0 && py < s.h && px >= 0 && px < s.w) {
      m = nan_max(m, to_float(parts[k][(plane * s.h + py) * s.w + px]));
    }
  }
  out[row * canvas + x] = from_float<T>(m);
}

template <typename T>
int launch(const void* le, const void* re, const void* no, const void* mo, void* out,
           long long planes, const int* geometry, int canvas, void* stream) {
  Geometry geo;
  for (int k = 0; k < kParts; ++k) {
    geo.slot[k] = Slot{geometry[4 * k], geometry[4 * k + 1], geometry[4 * k + 2],
                       geometry[4 * k + 3]};
  }
  const dim3 grid(static_cast<unsigned int>(planes * canvas));
  const dim3 block(canvas);
  fuse_parts_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(le), static_cast<const T*>(re), static_cast<const T*>(no),
      static_cast<const T*>(mo), static_cast<T*>(out), geo, canvas);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// geometry: 4 x (top, left, h, w) host ints, in part order
// (left_eye, right_eye, nose, mouth); planes = B * C.
extern "C" int tpgan_fuse_parts_f32(const void* le, const void* re, const void* no,
                                    const void* mo, void* out, long long planes,
                                    const int* geometry, int canvas, void* stream) {
  return launch<float>(le, re, no, mo, out, planes, geometry, canvas, stream);
}

extern "C" int tpgan_fuse_parts_bf16(const void* le, const void* re, const void* no,
                                     const void* mo, void* out, long long planes,
                                     const int* geometry, int canvas, void* stream) {
  return launch<__nv_bfloat16>(le, re, no, mo, out, planes, geometry, canvas, stream);
}
