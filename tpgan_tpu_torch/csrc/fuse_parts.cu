// LocalFuser scatter-max for NVIDIA Hopper (sm_90a), forward and backward,
// plain C ABI for ctypes.
//
// Replaces: tpgan_tpu/ops/pallas_kernels.py, _fuse_pallas_raw (kernel body
// _make_fuse_kernel), reached through fuse_parts_pallas, and its backward
// _fuse_bwd (plain jnp there). Python wrappers, plain PyTorch versions and
// launch counters: tpgan_tpu_torch/ops/kernels.py.
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
//
// Backward (fuse_parts_bwd_kernel): each part element gets the canvas
// cotangent of its pixel where part >= out there, else 0, so tied parts
// share it (the rule of _fuse_bwd). A NaN compares false and gets 0, as
// in jnp.where / torch.where. One launch covers the elements of all four
// parts: blockIdx.y picks the part, a grid-stride loop covers its
// elements, one thread each, with 32-bit index math.
// Bound: bytes — each part element, its out and g pixel, and its grad are
// touched once: 4 x C x 6,016 px x 2 B per image in bf16, 197 MB and
// 58.8 us at B=64, C=64; 2.8 us at C=3, below a launch's cost.
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing; each entry point returns cudaGetLastError().

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

// Pointers of the backward launch: the four parts and their four grads,
// and the element count of each part (planes * h * w, below 2^31).
template <typename T>
struct BwdArgs {
  const T* part[kParts];
  T* grad[kParts];
  int count[kParts];
};

// One part's elements, K a compile-time constant: the struct of launch
// arguments is only ever indexed by constants, so it stays in the
// parameter space (an index known only at run time makes the compiler
// copy the whole struct to a per-thread stack).
template <typename T, int K>
__device__ __forceinline__ void fuse_bwd_part(const BwdArgs<T>& args, const T* __restrict__ out,
                                              const T* __restrict__ g, const Slot s, int canvas) {
  const int n = args.count[K];
  const T* __restrict__ part = args.part[K];
  T* __restrict__ grad = args.grad[K];
  const int area = s.h * s.w;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < n; e += gridDim.x * blockDim.x) {
    const int plane = e / area;
    const int rem = e - plane * area;
    const int py = rem / s.w;
    const int px = rem - py * s.w;
    const long long c = (static_cast<long long>(plane) * canvas + s.top + py) * canvas + s.left + px;
    const T p = part[e];
    grad[e] = (to_float(p) >= to_float(out[c])) ? g[c] : from_float<T>(0.0f);
  }
}

// blockIdx.y picks the part; blockIdx.x strides over its elements.
template <typename T>
__global__ void fuse_parts_bwd_kernel(BwdArgs<T> args, const T* __restrict__ out,
                                      const T* __restrict__ g, Geometry geo, int canvas) {
  switch (blockIdx.y) {
    case 0: fuse_bwd_part<T, 0>(args, out, g, geo.slot[0], canvas); break;
    case 1: fuse_bwd_part<T, 1>(args, out, g, geo.slot[1], canvas); break;
    case 2: fuse_bwd_part<T, 2>(args, out, g, geo.slot[2], canvas); break;
    default: fuse_bwd_part<T, 3>(args, out, g, geo.slot[3], canvas); break;
  }
}

template <typename T>
int launch_bwd(const void* const* parts, const void* out, const void* g, void* const* grads,
               long long planes, const int* geometry, int canvas, void* stream) {
  Geometry geo;
  BwdArgs<T> args;
  long long most = 0;
  for (int k = 0; k < kParts; ++k) {
    geo.slot[k] = Slot{geometry[4 * k], geometry[4 * k + 1], geometry[4 * k + 2],
                       geometry[4 * k + 3]};
    args.part[k] = static_cast<const T*>(parts[k]);
    args.grad[k] = static_cast<T*>(grads[k]);
    const long long n = planes * geo.slot[k].h * geo.slot[k].w;
    if (n >= (1ll << 31)) return static_cast<int>(cudaErrorInvalidValue);
    args.count[k] = static_cast<int>(n);
    most = n > most ? n : most;
  }
  const int threads = 256;
  const long long want = (most + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned int>(want < 65536 ? want : 65536), kParts);
  fuse_parts_bwd_kernel<T><<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, static_cast<const T*>(out), static_cast<const T*>(g), geo, canvas);
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

// Backward. parts / grads: 4 device pointers each, in part order; out and g
// are the (B, C, S, S) canvas and its cotangent, all contiguous NCHW of one
// dtype.
extern "C" int tpgan_fuse_parts_bwd_f32(const void* const* parts, const void* out,
                                        const void* g, void* const* grads, long long planes,
                                        const int* geometry, int canvas, void* stream) {
  return launch_bwd<float>(parts, out, g, grads, planes, geometry, canvas, stream);
}

extern "C" int tpgan_fuse_parts_bwd_bf16(const void* const* parts, const void* out,
                                         const void* g, void* const* grads, long long planes,
                                         const int* geometry, int canvas, void* stream) {
  return launch_bwd<__nv_bfloat16>(parts, out, g, grads, planes, geometry, canvas, stream);
}
