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
// launch's cost. Design: the gather form, staged. A block takes one or two
// planes (the wrapper's plan: up to 24 KB of parts per block) and a band of
// their rows — all 128 when there are planes enough to fill the card, else
// 64 down to 8, so that a launch of few planes (C=3) still spreads over
// the SMs. It copies the part rows that fall in its band into shared
// memory with 16-byte cp.async (part rows are 80 or 96 bytes in bf16, 160
// or 192 in f32, and every part plane starts 16-byte aligned), then writes
// the band's canvas rows once, one 16-byte store per thread and step (8
// bf16 or 4 f32 pixels of a row), each pixel max(0, covering parts) read
// from shared memory. Every part row lies in one band, so the bands read
// no byte twice. Rows outside every slot are a plain zero store. No
// zero-fill pass, no atomics: one write per canvas byte and one read per
// part byte, against the five canvas-sized passes of the jnp form.
// Index math is 32-bit (the wrapper bounds B*C*S*S below 2^31), and the
// slot struct is read only with constant indices, so it stays in the
// parameter space. Parts that are not 16-byte aligned take element copies
// into the same staging.
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

constexpr int kFuseThreads = 256;
constexpr int kCanvas = 128;  // the canvas side the forward is compiled for

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// 16 bytes of pixels, converted back exactly (each value is a part's or 0)
__device__ __forceinline__ void store16(float* dst, const float* m) {
  *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* dst, const float* m) {
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(m[2 * i], m[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// Planes p0 .. p0 + PPB - 1 (fewer in the last block), canvas rows
// y0 .. y0 + band_rows - 1. Shared memory holds part k's planes at
// PPB * (area_0 + ... + area_{k-1}) elements, in the parts' own layout;
// only the rows inside the band are copied.
template <typename T, int PPB, bool kVec>
__global__ void __launch_bounds__(kFuseThreads)
    fuse_parts_kernel(const T* __restrict__ le, const T* __restrict__ re,
                      const T* __restrict__ no, const T* __restrict__ mo, T* __restrict__ out,
                      Geometry geo, int planes, int band_rows, int row_lo, int row_hi) {
  extern __shared__ __align__(16) unsigned char fuse_smem[];
  T* const staged = reinterpret_cast<T*>(fuse_smem);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PPB;
  const int n = min(PPB, planes - p0);
  const int y0 = blockIdx.y * band_rows;

  const T* const parts[kParts] = {le, re, no, mo};
  T* base[kParts];
  int off = 0;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const Slot s = geo.slot[k];
    base[k] = staged + off;
    off += PPB * s.h * s.w;
    const int r0 = max(0, y0 - s.top);
    const int count = (min(s.h, y0 + band_rows - s.top) - r0) * s.w;
#pragma unroll
    for (int p = 0; p < PPB; ++p) {
      if (p >= n || count <= 0) break;
      const int first = (p * s.h + r0) * s.w;
      const T* __restrict__ src = parts[k] + p0 * s.h * s.w + first;
      T* const dst = base[k] + first;
      if constexpr (kVec) {
        constexpr int kPer = 16 / sizeof(T);
        for (int i = tid * kPer; i < count; i += kFuseThreads * kPer) cp_async16(dst + i, src + i);
      } else {
        for (int i = tid; i < count; i += kFuseThreads) dst[i] = src[i];
      }
    }
  }
  if constexpr (kVec) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  constexpr int kV = 16 / sizeof(T);  // pixels per 16-byte store
  constexpr int kRowVecs = kCanvas / kV;
#pragma unroll
  for (int p = 0; p < PPB; ++p) {
    if (p >= n) break;
    T* const dst = out + ((p0 + p) * kCanvas + y0) * kCanvas;
    for (int v = tid; v < band_rows * kRowVecs; v += kFuseThreads) {
      const int y = y0 + v / kRowVecs;
      const int x0 = (v % kRowVecs) * kV;
      float m[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) m[e] = 0.0f;
      if (y >= row_lo && y < row_hi) {
#pragma unroll
        for (int k = 0; k < kParts; ++k) {
          const Slot s = geo.slot[k];
          const int py = y - s.top;
          if (py >= 0 && py < s.h && x0 + kV > s.left && x0 < s.left + s.w) {
            const T* row = base[k] + (p * s.h + py) * s.w - s.left;  // indexed by canvas x
#pragma unroll
            for (int e = 0; e < kV; ++e) {
              const int x = x0 + e;
              if (x >= s.left && x < s.left + s.w) m[e] = nan_max(m[e], to_float(row[x]));
            }
          }
        }
      }
      store16(dst + v * kV, m);
    }
  }
}

template <typename T, int PPB>
int launch_planes(const void* const* parts, void* out, const Geometry& geo, int planes,
                  int band_rows, int row_lo, int row_hi, int total_area, bool vec,
                  cudaStream_t st) {
  const dim3 blocks((planes + PPB - 1) / PPB, kCanvas / band_rows);
  const size_t smem = static_cast<size_t>(PPB) * total_area * sizeof(T);
  const T* p[kParts];
  for (int k = 0; k < kParts; ++k) p[k] = static_cast<const T*>(parts[k]);
  if (vec)
    fuse_parts_kernel<T, PPB, true><<<blocks, kFuseThreads, smem, st>>>(
        p[0], p[1], p[2], p[3], static_cast<T*>(out), geo, planes, band_rows, row_lo, row_hi);
  else
    fuse_parts_kernel<T, PPB, false><<<blocks, kFuseThreads, smem, st>>>(
        p[0], p[1], p[2], p[3], static_cast<T*>(out), geo, planes, band_rows, row_lo, row_hi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* le, const void* re, const void* no, const void* mo, void* out,
           long long planes, const int* geometry, int canvas, int planes_per_block,
           int bands, void* stream) {
  const void* const parts[kParts] = {le, re, no, mo};
  Geometry geo;
  int row_lo = canvas, row_hi = 0, total_area = 0;
  bool vec = true;
  if (canvas != kCanvas || planes < 1 || planes * canvas * canvas >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || bands < 1 || bands > 16 ||
      kCanvas % bands != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < kParts; ++k) {
    const Slot s = Slot{geometry[4 * k], geometry[4 * k + 1], geometry[4 * k + 2],
                        geometry[4 * k + 3]};
    if (s.top < 0 || s.left < 0 || s.h < 1 || s.w < 1 || s.top + s.h > canvas ||
        s.left + s.w > canvas)
      return static_cast<int>(cudaErrorInvalidValue);
    geo.slot[k] = s;
    row_lo = s.top < row_lo ? s.top : row_lo;
    row_hi = s.top + s.h > row_hi ? s.top + s.h : row_hi;
    total_area += s.h * s.w;
    vec = vec && (s.w * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(parts[k]) % 16 == 0;
  }
  if (static_cast<long long>(planes_per_block) * total_area * sizeof(T) > 48 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = static_cast<int>(planes);
  const int rows = kCanvas / bands;
  switch (planes_per_block) {
    case 1:
      return launch_planes<T, 1>(parts, out, geo, np, rows, row_lo, row_hi, total_area, vec, st);
    case 2:
      return launch_planes<T, 2>(parts, out, geo, np, rows, row_lo, row_hi, total_area, vec, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
// (left_eye, right_eye, nose, mouth); planes = B * C; planes_per_block 1 or
// 2 and bands (row bands per plane, a power of two up to 16) from the
// wrapper's plan; canvas must be 128 and out 16-byte aligned.
extern "C" int tpgan_fuse_parts_f32(const void* le, const void* re, const void* no,
                                    const void* mo, void* out, long long planes,
                                    const int* geometry, int canvas, int planes_per_block,
                                    int bands, void* stream) {
  return launch<float>(le, re, no, mo, out, planes, geometry, canvas, planes_per_block, bands,
                       stream);
}

extern "C" int tpgan_fuse_parts_bf16(const void* le, const void* re, const void* no,
                                     const void* mo, void* out, long long planes,
                                     const int* geometry, int canvas, int planes_per_block,
                                     int bands, void* stream) {
  return launch<__nv_bfloat16>(le, re, no, mo, out, planes, geometry, canvas, planes_per_block,
                               bands, stream);
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
