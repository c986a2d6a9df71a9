// Fused symmetry + total-variation reduction for NVIDIA Hopper (sm_90a),
// forward and backward, plain C ABI for ctypes.
//
// Replaces: tpgan_tpu/ops/pallas_kernels.py, _sym_tv_sums_raw (kernel body
// _make_sym_tv_kernel), reached through symmetry_tv_losses, with the
// normalisation of symmetry_tv_losses and the backward _sym_tv_bwd
// (jax.grad of the jnp sums there). Python wrappers, the launch plan, plain
// PyTorch versions and launch counters: tpgan_tpu_torch/ops/kernels.py.
//
// What it computes, on a contiguous NCHW x of B*C planes of H x W:
//   S_sym = sum |x[h,w] - x[h,W-1-w]|,  S_h = sum |x[h,w] - x[h-1,w]|,
//   S_w = sum |x[h,w] - x[h,w-1]|   (f32 accumulation)
//   sym = S_sym / (B*C*H*W),  tv = S_h / (B*C*(H-1)*W) + S_w / (B*C*H*(W-1)).
// The mirror is read in-kernel: the TPU kernel's second, mirrored input was
// a Pallas workaround (no `rev` lowering), not part of the function.
//
// Forward, bound: bytes, one read of x: 1.57 MB at B=16 bf16 (0.47 us at
// 3.35 TB/s), 6.3 MB at B=64 (1.88 us), so a launch is most of its cost.
// Design: one launch, deterministic (no float atomics; a fixed order of
// summation for a given shape, so the loss is bit-identical from run to
// run). Each thread takes 16-byte chunks of image rows (8 bf16 or 4 f32;
// single elements where W is not a multiple of the chunk or x is not
// 16-byte aligned), grid-striding in chunk order: it reads the mirrored
// chunk and the chunk of the row above from L1/L2, and the left neighbour
// of its first element from the lane before it by a warp shuffle. Each
// block sums its threads in a fixed tree and writes 3 partials; then
// __threadfence() and an atomicAdd on an unsigned counter tell the last
// block to finish: it sums the partials in block order, writes the three
// sums and (sym, tv), and resets the counter to 0 for the next call. The
// counter and the partials live in a per-device scratch buffer that the
// wrapper allocates once and zeroes; two calls at once on two streams would
// share it, which the port never does (it runs on one stream).
//
// Backward: one elementwise pass. It reads x and the two upstream scalars
// g_sym and g_tv from device memory (no host round trip) and writes dx in
// x's dtype, computed in f32 and rounded once. The sign follows JAX's abs
// rule, s(d) = d >= 0 ? +1 : -1 (so s(0) = +1; torch's abs backward gives
// 0 there, which drops the TV gradient at every tie of neighbours):
//   dx = a (s(x - x_mirror) - s(x_mirror - x))
//      + b (s(x[h] - x[h-1]) - s(x[h+1] - x[h]))      (terms that exist)
//      + c (s(x[w] - x[w-1]) - s(x[w+1] - x[w]))
// with a = g_sym / n_sym, b = g_tv / n_h, c = g_tv / n_w. Each bracket is
// an exact small integer, so only the two adds round, in this order.
// Bound: bytes, x read once and dx written once (12.6 MB at B=64 bf16:
// 3.8 us).
//
// The kernels launch on the caller's stream, do not synchronise and
// allocate nothing (the wrapper allocates outputs and the scratch); each
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// JAX's abs rule: select(d >= 0, g, -g); a NaN difference gives -1, as there
__device__ __forceinline__ float sgn(float d) { return d >= 0.0f ? 1.0f : -1.0f; }

// Sums of v[0..2] over the block, each in a fixed order (a shuffle tree
// within each warp, then the warp sums in warp order by thread 0); valid
// in thread 0 only. smem: 3 floats per warp.
template <int kBlock>
__device__ __forceinline__ void block_sum3(float* v, float* smem) {
  constexpr int kWarps = kBlock / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] += __shfl_down_sync(0xffffffffu, v[k], off);
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) smem[k * kWarps + warp] = v[k];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float s = 0.0f;
      for (int i = 0; i < kWarps; ++i) s += smem[k * kWarps + i];
      v[k] = s;
    }
  }
  __syncthreads();
}

// kV consecutive elements as floats: one 16-byte load, or one element
template <typename T, int kV>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, float* v) {
  if constexpr (kV == 1) {
    v[0] = to_float(__ldg(p));
  } else {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kV; ++i) v[i] = to_float(e[i]);
  }
}

struct Sums {
  float sym, h, w;
};

// This thread's share of the three sums: chunks first, first + stride, ...
// of the rows * (w / kV) chunks of x, in chunk order. `first` is lane-
// aligned within the warp and `stride` a multiple of 32, so lane l - 1
// holds the chunk before lane l's, and the loop is the same for the whole
// warp (the shuffle needs every lane).
template <typename T, int kV>
__device__ __forceinline__ Sums sum_chunks(const T* __restrict__ x, int items, int h, int w,
                                           int first, int stride) {
  const int per_row = w / kV;
  const int lane = threadIdx.x & 31;
  Sums s = {0.0f, 0.0f, 0.0f};
  for (int base = first - lane; base < items; base += stride) {
    const int q = base + lane;
    const bool valid = q < items;
    const int r = valid ? q / per_row : 0;
    const int col = (valid ? q - r * per_row : 0) * kV;
    const T* row = x + r * w;
    const bool up = valid && r % h != 0;  // a row above in the same plane
    float v[kV], m[kV], a[kV];
    load_chunk<T, kV>(row + col, v);
    load_chunk<T, kV>(row + (w - col - kV), m);
    if (up) load_chunk<T, kV>(row + col - w, a);
    // the element before this chunk: the lane before holds it, except at lane 0
    float left = __shfl_up_sync(0xffffffffu, v[kV - 1], 1);
    if (!valid) continue;
    if (lane == 0 && col > 0) left = to_float(row[col - 1]);
#pragma unroll
    for (int e = 0; e < kV; ++e) s.sym += fabsf(v[e] - m[kV - 1 - e]);
    if (col > 0) s.w += fabsf(v[0] - left);
#pragma unroll
    for (int e = 1; e < kV; ++e) s.w += fabsf(v[e] - v[e - 1]);
    if (up) {
#pragma unroll
      for (int e = 0; e < kV; ++e) s.h += fabsf(v[e] - a[e]);
    }
  }
  return s;
}

// The three sums and the two means into out[0..4].
__device__ __forceinline__ void write_outputs(float* __restrict__ out, float s_sym, float s_h,
                                              float s_w, long long n_sym, long long n_h,
                                              long long n_w) {
  out[0] = s_sym;
  out[1] = s_h;
  out[2] = s_w;
  out[3] = s_sym / static_cast<float>(n_sym);
  out[4] = s_h / static_cast<float>(n_h) + s_w / static_cast<float>(n_w);
}

// scratch: an unsigned counter (0 between calls) at [0], partials from
// float [4] on, 3 per block.
template <typename T, int kV>
__global__ void __launch_bounds__(kThreads)
    sym_tv_kernel(const T* __restrict__ x, float* __restrict__ out,
                  unsigned int* __restrict__ scratch, int items, int h, int w, long long n_sym,
                  long long n_h, long long n_w) {
  __shared__ float smem[3 * kThreads / 32];
  __shared__ bool last;
  float* const partials = reinterpret_cast<float*>(scratch) + 4;
  const Sums s = sum_chunks<T, kV>(x, items, h, w, blockIdx.x * kThreads + threadIdx.x,
                                   gridDim.x * kThreads);
  float v[3] = {s.sym, s.h, s.w};
  block_sum3<kThreads>(v, smem);
  if (threadIdx.x == 0) {
    float* p = partials + 3 * blockIdx.x;
    p[0] = v[0];
    p[1] = v[1];
    p[2] = v[2];
    __threadfence();  // the partials are visible before the count says so
    last = atomicAdd(scratch, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] += __ldcg(partials + 3 * i + k);  // past L1
  }
  block_sum3<kThreads>(acc, smem);
  if (threadIdx.x == 0) {
    write_outputs(out, acc[0], acc[1], acc[2], n_sym, n_h, n_w);
    *scratch = 0u;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sym_tv_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g_sym,
                      const float* __restrict__ g_tv, T* __restrict__ dx, long long total, int h,
                      int w, long long n_sym, long long n_h, long long n_w) {
  const float a = *g_sym / static_cast<float>(n_sym);
  const float b = *g_tv / static_cast<float>(n_h);
  const float c = *g_tv / static_cast<float>(n_w);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < total;
       i += stride) {
    const long long r = i / w;
    const int col = static_cast<int>(i - r * w);
    const int y = static_cast<int>(r % h);
    const T* row = x + r * w;
    const float v = to_float(row[col]);
    const float m = to_float(row[w - 1 - col]);
    const float d_sym = a * (sgn(v - m) - sgn(m - v));
    float kh = 0.0f, kw = 0.0f;
    if (y > 0) kh += sgn(v - to_float(row[col - w]));
    if (y < h - 1) kh -= sgn(to_float(row[col + w]) - v);
    if (col > 0) kw += sgn(v - to_float(row[col - 1]));
    if (col < w - 1) kw -= sgn(to_float(row[col + 1]) - v);
    const float d = (d_sym + b * kh) + c * kw;
    dx[i] = from_float<T>(d);
  }
}

long long counts(long long planes, int h, int w, long long* n_h, long long* n_w) {
  *n_h = planes * (h - 1) * w;
  *n_w = planes * h * (w - 1);
  return planes * h * w;
}

template <typename T>
int launch_sums(const void* x, float* out, void* scratch, long long planes, int h, int w,
                int blocks, int chunk, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  long long n_h, n_w;
  const long long n_sym = counts(planes, h, w, &n_h, &n_w);
  const bool vec = chunk == kV && w % kV == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (planes < 1 || h < 2 || w < 2 || n_sym >= (1ll << 31) || blocks < 1 ||
      (chunk != 1 && !vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const int items = static_cast<int>(n_sym / chunk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* counter = static_cast<unsigned int*>(scratch);
  const T* xt = static_cast<const T*>(x);
  if (vec)
    sym_tv_kernel<T, kV><<<blocks, kThreads, 0, s>>>(xt, out, counter, items, h, w, n_sym, n_h,
                                                     n_w);
  else
    sym_tv_kernel<T, 1><<<blocks, kThreads, 0, s>>>(xt, out, counter, items, h, w, n_sym, n_h,
                                                    n_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const float* g_sym, const float* g_tv, void* dx, long long planes,
               int h, int w, void* stream) {
  long long n_h, n_w;
  const long long n_sym = counts(planes, h, w, &n_h, &n_w);
  const long long want = (n_sym + kThreads - 1) / kThreads;
  const unsigned int blocks = static_cast<unsigned int>(want < 1048576 ? want : 1048576);
  sym_tv_bwd_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), g_sym, g_tv, static_cast<T*>(dx), n_sym, h, w, n_sym, n_h, n_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: contiguous (planes, h, w), h and w >= 2, fewer than 2^31 elements;
// out: 5 floats (S_sym, S_h, S_w, sym, tv); scratch: an unsigned counter
// that is 0, then 3 floats per block from byte 16 on; blocks and chunk
// (elements per thread item: 1, or 16 bytes' worth when w allows and x is
// 16-byte aligned) from the wrapper's plan.
extern "C" int tpgan_sym_tv_sums_f32(const void* x, float* out, void* scratch, long long planes,
                                     int h, int w, int blocks, int chunk, void* stream) {
  return launch_sums<float>(x, out, scratch, planes, h, w, blocks, chunk, stream);
}

extern "C" int tpgan_sym_tv_sums_bf16(const void* x, float* out, void* scratch,
                                      long long planes, int h, int w, int blocks, int chunk,
                                      void* stream) {
  return launch_sums<__nv_bfloat16>(x, out, scratch, planes, h, w, blocks, chunk, stream);
}

// g_sym, g_tv: one device float each; dx: like x.
extern "C" int tpgan_sym_tv_bwd_f32(const void* x, const float* g_sym, const float* g_tv,
                                    void* dx, long long planes, int h, int w, void* stream) {
  return launch_bwd<float>(x, g_sym, g_tv, dx, planes, h, w, stream);
}

extern "C" int tpgan_sym_tv_bwd_bf16(const void* x, const float* g_sym, const float* g_tv,
                                     void* dx, long long planes, int h, int w, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g_sym, g_tv, dx, planes, h, w, stream);
}
