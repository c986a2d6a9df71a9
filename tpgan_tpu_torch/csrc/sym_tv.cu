// Fused symmetry + total-variation reduction for NVIDIA Hopper (sm_90a),
// forward and backward, plain C ABI for ctypes.
//
// Replaces: tpgan_tpu/ops/pallas_kernels.py, _sym_tv_sums_raw (kernel body
// _make_sym_tv_kernel), reached through symmetry_tv_losses, with the
// normalisation of symmetry_tv_losses and the backward _sym_tv_bwd
// (jax.grad of the jnp sums there). Python wrappers, plain PyTorch versions
// and launch counters: tpgan_tpu_torch/ops/kernels.py.
//
// What it computes, on a contiguous NCHW x of B*C planes of H x W:
//   S_sym = sum |x[h,w] - x[h,W-1-w]|,  S_h = sum |x[h,w] - x[h-1,w]|,
//   S_w = sum |x[h,w] - x[h,w-1]|   (f32 accumulation)
//   sym = S_sym / (B*C*H*W),  tv = S_h / (B*C*(H-1)*W) + S_w / (B*C*H*(W-1)).
// The mirror is read in-kernel: the TPU kernel's second, mirrored input was
// a Pallas workaround (no `rev` lowering), not part of the function.
//
// Forward, bound: bytes, one read of x (6.3 MB at B=64 bf16: 1.9 us at
// 3.35 TB/s), so it is bound by its two launches. Design: a deterministic
// two-stage reduction with no float atomics, so the loss is bit-identical
// from run to run. Stage 1: each block sums kRowsPerBlock image rows
// (the mirror and the row above are re-read from L1/L2, not from HBM twice
// in the common case) and writes 3 partials. Stage 2: one block sums the
// partials in a fixed order and writes the three sums and (sym, tv).
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
// allocate nothing (the wrapper allocates outputs and the partials);
// each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = 8;
constexpr int kFinalThreads = 1024;

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

// Sum of v over the block, in a fixed order (shuffle tree within each warp,
// then the warp sums in warp order by thread 0). Valid in thread 0 only.
template <int kBlock>
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) smem[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBlock / 32; ++i) s += smem[i];
  }
  __syncthreads();
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sym_tv_partial_kernel(const T* __restrict__ x, float* __restrict__ partials,
                          long long rows, int h, int w) {
  __shared__ float smem[kThreads / 32];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
  const long long left = rows - row0;
  const int nrow = static_cast<int>(left < kRowsPerBlock ? left : kRowsPerBlock);
  const int n = nrow * w;
  float s_sym = 0.0f, s_h = 0.0f, s_w = 0.0f;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int rr = e / w;
    const int col = e - rr * w;
    const long long r = row0 + rr;
    const T* row = x + r * w;
    const float v = to_float(row[col]);
    s_sym += fabsf(v - to_float(row[w - 1 - col]));
    if (col > 0) s_w += fabsf(v - to_float(row[col - 1]));
    if (r % h != 0) s_h += fabsf(v - to_float(row[col - w]));
  }
  s_sym = block_sum<kThreads>(s_sym, smem);
  s_h = block_sum<kThreads>(s_h, smem);
  s_w = block_sum<kThreads>(s_w, smem);
  if (threadIdx.x == 0) {
    float* p = partials + 3ll * blockIdx.x;
    p[0] = s_sym;
    p[1] = s_h;
    p[2] = s_w;
  }
}

__global__ void __launch_bounds__(kFinalThreads)
    sym_tv_final_kernel(const float* __restrict__ partials, int nblocks, float* __restrict__ sums,
                        float* __restrict__ sym, float* __restrict__ tv, long long n_sym,
                        long long n_h, long long n_w) {
  __shared__ float smem[kFinalThreads / 32];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int i = threadIdx.x; i < nblocks; i += kFinalThreads) {
#pragma unroll
    for (int k = 0; k < 3; ++k) acc[k] += partials[3ll * i + k];
  }
  float total[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) total[k] = block_sum<kFinalThreads>(acc[k], smem);
  if (threadIdx.x == 0) {
    sums[0] = total[0];
    sums[1] = total[1];
    sums[2] = total[2];
    *sym = total[0] / static_cast<float>(n_sym);
    *tv = total[1] / static_cast<float>(n_h) + total[2] / static_cast<float>(n_w);
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
int launch_sums(const void* x, float* partials, int nblocks, float* sums, float* sym, float* tv,
                long long planes, int h, int w, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long n_h, n_w;
  const long long n_sym = counts(planes, h, w, &n_h, &n_w);
  sym_tv_partial_kernel<T><<<nblocks, kThreads, 0, s>>>(static_cast<const T*>(x), partials,
                                                        planes * h, h, w);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sym_tv_final_kernel<<<1, kFinalThreads, 0, s>>>(partials, nblocks, sums, sym, tv, n_sym, n_h,
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

// Rows of one stage-1 block; the wrapper sizes `partials` as
// 3 * ceil(planes * h / rows_per_block) floats.
extern "C" int tpgan_sym_tv_rows_per_block() { return kRowsPerBlock; }

// x: contiguous (planes, h, w); partials: 3 * nblocks floats of scratch;
// sums: 3 floats; sym, tv: one float each.
extern "C" int tpgan_sym_tv_sums_f32(const void* x, float* partials, int nblocks, float* sums,
                                     float* sym, float* tv, long long planes, int h, int w,
                                     void* stream) {
  return launch_sums<float>(x, partials, nblocks, sums, sym, tv, planes, h, w, stream);
}

extern "C" int tpgan_sym_tv_sums_bf16(const void* x, float* partials, int nblocks, float* sums,
                                      float* sym, float* tv, long long planes, int h, int w,
                                      void* stream) {
  return launch_sums<__nv_bfloat16>(x, partials, nblocks, sums, sym, tv, planes, h, w, stream);
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
