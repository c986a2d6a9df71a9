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
// Backward: one pass over x. It reads x and the two upstream scalars
// g_sym and g_tv from device memory (no host round trip) and writes dx in
// x's dtype, computed in f32 and rounded once. The sign follows JAX's abs
// rule, s(d) = d >= 0 ? +1 : -1 (so s(0) = +1; torch's abs backward gives
// 0 there, which drops the TV gradient at every tie of neighbours):
//   dx = a (s(x - x_mirror) - s(x_mirror - x))
//      + b (s(x[h] - x[h-1]) - s(x[h+1] - x[h]))      (terms that exist)
//      + c (s(x[w] - x[w-1]) - s(x[w+1] - x[w]))
// with a = g_sym / n_sym, b = g_tv / n_h, c = g_tv / n_w. Each bracket is
// an exact small integer and each product with it exact, so only the two
// adds round, in this order: the result is bit-equal to the plain version.
// Bound: bytes, x read once and dx written once (3.1 MB at B=16 bf16:
// 0.94 us; 12.6 MB at B=64: 3.8 us), so at B=16 the launch is most of it.
// Design ("banded", sym_tv_bwd_plan): a group of lanes_per_row lanes (a
// power of two: 16 for a bf16 row of 128, 32 for f32) owns one image row,
// one 16-byte chunk per lane, and walks a band of kR rows of one plane.
// Each lane loads its chunk of the kR rows and of the two halo rows above
// and below, all before any arithmetic (16-byte loads, so every element
// of x is read once plus two halo rows per band), and keeps them in
// registers: the vertical signs of a pair of rows serve both rows. The
// mirrored chunk is the same row's chunk of lane (G - 1 - k) of the group
// (G chunks per row): four word shuffles and a reversal in registers, no
// second load. The left and right neighbours of a chunk's ends are one
// element shuffled from lanes k - 1 and k + 1; shuffles run with the
// group's width, so a bf16 warp's two rows never mix, and the row's ends
// take no term. dx leaves in one 16-byte store per chunk. Every loop has
// the same trip count for the whole warp (the shuffles need every lane):
// lanes past the row, past H or past the last band compute on zeros and
// store nothing. 32-bit indices (the wrapper refuses 2^31 elements).
// Shapes the banded kernel does not take (W not a multiple of a chunk, a
// row of more than 32 chunks, x or dx not 16-byte aligned) run the
// "general" kernel: one element per thread, 32-bit indices; the plan names
// it and the wrapper counts its launches apart.
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

// A 16-byte chunk as kV floats, and back (rounded once to T)
template <typename T, int kV>
__device__ __forceinline__ void unpack(const uint4& raw, float* v) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kV; ++i) v[i] = to_float(e[i]);
}

template <typename T, int kV>
__device__ __forceinline__ uint4 pack(const float* v) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < kV; ++i) e[i] = from_float<T>(v[i]);
  return raw;
}

// d = (a (s(v - m) - s(m - v)) + b kh) + c kw, the plain version's order
__device__ __forceinline__ float bwd_value(float v, float m, float kh, float kw, float a, float b,
                                           float c) {
  const float d_sym = a * (sgn(v - m) - sgn(m - v));
  return (d_sym + b * kh) + c * kw;
}

// Banded backward: lanes_per_row = 1 << lanes_log2 lanes per row (chunks =
// w / kV of them live), kR rows per band, bands = ceil(h / kR) per plane,
// one group per (plane, band) task in task order.
template <typename T, int kR>
__global__ void __launch_bounds__(kThreads)
    sym_tv_bwd_kernel(const T* __restrict__ x, const float* __restrict__ g_sym,
                      const float* __restrict__ g_tv, T* __restrict__ dx, int tasks, int bands,
                      int h, int w, int lanes_log2, int n_sym, int n_h, int n_w) {
  constexpr int kV = 16 / sizeof(T);
  const int lanes = 1 << lanes_log2;
  const int k = threadIdx.x & (lanes - 1);  // this lane's chunk of the row
  const int task = static_cast<int>((blockIdx.x * kThreads + threadIdx.x) >> lanes_log2);
  const int chunks = w / kV;
  const bool live = task < tasks && k < chunks;
  const int plane = live ? task / bands : 0;
  const int y0 = live ? (task - plane * bands) * kR : 0;
  const int base = plane * h * w + k * kV;  // element (plane, 0, k * kV)
  // rows y0 - 1 .. y0 + kR: the band and its two halo rows, loaded first
  uint4 raw[kR + 2];
#pragma unroll
  for (int i = 0; i < kR + 2; ++i) {
    const int y = y0 - 1 + i;
    raw[i] = live && y >= 0 && y < h ? __ldg(reinterpret_cast<const uint4*>(x + base + y * w))
                                     : make_uint4(0u, 0u, 0u, 0u);
  }
  const float a = *g_sym / static_cast<float>(n_sym);
  const float b = *g_tv / static_cast<float>(n_h);
  const float c = *g_tv / static_cast<float>(n_w);
  const unsigned full = 0xffffffffu;
  const int mirror_lane = chunks - 1 - k;  // taken modulo lanes past the row
  float cur[kV], dn[kV], s_up[kV], s_dn[kV];
  {
    float up[kV];
    unpack<T, kV>(raw[0], up);
    unpack<T, kV>(raw[1], cur);
#pragma unroll
    for (int e = 0; e < kV; ++e) s_up[e] = sgn(cur[e] - up[e]);
  }
#pragma unroll
  for (int r = 1; r <= kR; ++r) {
    const int y = y0 + r - 1;
    unpack<T, kV>(raw[r + 1], dn);
#pragma unroll
    for (int e = 0; e < kV; ++e) s_dn[e] = sgn(dn[e] - cur[e]);
    uint4 mraw;  // the mirrored chunk, in its own element order
    mraw.x = __shfl_sync(full, raw[r].x, mirror_lane, lanes);
    mraw.y = __shfl_sync(full, raw[r].y, mirror_lane, lanes);
    mraw.z = __shfl_sync(full, raw[r].z, mirror_lane, lanes);
    mraw.w = __shfl_sync(full, raw[r].w, mirror_lane, lanes);
    float m[kV];
    unpack<T, kV>(mraw, m);
    const float left = __shfl_up_sync(full, cur[kV - 1], 1, lanes);  // lane k - 1's last
    const float right = __shfl_down_sync(full, cur[0], 1, lanes);    // lane k + 1's first
    const bool has_up = y > 0, has_down = y < h - 1;
    const float s_left = sgn(cur[0] - left), s_right = sgn(right - cur[kV - 1]);
    float out[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      float kh = 0.0f, kw = 0.0f;
      if (has_up) kh += s_up[e];
      if (has_down) kh -= s_dn[e];
      if (e > 0) {
        kw += sgn(cur[e] - cur[e - 1]);
      } else if (k > 0) {
        kw += s_left;
      }
      if (e < kV - 1) {
        kw -= sgn(cur[e + 1] - cur[e]);
      } else if (k < chunks - 1) {
        kw -= s_right;
      }
      out[e] = bwd_value(cur[e], m[kV - 1 - e], kh, kw, a, b, c);
    }
    if (live && y < h) *reinterpret_cast<uint4*>(dx + base + y * w) = pack<T, kV>(out);
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      cur[e] = dn[e];
      s_up[e] = s_dn[e];
    }
  }
}

// General backward: one element per thread, grid-striding, 32-bit indices
// (unsigned: total < 2^31 and the stride < 2^31, so i + stride cannot wrap).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sym_tv_bwd_general_kernel(const T* __restrict__ x, const float* __restrict__ g_sym,
                              const float* __restrict__ g_tv, T* __restrict__ dx,
                              unsigned int total, int h, int w, int n_sym, int n_h, int n_w) {
  const float a = *g_sym / static_cast<float>(n_sym);
  const float b = *g_tv / static_cast<float>(n_h);
  const float c = *g_tv / static_cast<float>(n_w);
  const unsigned int uw = static_cast<unsigned int>(w);
  const unsigned int stride = gridDim.x * kThreads;
  for (unsigned int i = blockIdx.x * kThreads + threadIdx.x; i < total; i += stride) {
    const unsigned int r = i / uw;
    const int col = static_cast<int>(i - r * uw);
    const int y = static_cast<int>(r % static_cast<unsigned int>(h));
    const T* row = x + r * uw;
    const float v = to_float(row[col]);
    float kh = 0.0f, kw = 0.0f;
    if (y > 0) kh += sgn(v - to_float(row[col - w]));
    if (y < h - 1) kh -= sgn(to_float(row[col + w]) - v);
    if (col > 0) kw += sgn(v - to_float(row[col - 1]));
    if (col < w - 1) kw -= sgn(to_float(row[col + 1]) - v);
    dx[i] = from_float<T>(bwd_value(v, to_float(row[w - 1 - col]), kh, kw, a, b, c));
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
int launch_bwd(const void* x, const float* g_sym, const float* g_tv, void* dx, int planes, int h,
               int w, int lanes, int band_rows, int blocks, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  long long n_h, n_w;
  const long long n_sym = counts(planes, h, w, &n_h, &n_w);
  if (planes < 1 || h < 2 || w < 2 || n_sym >= (1ll << 31) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  const int ns = static_cast<int>(n_sym), nh = static_cast<int>(n_h), nw = static_cast<int>(n_w);
  if (lanes == 0) {  // the general kernel
    sym_tv_bwd_general_kernel<T><<<blocks, kThreads, 0, s>>>(
        xt, g_sym, g_tv, dxt, static_cast<unsigned int>(n_sym), h, w, ns, nh, nw);
    return static_cast<int>(cudaGetLastError());
  }
  void (*kernel)(const T*, const float*, const float*, T*, int, int, int, int, int, int, int,
                 int) = band_rows == 1   ? sym_tv_bwd_kernel<T, 1>
                        : band_rows == 4 ? sym_tv_bwd_kernel<T, 4>
                                         : nullptr;
  int lanes_log2 = 0;
  while (lanes_log2 < 5 && (1 << lanes_log2) < lanes) ++lanes_log2;
  const int bands = kernel ? (h + band_rows - 1) / band_rows : 0;
  const long long tasks = static_cast<long long>(planes) * bands;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (!kernel || (1 << lanes_log2) != lanes || w % kV != 0 || w / kV > lanes || !aligned ||
      static_cast<long long>(blocks) * (kThreads / lanes) < tasks)
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kThreads, 0, s>>>(xt, g_sym, g_tv, dxt, static_cast<int>(tasks), bands, h, w,
                                     lanes_log2, ns, nh, nw);
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

// g_sym, g_tv: one device float each; dx: like x. lanes, band_rows and
// blocks from the wrapper's plan (sym_tv_bwd_plan): lanes 0 launches the
// general kernel on `blocks` blocks; else lanes per row (a power of two, at
// most 32, covering w / (16 / sizeof(T)) chunks), band_rows 1 or 4,
// x and dx 16-byte aligned.
extern "C" int tpgan_sym_tv_bwd_f32(const void* x, const float* g_sym, const float* g_tv,
                                    void* dx, int planes, int h, int w, int lanes, int band_rows,
                                    int blocks, void* stream) {
  return launch_bwd<float>(x, g_sym, g_tv, dx, planes, h, w, lanes, band_rows, blocks, stream);
}

extern "C" int tpgan_sym_tv_bwd_bf16(const void* x, const float* g_sym, const float* g_tv,
                                     void* dx, int planes, int h, int w, int lanes, int band_rows,
                                     int blocks, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, g_sym, g_tv, dx, planes, h, w, lanes, band_rows, blocks,
                                   stream);
}
