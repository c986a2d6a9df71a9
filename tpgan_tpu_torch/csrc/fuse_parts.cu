// LocalFuser scatter-max for NVIDIA Hopper (sm_90a), forward and backward,
// plain C ABI for ctypes.
//
// Replaces: tpgan_tpu/ops/pallas_kernels.py, _fuse_pallas_raw (kernel body
// _make_fuse_kernel), reached through fuse_parts_pallas, and its backward
// _fuse_bwd (plain jnp there). Python wrappers, launch plans, plain PyTorch
// versions and launch counters: tpgan_tpu_torch/ops/kernels.py.
//
// What it computes: per (image, channel) plane, a zero 128x128 canvas with
// four part maps max-blended into static slots (left eye, right eye, nose,
// mouth; the slots come from tpgan_tpu_torch/ops/geometry.py as a launch
// argument). So out = max(0, every part covering the pixel): negatives clamp
// to the zero background even inside a slot, and overlapping slots (the nose
// overlaps both eyes and the mouth) take the larger value. The backward
// gives each part element the canvas cotangent g of its pixel where
// part >= out there, else 0, so tied parts share it (the rule of _fuse_bwd).
//
// Layout: parts (B, C, h_k, w_k) and the canvas (B, C, S, S), S = 128,
// contiguous NCHW, the layout the port's modules emit. The backward takes g
// as autograd hands it: dense rows (strides S and 1 in H and W) and any
// batch and channel strides, such as a channel slice of a torch.cat's
// gradient.
//
// Bound: bytes. Forward at B=8, C=64 bf16: 6.2 MB of parts read, 16.8 MB of
// canvas written, about 6.9 us at 3.35 TB/s. Backward, per plane: the four
// parts read (6,016 px) and their grads written (6,016 px), and g read over
// the union of the slots (5,358 px: the slots overlap in 658 px); the canvas
// is not read. 34,780 bytes per plane in bf16: 35.6 MB and 10.6 us at B=16,
// C=64; 42.5 us at B=64. At C=3 both directions cost about a launch.
//
// Design, both directions: a block takes a band of canvas rows of one plane
// (two in the bf16 forward; the wrapper's plans), so that a launch of few
// planes (C=3) still spreads over the SMs. It copies what the band needs
// into shared memory with 16-byte cp.async (part rows are 80 or 96 bytes in
// bf16, 160 or 192 in f32, and every part plane starts 16-byte aligned;
// misaligned inputs take element copies into the same staging), then
// writes its output with 16-byte stores. Index math is 32-bit, and the
// launch structs are indexed only by constants, so they stay in the
// parameter space (an index known only at run time copies them to a
// per-thread stack, which cost the first backward 10x).
//   Forward (fuse_parts_kernel): stage the band's part rows, then write
//   each canvas row of the band once, 8 bf16 or 4 f32 pixels per store,
//   each pixel max(0, covering parts). Rows outside every slot are a plain
//   zero store. No zero-fill pass, no atomics.
//   Backward (fuse_parts_bwd_kernel, one launch for the four parts): stage
//   the band's part rows and, for each canvas row, the 16-byte chunks of g
//   that cover the union of the slots on that row (the slot columns are
//   not 16-byte aligned; 6,024 px per plane in bf16). Then each thread
//   takes a 16-byte chunk of a part row: its g pixels from two aligned
//   16-byte shared-memory reads and a funnel shift, out recomputed from
//   the staged parts with the forward's rule (nan_max from 0, in part
//   order; exact, so the comparison matches the stored canvas bit for bit,
//   and +-0 compare equal; where no other slot reaches the chunk, as for
//   75% of the bf16 chunks, part >= out is part >= 0), and one 16-byte
//   store of the grad.
//
// NaN: jnp.maximum propagates NaN and fmaxf does not, so nan_max does. In
// the backward a NaN part, or a NaN anywhere in its pixel's out, compares
// false and gets 0, as jnp.where / torch.where give; a NaN in g passes
// where part >= out.
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

// max that returns NaN when either side is NaN, as jnp.maximum does
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

constexpr int kFuseThreads = 256;
constexpr int kCanvas = 128;  // the canvas side the kernels are compiled for
constexpr int kMaxSmem = 227 * 1024;

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

// Host-side geometry: the slots from the caller's 16 ints, checked against
// the canvas, with the rows some slot covers and the total part area.
bool read_geometry(const int* geometry, int canvas, Geometry* geo, int* row_lo, int* row_hi,
                   int* total_area) {
  *row_lo = canvas;
  *row_hi = 0;
  *total_area = 0;
  for (int k = 0; k < kParts; ++k) {
    const Slot s = Slot{geometry[4 * k], geometry[4 * k + 1], geometry[4 * k + 2],
                        geometry[4 * k + 3]};
    if (s.top < 0 || s.left < 0 || s.h < 1 || s.w < 1 || s.top + s.h > canvas ||
        s.left + s.w > canvas)
      return false;
    geo->slot[k] = s;
    *row_lo = s.top < *row_lo ? s.top : *row_lo;
    *row_hi = s.top + s.h > *row_hi ? s.top + s.h : *row_hi;
    *total_area += s.h * s.w;
  }
  return true;
}

template <typename T>
int launch(const void* le, const void* re, const void* no, const void* mo, void* out,
           long long planes, const int* geometry, int canvas, int planes_per_block,
           int bands, void* stream) {
  const void* const parts[kParts] = {le, re, no, mo};
  Geometry geo;
  int row_lo, row_hi, total_area;
  if (canvas != kCanvas || planes < 1 || planes * canvas * canvas >= (1ll << 31) ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 || bands < 1 || bands > 16 ||
      kCanvas % bands != 0 || !read_geometry(geometry, canvas, &geo, &row_lo, &row_hi,
                                             &total_area))
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = true;
  for (int k = 0; k < kParts; ++k)
    vec = vec && (geo.slot[k].w * sizeof(T)) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(parts[k]) % 16 == 0;
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

// ---- backward ----

// The backward moves elements as raw bits: g and 0 are written unchanged,
// and only the comparisons convert (exactly) to float.
template <typename T>
struct Bits;
template <>
struct Bits<float> {
  using type = uint32_t;
};
template <>
struct Bits<__nv_bfloat16> {
  using type = uint16_t;
};

__device__ __forceinline__ float bits_to_float(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float bits_to_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// Pointers and g's layout; g's batch and channel strides are in elements.
template <typename T>
struct BwdArgs {
  const T* part[kParts];
  T* grad[kParts];
  const T* g;
  long long stride_b, stride_c;
  int channels;
};

// Launch constants computed on the host: the canvas rows some slot covers,
// the rows of one band, and the staged g window, canvas columns
// [win_lo, win_lo + win_w) with both ends 16-byte aligned.
struct BwdLayout {
  int row_lo, row_hi, band_rows, win_lo, win_w;
};

// Where a block's staging lies in shared memory: part k's rows in the
// band start at part[k] (part row r0[k] first), the g rows at g, one win_w
// row per canvas row of the band.
template <typename B>
struct Staged {
  const B* part[kParts];
  int r0[kParts];
  const B* g;
};

// Canvas columns [lo, hi) spanned by the slots that cover canvas row y
// (lo >= hi when none does).
__device__ __forceinline__ void row_span(const Geometry& geo, int y, int* lo, int* hi) {
  *lo = kCanvas;
  *hi = 0;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const Slot s = geo.slot[k];
    if (y >= s.top && y < s.top + s.h) {
      *lo = min(*lo, s.left);
      *hi = max(*hi, s.left + s.w);
    }
  }
}

// The 16 bytes at byte offset off (0-14, even) of the 32 bytes a, b: the
// 8 bf16 or 4 f32 pixels of g under a part chunk, whose slot column is
// not 16-byte aligned. Selects and a funnel shift, no run-time register
// index (which would put the words on the stack).
__device__ __forceinline__ uint4 window16(const uint4& a, const uint4& b, int off) {
  const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int q = off >> 2;
  uint32_t s[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    uint32_t v = w[i];
    if (i + 1 < 8) v = q == 1 ? w[i + 1] : v;
    if (i + 2 < 8) v = q == 2 ? w[i + 2] : v;
    if (i + 3 < 8) v = q == 3 ? w[i + 3] : v;
    s[i] = v;
  }
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) r[i] = (off & 2) ? __funnelshift_r(s[i], s[i + 1], 16) : s[i];
  return make_uint4(r[0], r[1], r[2], r[3]);
}

// One 16-byte chunk of part K's grad: item v of the band's rows, the
// chunks of a part row side by side. Where no other slot reaches the
// chunk, out = max(0, part), so part >= out is part >= 0 (-0 included,
// NaN excluded); otherwise the other parts' staged pixels join the max.
template <typename T, int K>
__device__ __forceinline__ void bwd_chunk(const BwdArgs<T>& args, const Geometry& geo,
                                          const Staged<typename Bits<T>::type>& st,
                                          const BwdLayout& lay, int plane, int y0, int v) {
  using B = typename Bits<T>::type;
  constexpr int kV = 16 / sizeof(T);
  const Slot s = geo.slot[K];
  const int chunks = s.w / kV;
  const int r = v / chunks;  // one division per chunk, none per element
  const int px0 = (v - r * chunks) * kV;
  const int py = st.r0[K] + r;
  const int y = s.top + py;
  const int x0 = s.left + px0;
  const uint4 own_raw = *reinterpret_cast<const uint4*>(st.part[K] + r * s.w + px0);
  const B* own = reinterpret_cast<const B*>(&own_raw);
  // g under the chunk: one or two aligned 16-byte chunks of the staged row
  const int gx = x0 - lay.win_lo;
  const uint4* grow =
      reinterpret_cast<const uint4*>(st.g + (y - y0) * lay.win_w + gx / kV * kV);
  const int off = (gx % kV) * static_cast<int>(sizeof(T));
  const uint4 g_raw = window16(grow[0], off != 0 ? grow[1] : grow[0], off);
  const B* gv = reinterpret_cast<const B*>(&g_raw);
  // the other parts' staged rows through canvas row y, indexed by canvas x
  const B* row[kParts];
  bool reach[kParts];
  bool any = false;
#pragma unroll
  for (int j = 0; j < kParts; ++j) {
    const Slot t = geo.slot[j];
    reach[j] = j != K && y >= t.top && y < t.top + t.h && x0 + kV > t.left &&
               x0 < t.left + t.w;
    row[j] = reach[j] ? st.part[j] + (y - t.top - st.r0[j]) * t.w - t.left : nullptr;
    any = any || reach[j];
  }
  uint4 res_raw;
  B* res = reinterpret_cast<B*>(&res_raw);
  if (!any) {
#pragma unroll
    for (int e = 0; e < kV; ++e) res[e] = bits_to_float(own[e]) >= 0.0f ? gv[e] : B(0);
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const int x = x0 + e;
      const float pv = bits_to_float(own[e]);
      float m = 0.0f;  // out at (y, x), as the forward computes it
#pragma unroll
      for (int j = 0; j < kParts; ++j) {
        const Slot t = geo.slot[j];
        if (j == K)
          m = nan_max(m, pv);
        else if (reach[j] && x >= t.left && x < t.left + t.w)
          m = nan_max(m, bits_to_float(row[j][x]));
      }
      res[e] = pv >= m ? gv[e] : B(0);
    }
  }
  *reinterpret_cast<uint4*>(args.grad[K] + (plane * s.h + py) * s.w + px0) = res_raw;
}

// Plane blockIdx.x, canvas rows y0 .. y1 - 1 of the rows some slot covers.
// One plane per block: two, as the forward takes in bf16, halve the blocks
// an SM holds and were 1.2-1.6x slower on the card.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kFuseThreads)
    fuse_parts_bwd_kernel(BwdArgs<T> args, Geometry geo, BwdLayout lay) {
  using B = typename Bits<T>::type;
  constexpr int kV = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char fuse_smem[];
  B* const staged = reinterpret_cast<B*>(fuse_smem);
  const int tid = threadIdx.x;
  const int plane = blockIdx.x;
  const int y0 = lay.row_lo + blockIdx.y * lay.band_rows;
  const int y1 = min(y0 + lay.band_rows, lay.row_hi);

  // part k's rows in the band, r0 .. r0 + rows - 1, into a region of
  // min(h, band_rows) rows
  Staged<B> st;
  int rows[kParts];
  int off = 0;
#pragma unroll
  for (int k = 0; k < kParts; ++k) {
    const Slot s = geo.slot[k];
    B* const dst = staged + off;
    st.part[k] = dst;
    off += min(s.h, lay.band_rows) * s.w;
    st.r0[k] = min(max(y0 - s.top, 0), s.h);
    rows[k] = max(min(y1 - s.top, s.h) - st.r0[k], 0);
    const int count = rows[k] * s.w;
    const B* __restrict__ src =
        reinterpret_cast<const B*>(args.part[k]) + (plane * s.h + st.r0[k]) * s.w;
    if constexpr (kVec) {
      for (int i = tid * kV; i < count; i += kFuseThreads * kV) cp_async16(dst + i, src + i);
    } else {
      for (int i = tid; i < count; i += kFuseThreads) dst[i] = src[i];
    }
  }

  // g: the chunks of each band row that cover the row's slots
  B* const gs = staged + off;
  st.g = gs;
  const int nrows = y1 - y0;
  const int b = plane / args.channels;
  const B* __restrict__ gp = reinterpret_cast<const B*>(args.g) + b * args.stride_b +
                             (plane - b * args.channels) * args.stride_c;
  if constexpr (kVec) {
    const int chunks = lay.win_w / kV;
    for (int v = tid; v < nrows * chunks; v += kFuseThreads) {
      const int r = v / chunks;
      const int c = v - r * chunks;
      const int y = y0 + r;
      const int x = lay.win_lo + c * kV;
      int lo, hi;
      row_span(geo, y, &lo, &hi);
      if (x + kV > lo && x < hi) cp_async16(gs + r * lay.win_w + c * kV, gp + y * kCanvas + x);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    for (int v = tid; v < nrows * lay.win_w; v += kFuseThreads) {
      const int r = v / lay.win_w;
      const int y = y0 + r;
      const int x = lay.win_lo + v - r * lay.win_w;
      int lo, hi;
      row_span(geo, y, &lo, &hi);
      if (x >= lo && x < hi) gs[v] = gp[y * kCanvas + x];
    }
  }
  __syncthreads();

  // every 16-byte chunk of the four parts' band rows, one per thread and step
  const int n0 = rows[0] * (geo.slot[0].w / kV);
  const int n1 = n0 + rows[1] * (geo.slot[1].w / kV);
  const int n2 = n1 + rows[2] * (geo.slot[2].w / kV);
  const int n3 = n2 + rows[3] * (geo.slot[3].w / kV);
  for (int v = tid; v < n3; v += kFuseThreads) {
    if (v < n0)
      bwd_chunk<T, 0>(args, geo, st, lay, plane, y0, v);
    else if (v < n1)
      bwd_chunk<T, 1>(args, geo, st, lay, plane, y0, v - n0);
    else if (v < n2)
      bwd_chunk<T, 2>(args, geo, st, lay, plane, y0, v - n1);
    else
      bwd_chunk<T, 3>(args, geo, st, lay, plane, y0, v - n2);
  }
}

template <typename T, bool kVec>
int launch_bwd_kernel(const BwdArgs<T>& args, const Geometry& geo, const BwdLayout& lay,
                      int planes, int smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(fuse_parts_bwd_kernel<T, kVec>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int span = lay.row_hi - lay.row_lo;
  const dim3 blocks(planes, (span + lay.band_rows - 1) / lay.band_rows);
  fuse_parts_bwd_kernel<T, kVec><<<blocks, kFuseThreads, smem, st>>>(args, geo, lay);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* const* parts, const void* g, long long stride_b, long long stride_c,
               int channels, void* const* grads, long long planes, const int* geometry,
               int canvas, int band_rows, int smem_bytes, void* stream) {
  constexpr int kV = 16 / sizeof(T);
  Geometry geo;
  BwdLayout lay;
  int total_area;
  if (canvas != kCanvas || planes < 1 || channels < 1 || planes % channels != 0 ||
      stride_b < 0 || stride_c < 0 || band_rows < 1 || smem_bytes > kMaxSmem ||
      !read_geometry(geometry, canvas, &geo, &lay.row_lo, &lay.row_hi, &total_area))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs<T> args;
  bool vec = reinterpret_cast<uintptr_t>(g) % 16 == 0 && stride_b % kV == 0 &&
             stride_c % kV == 0;
  int lo = canvas, hi = 0, staged = 0;
  for (int k = 0; k < kParts; ++k) {
    const Slot s = geo.slot[k];
    // grads are written in 16-byte stores: whole chunks per part row
    if ((s.w * sizeof(T)) % 16 != 0 || reinterpret_cast<uintptr_t>(grads[k]) % 16 != 0 ||
        planes * s.h * s.w >= (1ll << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    args.part[k] = static_cast<const T*>(parts[k]);
    args.grad[k] = static_cast<T*>(grads[k]);
    vec = vec && reinterpret_cast<uintptr_t>(parts[k]) % 16 == 0;
    lo = s.left < lo ? s.left : lo;
    hi = s.left + s.w > hi ? s.left + s.w : hi;
    staged += (s.h < band_rows ? s.h : band_rows) * s.w;
  }
  lay.band_rows = band_rows;
  lay.win_lo = lo / kV * kV;
  lay.win_w = (hi + kV - 1) / kV * kV - lay.win_lo;
  const long long need = static_cast<long long>(staged + band_rows * lay.win_w) * sizeof(T);
  if (smem_bytes < need) return static_cast<int>(cudaErrorInvalidValue);
  args.g = static_cast<const T*>(g);
  args.stride_b = stride_b;
  args.stride_c = stride_c;
  args.channels = channels;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int np = static_cast<int>(planes);
  return vec ? launch_bwd_kernel<T, true>(args, geo, lay, np, smem_bytes, st)
             : launch_bwd_kernel<T, false>(args, geo, lay, np, smem_bytes, st);
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

// Backward. parts / grads: 4 device pointers each, in part order, contiguous
// NCHW, grads 16-byte aligned; g: the (B, C, S, S) cotangent with rows dense
// and batch / channel strides stride_b / stride_c in elements; planes =
// B * C, channels = C; band_rows (canvas rows per block, counted from the
// first row a slot covers) and smem_bytes (at least what the staging needs)
// from the wrapper's plan.
extern "C" int tpgan_fuse_parts_bwd_f32(const void* const* parts, const void* g,
                                        long long stride_b, long long stride_c, int channels,
                                        void* const* grads, long long planes,
                                        const int* geometry, int canvas, int band_rows,
                                        int smem_bytes, void* stream) {
  return launch_bwd<float>(parts, g, stride_b, stride_c, channels, grads, planes, geometry,
                           canvas, band_rows, smem_bytes, stream);
}

extern "C" int tpgan_fuse_parts_bwd_bf16(const void* const* parts, const void* g,
                                         long long stride_b, long long stride_c, int channels,
                                         void* const* grads, long long planes,
                                         const int* geometry, int canvas, int band_rows,
                                         int smem_bytes, void* stream) {
  return launch_bwd<__nv_bfloat16>(parts, g, stride_b, stride_c, channels, grads, planes,
                                   geometry, canvas, band_rows, smem_bytes, stream);
}
