// Fused 3x3 convolution + bias + LeakyReLU for NVIDIA Hopper (sm_90a),
// NHWC input, HWIO weight, plain C ABI for ctypes. Forward only.
//
// Replaces: tpgan_tpu/ops/pallas_kernels.py, conv3x3_bias_lrelu_pallas
// (kernel body _make_conv3x3_kernel). Python wrapper, tile plan
// (conv3x3_plan), plain PyTorch version, cuDNN yardstick and launch
// counters: tpgan_tpu_torch/ops/kernels.py.
//
// What it computes, for x (B, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout):
//   acc[b,h,w,n] = sum_{dh,dw,c} xz[b, h+dh-1, w+dw-1, c] * w[dh,dw,c,n]   (f32)
//   y = acc + f32(bias[n]);  y = y >= 0 ? y : slope * y   (NaN stays NaN)
// with xz = x inside the image and 0 outside (stride 1, SAME), stored once
// in x's dtype.
//
// All three kernels are implicit GEMMs: M = B*H*W output pixels, N = Cout,
// K = 9*Cin in HWIO order, k = (3*dh + dw)*Cin + c. In that order the weight
// is a contiguous K x N row-major matrix, and row m of A is the 3x3
// neighbourhood of pixel m, read with the halo and every tail as zeros, so
// no padded copy of x is made (the TPU kernel padded x with jnp.pad first).
// Bias and LeakyReLU are applied to the f32 accumulators; each output is
// written once. The wrapper's plan picks the kernel:
//
// * tma_wgmma (bf16, Cin and Cout multiples of 8, 16-byte-aligned x, w and
//   y: TMA's stride and address rules). An M tile is 128 output pixels as a
//   rectangle of one image, rows x cols with cols the largest power of two
//   <= min(W, 128). For each tap (dh, dw) and 64-channel chunk c0, one TMA
//   load over x seen as the 4-D tensor (C, W, H, B) copies the box
//   (64, cols, rows, 1) at (c0, ow0+dw-1, oh0+dh-1, b): TMA fills every
//   coordinate outside x with zeros, negative ones included, so the halo,
//   the W/H tails and the Cin tail cost no index math in the kernel. With
//   the 128-byte swizzle the box lands in the K-major layout wgmma reads for
//   A. B comes from the HWIO weight as it is, seen as (Cout, Cin, 9): boxes
//   of 64 N x 64 K (zeros past Cin, so the next tap's rows never enter), an
//   N-major tile wgmma takes with its B-transpose flag. One producer warp
//   keeps a ring of 3-4 stages full (mbarrier-guarded); two consumer
//   warpgroups each run wgmma.mma_async m64nBNk16 on 64 rows of the tile,
//   f32 accumulators in registers, BN = 64, 128 or 256. The epilogue adds
//   bias and applies LeakyReLU to the accumulators, stages the bf16 tile in
//   the drained ring (128-byte swizzled, so the fragment stores hit 32
//   distinct banks) and writes it with TMA stores of the same 4-D box, which
//   clip at the edges of y.
// * mma_sync (every other bf16 case: Cin or Cout not a multiple of 8, a
//   misaligned pointer). Tensor cores through mma.sync m16n8k16: a block
//   computes a 128 x 64 output tile with 4 warps of 64 x 32; K moves in
//   steps of 32 through a three-stage ring of shared-memory tiles filled by
//   cp.async (16-byte copies, zero-filled at the halo and the tails) when
//   Cin and Cout are multiples of 8, else by guarded scalar loads. Fragments
//   come from shared memory through ldmatrix (rows padded by 16 bytes, so
//   the eight row addresses of each 8x8 matrix hit distinct banks).
// * f32: CUDA-core FMA (no TF32, so it can be held tightly to the plain
//   version): 256 threads of 8 x 8 outputs on a 256 x 64 or 128 x 128 tile,
//   K tap by tap in 16-channel steps through a 4-stage cp.async ring; its
//   design note heads the f32 path below.
//
// Bound, at the A/B's dominant shape (8, 128, 128, 64 -> 64) in bf16: x read
// once and y written once, 33.6 MB in 10.0 us at 3.35 TB/s, against 9.66
// GFLOP in 9.8 us at 989 TFLOP/s: bytes, barely. At (8, 64, 64, 128 -> 128)
// and (32, 32, 32, 256 -> 256) the operations bound it. mma.sync cannot
// reach the tensor cores' peak and its cp.async ring costs every thread
// address math per 16-byte chunk; the tma_wgmma design moves the copies to
// the TMA unit and the products to wgmma, so the SMs' threads do only the
// epilogue. Its nine per-tap loads read x about nine times, from L2. In f32
// on CUDA cores (67 TFLOP/s) the operations bound all three shapes: 144,
// 144 and 577 us.
//
// Index math is 32-bit: the wrapper raises where B*H*W*max(Cin, Cout) or
// 9*Cin*Cout would not fit. The shape structs are read only by field name,
// so ptxas keeps them in the constant bank (no stack frame). The kernels
// launch on the caller's stream, do not synchronise and allocate nothing;
// each entry point returns cudaGetLastError(), or for tma_wgmma
// kNoEncoder / kEncodeFailed + CUresult when a tensor map cannot be made.
// cuTensorMapEncodeTiled is reached through cudaGetDriverEntryPoint, so
// the library links no -lcuda.

#include <cuda.h>  // CUtensorMap and its enums; no driver symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

struct ConvShape {
  int h, w, cin, cout;
  int m;  // B*H*W output pixels
  int k;  // 9*Cin
  int n_tiles;  // output-channel tiles per row of blocks
  float slope;
};

__device__ __forceinline__ float lrelu(float v, float slope) {
  return v >= 0.0f ? v : slope * v;
}

__device__ __forceinline__ float bias_at(const void* bias, int bias_f32, int n) {
  return bias_f32 ? static_cast<const float*>(bias)[n]
                  : __bfloat162float(static_cast<const bf16*>(bias)[n]);
}

// ----------------------------------------------------------- mma_sync path

constexpr int kBM = 128;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kStages = 3;
constexpr int kThreads = 128;
constexpr int kAStride = kBK + 8;  // bf16 per A row in shared memory (80 bytes)
constexpr int kBStride = kBN + 8;  // bf16 per B row (144 bytes)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  // src-size 0 reads nothing and zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The source offset (in elements) of A[m][k] for the pixel (oh, ow) = m,
// or -1 where it lies in the halo or past K.
__device__ __forceinline__ int a_offset(const ConvShape& s, int m, int oh, int ow, int k) {
  if (k >= s.k) return -1;
  const int tap = k / s.cin;
  const int c = k - tap * s.cin;
  const int dh = tap / 3;
  const int dw = tap - 3 * dh;
  const int ih = oh + dh - 1;
  const int iw = ow + dw - 1;
  if (static_cast<unsigned>(ih) >= static_cast<unsigned>(s.h) ||
      static_cast<unsigned>(iw) >= static_cast<unsigned>(s.w))
    return -1;
  return (m + (dh - 1) * s.w + (dw - 1)) * s.cin + c;
}

// Rows of A that one thread copies in the 16-byte path: 128 rows of four
// 8-element chunks, 512 chunks over 128 threads.
constexpr int kARowsPerThread = kBM * (kBK / 8) / kThreads;  // 4
constexpr int kBChunksPerThread = kBK * (kBN / 8) / kThreads;  // 2

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    conv3x3_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        const void* __restrict__ bias, int bias_f32, bf16* __restrict__ y,
                        ConvShape s) {
  __shared__ __align__(128) bf16 As[kStages][kBM * kAStride];
  __shared__ __align__(128) bf16 Bs[kStages][kBK * kBStride];

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % s.n_tiles) * kBN;
  const int m0 = (blockIdx.x / s.n_tiles) * kBM;

  // 16-byte path: this thread's A rows (pixel, its row and column; a row
  // past M gets a row far outside the image, so every tap reads zeros)
  int a_m[kARowsPerThread], a_oh[kARowsPerThread], a_ow[kARowsPerThread];
#pragma unroll
  for (int i = 0; i < kARowsPerThread; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    a_m[i] = m;
    a_ow[i] = m % s.w;
    a_oh[i] = m < s.m ? (m / s.w) % s.h : -4;
  }

  auto load_stage = [&](int stage, int k0) {
    bf16* as = As[stage];
    bf16* bs = Bs[stage];
    if constexpr (kVec) {
      const int col = (tid & 3) * 8;
#pragma unroll
      for (int i = 0; i < kARowsPerThread; ++i) {
        const int off = a_offset(s, a_m[i], a_oh[i], a_ow[i], k0 + col);
        cp_async16(as + ((tid >> 2) + 32 * i) * kAStride + col, x + (off < 0 ? 0 : off),
                   off >= 0);
      }
#pragma unroll
      for (int j = 0; j < kBChunksPerThread; ++j) {
        const int id = tid + kThreads * j;
        const int kr = id >> 3;
        const int nc = (id & 7) * 8;
        const int k = k0 + kr;
        const int n = n0 + nc;
        const bool ok = k < s.k && n < s.cout;
        cp_async16(bs + kr * kBStride + nc, w + (ok ? k * s.cout + n : 0), ok);
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int row = e / kBK;
        const int kk = e - row * kBK;
        const int m = m0 + row;
        bf16 v = __float2bfloat16_rn(0.0f);
        if (m < s.m) {
          const int off = a_offset(s, m, (m / s.w) % s.h, m % s.w, k0 + kk);
          if (off >= 0) v = x[off];
        }
        as[row * kAStride + kk] = v;
      }
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int kr = e / kBN;
        const int nn = e - kr * kBN;
        const int k = k0 + kr;
        const int n = n0 + nn;
        bs[kr * kBStride + nn] =
            (k < s.k && n < s.cout) ? w[k * s.cout + n] : __float2bfloat16_rn(0.0f);
      }
    }
  };

  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = (warp >> 1) * 64;
  const int wn = (warp & 1) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  const int kt_count = (s.k + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < kt_count) load_stage(st, st * kBK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt has landed; stage kt - 1 is free again
    const int next = kt + kStages - 1;
    if (next < kt_count) load_stage(next % kStages, next * kBK);
    cp_async_commit();

    const bf16* as = As[kt % kStages];
    const bf16* bs = Bs[kt % kStages];
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], as + (wm + mt * 16 + (lane & 15)) * kAStride + ks + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, bs + (ks + (lane & 7) + ((lane >> 3) & 1) * 8) * kBStride + wn + np * 16 +
                   (lane >> 4) * 8);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();

  // Epilogue: thread (g, t) of its warp holds rows g and g + 8 of each
  // 16 x 8 tile, columns 2t and 2t + 1.
  const int g = lane >> 2;
  const int t = lane & 3;
  float bv[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = n0 + wn + nt * 8 + 2 * t + q;
      bv[nt][q] = n < s.cout ? bias_at(bias, bias_f32, n) : 0.0f;
    }
  const bool pairs = (s.cout & 1) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + g + 8 * half;
      if (m >= s.m) continue;
      bf16* row = y + m * s.cout;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn + nt * 8 + 2 * t;
        const float v0 = lrelu(acc[mt][nt][2 * half] + bv[nt][0], s.slope);
        const float v1 = lrelu(acc[mt][nt][2 * half + 1] + bv[nt][1], s.slope);
        if (pairs && n + 1 < s.cout) {
          *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < s.cout) row[n] = __float2bfloat16_rn(v0);
          if (n + 1 < s.cout) row[n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// ---------------------------------------------------------- tma_wgmma path

constexpr int kTBM = 128;                          // output pixels per M tile
constexpr int kTBK = 64;                           // channels per k-block: 128 bytes of bf16
constexpr int kTConsumers = 2;                     // consumer warpgroups, 64 tile rows each
constexpr int kTThreads = 128 * kTConsumers + 32;  // and one producer warp
constexpr int kTABytes = kTBM * kTBK * 2;          // A per stage: 16 KB
constexpr int kTBBoxBytes = 64 * kTBK * 2;         // one 64 N x 64 K box of B: 8 KB
constexpr int kTSliceBytes = kTBM * 128;           // 64 output channels of the tile: 16 KB

template <int BN>
struct TmaTile {
  static constexpr int kStages = BN == 256 ? 4 : 3;
  static constexpr int kStageBytes = kTABytes + BN * kTBK * 2;
  static constexpr int kRingBytes = kStages * kStageBytes;
  // 1024 bytes of slack to align the ring (the 128-byte swizzle repeats
  // every 1024 bytes), the ring, and a full and an empty barrier per stage
  static constexpr int kSmemBytes = 1024 + kRingBytes + 2 * kStages * 8;
  // blocks per SM: three (73 KB, 75 registers) at BN 64, two (97 KB, 112
  // registers) at 128; the fastest of 3-6 stages and 1-3 blocks on the card
  static constexpr int kMinBlocks = BN == 64 ? 3 : (BN == 128 ? 2 : 1);
  static_assert(kRingBytes >= kTBM * BN * 2, "the y tile is staged in the drained ring");
};

struct TmaConv {
  int tiles_w, tiles_h, tiles_n;
  int rows, cols;  // the M tile's pixel rectangle
  int chunks;      // 64-channel chunks of Cin
  int cout;
  int bias_f32;
  float slope;
};

constexpr int kNoEncoder = 9999;      // cuTensorMapEncodeTiled not found
constexpr int kEncodeFailed = 10000;  // + the CUresult of a failed encode

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the barrier's phase of this parity has completed. A wait
// that outlasts 2^24 tries (far beyond any copy or product of a tile)
// traps, so a lost transfer fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile whose base
// is 1024-byte aligned (bits 0-13 address, 16-29 leading and 32-45 stride
// byte offset, all in 16-byte units; 62-63 the swizzle: 1 = 128 bytes).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int R>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x N, f32, in registers) += A (64 x 16, K-major) * B (16 x N,
// N-major: the transpose flag) from shared memory.
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__global__ void __launch_bounds__(kTThreads, TmaTile<BN>::kMinBlocks)
    conv3x3_tma_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w,
                             const __grid_constant__ CUtensorMap tm_y,
                             const void* __restrict__ bias, TmaConv p) {
  using Tile = TmaTile<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = ring + Tile::kRingBytes;  // full[s] at 8 s, empty[s] at 8 (kStages + s)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  int t = blockIdx.x;  // N tile fastest, then the tile's column, row and image
  const int n0 = (t % p.tiles_n) * BN;
  t /= p.tiles_n;
  const int ow0 = (t % p.tiles_w) * p.cols;
  t /= p.tiles_w;
  const int oh0 = (t % p.tiles_h) * p.rows;
  const int img = t / p.tiles_h;
  const int kblocks = 9 * p.chunks;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < Tile::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);                                // the producer's expect_tx
      mbar_init(bars + 8 * (Tile::kStages + s), kTConsumers);    // one arrival per warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kTConsumers) {
    // producer: one thread issues every TMA load of the tile
    if ((tid & 31) == 0) {
      for (int kb = 0; kb < kblocks; ++kb) {
        const int s = kb % Tile::kStages;
        // a fresh barrier passes parity 1 at once: the first round of the
        // ring is free
        mbar_wait(bars + 8 * (Tile::kStages + s), ((kb / Tile::kStages) & 1) ^ 1);
        const int tap = kb / p.chunks;
        const int c0 = (kb - tap * p.chunks) * kTBK;
        const int dh = tap / 3;
        const int dw = tap - 3 * dh;
        const uint32_t a = ring + s * Tile::kStageBytes;
        const uint32_t full = bars + 8 * s;
        mbar_expect_tx(full, Tile::kStageBytes);  // whole boxes, zero-filled parts included
        tma_load_4d(a, &tm_x, full, c0, ow0 + dw - 1, oh0 + dh - 1, img);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          tma_load_3d(a + kTABytes + j * kTBBoxBytes, &tm_w, full, n0 + 64 * j, c0, tap);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns tile rows 64 wg .. 64 wg + 63
  const int wg = warp >> 2;
  const int lane = tid & 31;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int kb = 0; kb < kblocks; ++kb) {
    const int s = kb % Tile::kStages;
    mbar_wait(bars + 8 * s, (kb / Tile::kStages) & 1);
    // A: 64 rows of 128 bytes from row 64 wg, 8-row groups 1024 bytes apart;
    // a K step of 16 channels moves 32 bytes along the swizzled row.
    // B: 64-row boxes of 64 N (128 bytes) each, 8 K rows 1024 bytes apart,
    // the next 64 N 8 KB on; a K step of 16 moves 16 rows, 2 KB.
    const uint32_t a = ring + s * Tile::kStageBytes + wg * (64 * 128);
    const uint32_t b = ring + s * Tile::kStageBytes + kTABytes;
    fence_acc<BN / 2>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTBK / 16; ++kk)
      wgmma_bf16<BN>(acc, smem_desc(a + 32 * kk, 16, 1024),
                     smem_desc(b + 2048 * kk, kTBBoxBytes, 1024));
    wgmma_commit();
    fence_acc<BN / 2>(acc);
    // the previous k-block's products are done: its stage may be refilled
    wgmma_wait<1>();
    if (kb > 0 && (tid & 127) == 0)
      mbar_arrive(bars + 8 * (Tile::kStages + (kb - 1) % Tile::kStages));
  }
  wgmma_wait<0>();
  fence_acc<BN / 2>(acc);

  // Epilogue. Both warpgroups are done with the ring (every stage landed
  // and was read), so it takes the bf16 y tile: 64-channel slices of 128
  // rows x 128 bytes, 128-byte swizzled as the TMA store reads them.
  // Thread (warp w, lane l) holds rows 16 w + l/4 (+ 8) of its warpgroup's
  // 64, columns 8 j + 2 (l % 4) (+ 1) of each 8-column block j.
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kTConsumers) : "memory");
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int swz = lane >> 2;  // row % 8, for both of the thread's rows
  const int q = lane & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * q;  // Cout is even: n < Cout covers n + 1
    const float b0 = n < p.cout ? bias_at(bias, p.bias_f32, n) : 0.0f;
    const float b1 = n < p.cout ? bias_at(bias, p.bias_f32, n + 1) : 0.0f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(lrelu(acc[4 * j + 2 * i] + b0, p.slope),
                                                     lrelu(acc[4 * j + 2 * i + 1] + b1, p.slope));
      const uint32_t dst = ring + (j >> 3) * kTSliceBytes + (row + 8 * i) * 128 +
                           (((j & 7) ^ swz) << 4) + 4 * q;
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst),
                   "r"(*reinterpret_cast<const uint32_t*>(&v))
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to the TMA unit
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kTConsumers) : "memory");
  if (tid == 0) {
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      if (n0 + 64 * j < p.cout)
        tma_store_4d(&tm_y, ring + j * kTSliceBytes, n0 + 64 * j, ow0, oh0, img);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // before shared memory goes
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(sym);
  }
  return fn;
}

// A bf16 tensor map: dims innermost first, byte strides of dims 1.., the
// box; 128-byte swizzle, zeros outside the tensor.
int encode_bf16(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kNoEncoder;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base),
                        dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int BN>
int launch_tma(const CUtensorMap& mx, const CUtensorMap& mw, const CUtensorMap& my,
               const void* bias, const TmaConv& p, unsigned int blocks, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a kernel must ask, once per device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(conv3x3_tma_wgmma_kernel<BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               TmaTile<BN>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  conv3x3_tma_wgmma_kernel<BN><<<blocks, kTThreads, TmaTile<BN>::kSmemBytes, st>>>(mx, mw, my,
                                                                                  bias, p);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------------- f32 path
//
// CUDA-core FMA, no TF32, so it can be held tightly to the plain version.
// Bound: the operations, 2 M 9 Cin Cout at 67 TFLOP/s (144 us at (8, 128,
// 128, 64 -> 64), where x and y move in 20 us), so the design keeps the FMA
// pipes fed and everything else off their issue slots:
// * A block computes a BM x BN tile with 256 threads of 8 x 8 outputs each
//   (256 x 64 for Cout <= 64, 128 x 128 beyond). Per 4-deep k step a thread
//   reads 8 float4 of A and 8 of B from shared memory for 256 FMAs: one
//   shared load per 16 FMAs (a 4 x 4 tile needs one per 8). That is still
//   the balance of an SM's 128 FMA lanes against its 128 bytes per clock
//   of shared memory, so the shared reads co-limit the kernel (on an H100
//   a copy that read B 4x less often ran 12% faster); a wider thread tile
//   needs more than the 128 registers of two blocks per SM.
// * K = 9 Cin runs tap by tap, 16 channels at a time. A table of each tile
//   row's in-image taps (a 9-bit word per pixel, made once per block) turns
//   the halo and the M tail into a bit test, and a row's source is its
//   pixel's offset plus one shift per step: no division per element.
// * Copies go through cp.async into a ring of 4 stages (16 bytes each,
//   past L1, zero-filled at the halo and the tails), so the loads of step
//   k + 3 overlap the FMAs of step k, with one barrier per step.
// * A lands as [pixel][channel] rows padded to 20 floats: the four pixel
//   rows a warp reads at one k step fall on distinct banks. B lands as
//   [k][n]; each thread's 8 columns are two float4 half a tile apart, so a
//   warp's reads are contiguous, and so are its float4 stores of y.
// * kVec = false (Cin or Cout not a multiple of 4, or x, w or y not
//   16-byte aligned) copies element by element with 4-byte cp.async into
//   the same ring and stores scalars.

constexpr int kFBK = 16;             // channels of one tap per k step
constexpr int kFThreads = 256;
constexpr int kFMinBlocks = 2;       // blocks per SM: at most 128 registers a thread
constexpr int kFStages = 4;
constexpr int kFAStride = kFBK + 4;  // floats per A row in shared memory (80 bytes)

template <int BN>
struct F32Tile {
  static constexpr int kBM = kFThreads * 64 / BN;  // 8 x 8 outputs a thread: 256 or 128 rows
  static_assert(kBM * 4 % kFThreads == 0 && kFBK * BN / 4 % kFThreads == 0, "whole copies");
  static constexpr int kTN = BN / 8;               // threads along N
  static constexpr int kTM = kFThreads / kTN;      // along M: kBM / 8
  static constexpr int kAFloats = kBM * kFAStride;
  static constexpr int kStageFloats = kAFloats + kFBK * BN;
  // the ring, then one tap word per tile row: 97 KB at BN 64, 72.5 KB at
  // 128, two blocks per SM
  static constexpr int kSmemBytes = (kFStages * kStageFloats + kBM) * 4;
};

// 4 bytes, zero-filled where !ok (cp.async.cg takes only 16-byte copies;
// those go through cp_async16, which bypasses L1: 2% faster on the card
// than through it, the nine taps' rereads coming from L2)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 4 : 0));
}

template <int BN, bool kVec>
__global__ void __launch_bounds__(kFThreads, kFMinBlocks)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const void* __restrict__ bias, int bias_f32, float* __restrict__ y,
                       ConvShape s) {
  using Tile = F32Tile<BN>;
  constexpr int BM = Tile::kBM;
  extern __shared__ __align__(16) float fsmem[];
  uint32_t* taps_of = reinterpret_cast<uint32_t*>(fsmem + kFStages * Tile::kStageFloats);

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % s.n_tiles) * BN;
  const int m0 = (blockIdx.x / s.n_tiles) * BM;

  // bit 3 dh + dw of a row's word: its pixel's tap (dh, dw) lies in the
  // image; no bit for a row past M
  for (int r = tid; r < BM; r += kFThreads) {
    const int m = m0 + r;
    uint32_t taps = 0;
    if (m < s.m) {
      const int ow = m % s.w;
      const int oh = (m / s.w) % s.h;
      const uint32_t cols = (ow > 0 ? 1u : 0u) | 2u | (ow + 1 < s.w ? 4u : 0u);
      taps = (oh > 0 ? cols : 0u) | cols << 3 | (oh + 1 < s.h ? cols << 6 : 0u);
    }
    taps_of[r] = taps;
  }
  __syncthreads();

  const int ksteps = 9 * ((s.cin + kFBK - 1) / kFBK);
  int ld_tap = 0, ld_c0 = 0;  // the next step to load: its tap and first channel

  auto load_stage = [&](int stage) {
    float* as = fsmem + stage * Tile::kStageFloats;
    float* bs = as + Tile::kAFloats;
    const int dh = ld_tap / 3;
    const int dw = ld_tap - 3 * dh;
    const int shift = ((dh - 1) * s.w + (dw - 1)) * s.cin + ld_c0;  // from a pixel's own row
    const float* wk = w + (ld_tap * s.cin + ld_c0) * s.cout + n0;
    if constexpr (kVec) {
      const int q = (tid & 3) * 4;
#pragma unroll
      for (int i = 0; i < BM * 4 / kFThreads; ++i) {
        const int r = (tid >> 2) + kFThreads / 4 * i;
        const bool ok = (taps_of[r] >> ld_tap & 1u) && ld_c0 + q < s.cin;
        cp_async16(as + r * kFAStride + q, ok ? x + (m0 + r) * s.cin + shift + q : x, ok);
      }
#pragma unroll
      for (int j = 0; j < kFBK * BN / 4 / kFThreads; ++j) {
        const int id = tid + kFThreads * j;
        const int kr = id / (BN / 4);
        const int nc = (id % (BN / 4)) * 4;
        const bool ok = ld_c0 + kr < s.cin && n0 + nc < s.cout;
        cp_async16(bs + kr * BN + nc, ok ? wk + kr * s.cout + nc : w, ok);
      }
    } else {
      // not unrolled: the rare path keeps to the registers the FMA loop leaves
      const int kk = tid % kFBK;
#pragma unroll 1
      for (int i = 0; i < BM * kFBK / kFThreads; ++i) {
        const int r = tid / kFBK + kFThreads / kFBK * i;
        const bool ok = (taps_of[r] >> ld_tap & 1u) && ld_c0 + kk < s.cin;
        cp_async4(as + r * kFAStride + kk, ok ? x + (m0 + r) * s.cin + shift + kk : x, ok);
      }
#pragma unroll 1
      for (int j = 0; j < kFBK * BN / kFThreads; ++j) {
        const int id = tid + kFThreads * j;
        const int kr = id / BN;
        const int nn = id % BN;
        const bool ok = ld_c0 + kr < s.cin && n0 + nn < s.cout;
        cp_async4(bs + kr * BN + nn, ok ? wk + kr * s.cout + nn : w, ok);
      }
    }
    ld_c0 += kFBK;
    if (ld_c0 >= s.cin) {
      ld_c0 = 0;
      ++ld_tap;
    }
  };

  // thread (tm, tn) owns rows tm + kTM i and columns 4 tn + (0..3), BN / 2
  // + 4 tn + (0..3)
  const int tn = tid % Tile::kTN;
  const int tm = tid / Tile::kTN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int st = 0; st < kFStages - 1; ++st) {  // ksteps >= 9 > kFStages - 1
    load_stage(st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ksteps; ++kt) {
    cp_async_wait<kFStages - 2>();
    __syncthreads();  // step kt has landed; the stage of step kt - 1 is free again
    if (kt + kFStages - 1 < ksteps) load_stage((kt + kFStages - 1) % kFStages);
    cp_async_commit();

    const float* as = fsmem + (kt % kFStages) * Tile::kStageFloats + tm * kFAStride;
    const float* bs = fsmem + (kt % kFStages) * Tile::kStageFloats + Tile::kAFloats + 4 * tn;
#pragma unroll
    for (int kq = 0; kq < kFBK; kq += 4) {
      float b[4][8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 lo = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN);
        const float4 hi = *reinterpret_cast<const float4*>(bs + (kq + kk) * BN + BN / 2);
        b[kk][0] = lo.x;
        b[kk][1] = lo.y;
        b[kk][2] = lo.z;
        b[kk][3] = lo.w;
        b[kk][4] = hi.x;
        b[kk][5] = hi.y;
        b[kk][6] = hi.z;
        b[kk][7] = hi.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(as + i * Tile::kTM * kFAStride + kq);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(a.x, b[0][j], acc[i][j]);
          acc[i][j] = fmaf(a.y, b[1][j], acc[i][j]);
          acc[i][j] = fmaf(a.z, b[2][j], acc[i][j]);
          acc[i][j] = fmaf(a.w, b[3][j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float bv[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + (j >> 2) * (BN / 2) + 4 * tn + (j & 3);
    bv[j] = n < s.cout ? bias_at(bias, bias_f32, n) : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + tm + Tile::kTM * i;
    if (m >= s.m) continue;
    float* row = y + m * s.cout;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + h * (BN / 2) + 4 * tn;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = lrelu(acc[i][4 * h + q] + bv[4 * h + q], s.slope);
      if constexpr (kVec) {
        if (n < s.cout)  // Cout % 4 == 0: n < Cout covers n + 3
          *reinterpret_cast<float4*>(row + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (n + q < s.cout) row[n + q] = v[q];
      }
    }
  }
}

template <int BN, bool kVec>
int launch_f32(const float* x, const float* w, const void* bias, int bias_f32, float* y,
               const ConvShape& s, unsigned int blocks, cudaStream_t st) {
  // above 48 KB of dynamic shared memory a kernel must ask, once per device
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(conv3x3_f32_kernel<BN, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F32Tile<BN>::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  conv3x3_f32_kernel<BN, kVec><<<blocks, kFThreads, F32Tile<BN>::kSmemBytes, st>>>(
      x, w, bias, bias_f32, y, s);
  return static_cast<int>(cudaGetLastError());
}

ConvShape make_shape(int b, int h, int w, int cin, int cout, float slope, int bn) {
  ConvShape s;
  s.h = h;
  s.w = w;
  s.cin = cin;
  s.cout = cout;
  s.m = b * h * w;
  s.k = 9 * cin;
  s.n_tiles = (cout + bn - 1) / bn;
  s.slope = slope;
  return s;
}

int blocks_for(const ConvShape& s, int bm, unsigned int* blocks) {
  const long long n = static_cast<long long>((s.m + bm - 1) / bm) * s.n_tiles;
  if (n < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = static_cast<unsigned int>(n);
  return 0;
}

}  // namespace

// x: contiguous (b, h, w, cin); wt: contiguous (3, 3, cin, cout); bias:
// (cout,) of f32 (bias_f32 = 1) or bf16 (0); y: contiguous (b, h, w, cout).
// The wrapper guarantees b*h*w*max(cin, cout) and 9*cin*cout below 2^31.
extern "C" int tpgan_conv3x3_bias_lrelu_bf16(const void* x, const void* wt, const void* bias,
                                             int bias_f32, void* y, int b, int h, int w, int cin,
                                             int cout, float slope, void* stream) {
  const ConvShape s = make_shape(b, h, w, cin, cout, slope, kBN);
  unsigned int blocks;
  const int err = blocks_for(s, kBM, &blocks);
  if (err) return err;
  const bool vec = cin % 8 == 0 && cout % 8 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt)) % 16 == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(wt);
  bf16* yp = static_cast<bf16*>(y);
  if (vec)
    conv3x3_bf16_kernel<true><<<blocks, kThreads, 0, st>>>(xp, wp, bias, bias_f32, yp, s);
  else
    conv3x3_bf16_kernel<false><<<blocks, kThreads, 0, st>>>(xp, wp, bias, bias_f32, yp, s);
  return static_cast<int>(cudaGetLastError());
}

// The f32 kernel; the wrapper's plan gives BN (64: 256 x 64 tiles; 128:
// 128 x 128) and vec (16-byte copies and stores: Cin and Cout multiples of
// 4 and x, wt and y 16-byte aligned; 0 copies element by element).
// Returns cudaErrorInvalidValue for a vec the call cannot take, another BN
// or a pointer that is not 4-byte aligned.
extern "C" int tpgan_conv3x3_bias_lrelu_f32(const void* x, const void* wt, const void* bias,
                                            int bias_f32, void* y, int b, int h, int w, int cin,
                                            int cout, int bn, int vec, float slope, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
                         reinterpret_cast<uintptr_t>(y);
  if (addr % 4 != 0 || (bn != 64 && bn != 128) ||
      (vec && (cin % 4 != 0 || cout % 4 != 0 || addr % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConvShape s = make_shape(b, h, w, cin, cout, slope, bn);
  unsigned int blocks;
  const int err = blocks_for(s, kFThreads * 64 / bn, &blocks);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(wt);
  float* yp = static_cast<float*>(y);
  if (bn == 64)
    return vec ? launch_f32<64, true>(xp, wp, bias, bias_f32, yp, s, blocks, st)
               : launch_f32<64, false>(xp, wp, bias, bias_f32, yp, s, blocks, st);
  return vec ? launch_f32<128, true>(xp, wp, bias, bias_f32, yp, s, blocks, st)
             : launch_f32<128, false>(xp, wp, bias, bias_f32, yp, s, blocks, st);
}

// The TMA + wgmma kernel; the wrapper's plan gives the M tile (rows x cols
// = 128 pixels, cols a power of two) and BN (64, 128 or 256). Takes bf16
// with Cin and Cout multiples of 8 and 16-byte-aligned x, wt and y, and
// returns cudaErrorInvalidValue for anything else.
extern "C" int tpgan_conv3x3_bias_lrelu_tma_wgmma(const void* x, const void* wt, const void* bias,
                                                  int bias_f32, void* y, int b, int h, int w,
                                                  int cin, int cout, int rows, int cols, int bn,
                                                  float slope, void* stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(wt) |
                         reinterpret_cast<uintptr_t>(y);
  if (b < 1 || h < 1 || w < 1 || cin < 8 || cout < 8 || cin % 8 != 0 || cout % 8 != 0 ||
      addr % 16 != 0 || rows < 1 || cols < 1 || rows * cols != kTBM || (cols & (cols - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  TmaConv p;
  p.rows = rows;
  p.cols = cols;
  p.tiles_w = (w + cols - 1) / cols;
  p.tiles_h = (h + rows - 1) / rows;
  p.tiles_n = (cout + bn - 1) / bn;
  p.chunks = (cin + kTBK - 1) / kTBK;
  p.cout = cout;
  p.bias_f32 = bias_f32;
  p.slope = slope;
  const long long blocks = static_cast<long long>(b) * p.tiles_h * p.tiles_w * p.tiles_n;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);

  const cuuint64_t e = 2;  // bytes per bf16
  const cuuint64_t xd[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w),
                            static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t xs[3] = {e * cin, e * cin * w, e * cin * w * h};
  const cuuint64_t yd[4] = {static_cast<cuuint64_t>(cout), xd[1], xd[2], xd[3]};
  const cuuint64_t ys[3] = {e * cout, e * cout * w, e * cout * w * h};
  const cuuint64_t wd[3] = {static_cast<cuuint64_t>(cout), static_cast<cuuint64_t>(cin), 9};
  const cuuint64_t ws[2] = {e * cout, e * cout * cin};
  const cuuint32_t pixel_box[4] = {kTBK, static_cast<cuuint32_t>(cols),
                                   static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t weight_box[3] = {64, kTBK, 1};
  CUtensorMap mx, mw, my;
  int err = encode_bf16(&mx, x, 4, xd, xs, pixel_box);
  if (!err) err = encode_bf16(&mw, wt, 3, wd, ws, weight_box);
  if (!err) err = encode_bf16(&my, y, 4, yd, ys, pixel_box);
  if (err) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned int nb = static_cast<unsigned int>(blocks);
  switch (bn) {
    case 64: return launch_tma<64>(mx, mw, my, bias, p, nb, st);
    case 128: return launch_tma<128>(mx, mw, my, bias, p, nb, st);
    case 256: return launch_tma<256>(mx, mw, my, bias, p, nb, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
