// Fused 3x3 convolution + bias + LeakyReLU for NVIDIA Hopper (sm_90a),
// NHWC input, HWIO weight, plain C ABI for ctypes. Forward only.
//
// Replaces: tpgan_tpu/ops/pallas_kernels.py, conv3x3_bias_lrelu_pallas
// (kernel body _make_conv3x3_kernel). Python wrapper, plain PyTorch version,
// cuDNN yardstick and launch counter: tpgan_tpu_torch/ops/kernels.py.
//
// What it computes, for x (B, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout):
//   acc[b,h,w,n] = sum_{dh,dw,c} xz[b, h+dh-1, w+dw-1, c] * w[dh,dw,c,n]   (f32)
//   y = acc + f32(bias[n]);  y = y >= 0 ? y : slope * y   (NaN stays NaN)
// with xz = x inside the image and 0 outside (stride 1, SAME), stored once
// in x's dtype.
//
// Design: an implicit GEMM with M = B*H*W output pixels, N = Cout and
// K = 9*Cin in HWIO order, k = (3*dh + dw)*Cin + c. In that order the weight
// is a contiguous K x N row-major matrix, and row m of A is the 3x3
// neighbourhood of pixel m: the loads compute each tap's source pixel and
// read the halo and every tail as zeros, so no padded copy of x is made
// (the TPU kernel padded x with jnp.pad first). Bias and LeakyReLU are
// applied to the f32 accumulators in registers; each output is written once.
//
// * bf16: tensor cores through mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   A block computes a 128 x 64 output tile with 4 warps of 64 x 32; K moves
//   in steps of 32 through a three-stage ring of shared-memory tiles filled
//   by cp.async (16-byte copies, zero-filled at the halo and the tails) when
//   Cin and Cout are multiples of 8, else by guarded scalar loads. Fragments
//   come from shared memory through ldmatrix (rows padded by 16 bytes, so
//   the eight row addresses of each 8x8 matrix hit distinct banks).
// * f32: CUDA-core FMA (no TF32, so it can be held tightly to the plain
//   version): a 64 x 64 tile per block, 4 x 4 outputs per thread, K steps of
//   16 through shared memory.
//
// Bound, at the A/B's dominant shape (8, 128, 128, 64 -> 64) in bf16: x read
// once and y written once, 33.6 MB in 10.0 us at 3.35 TB/s, against 9.66
// GFLOP in 9.8 us at 989 TFLOP/s: bytes, barely. At (8, 64, 64, 128 -> 128)
// and (32, 32, 32, 256 -> 256) the operations bound it. In f32 on CUDA cores
// (67 TFLOP/s) the first shape's floor is 144 us.
//
// Index math is 32-bit: the wrapper raises where B*H*W*max(Cin, Cout) or
// 9*Cin*Cout would not fit. The shape struct is read only by field name, so
// ptxas keeps it in the constant bank (no stack frame). The kernels launch
// on the caller's stream, do not synchronise and allocate nothing; each
// entry point returns cudaGetLastError().

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

// ---------------------------------------------------------------- bf16 path

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

// ----------------------------------------------------------------- f32 path

constexpr int kFBM = 64;
constexpr int kFBN = 64;
constexpr int kFBK = 16;
constexpr int kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                       const void* __restrict__ bias, int bias_f32, float* __restrict__ y,
                       ConvShape s) {
  __shared__ __align__(16) float As[kFBK][kFBM + 4];  // A transposed: [k][m]
  __shared__ __align__(16) float Bs[kFBK][kFBN];

  const int tid = threadIdx.x;
  const int n0 = (blockIdx.x % s.n_tiles) * kFBN;
  const int m0 = (blockIdx.x / s.n_tiles) * kFBM;
  const int ty = tid >> 4;  // output rows 4*ty ..
  const int tx = tid & 15;  // output columns 4*tx ..

  // loads: A column kk of rows (tid >> 4) + 16 i; B row (tid >> 6) + 4 j,
  // column tid & 63
  const int kk = tid & 15;
  int a_m[4], a_oh[4], a_ow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 4) + 16 * i;
    a_m[i] = m;
    a_ow[i] = m % s.w;
    a_oh[i] = m < s.m ? (m / s.w) % s.h : -4;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < s.k; k0 += kFBK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = a_offset(s, a_m[i], a_oh[i], a_ow[i], k0 + kk);
      As[kk][(tid >> 4) + 16 * i] = off >= 0 ? x[off] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kr = (tid >> 6) + 4 * j;
      const int k = k0 + kr;
      const int n = n0 + (tid & 63);
      Bs[kr][tid & 63] = (k < s.k && n < s.cout) ? w[k * s.cout + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kFBK; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(&As[q][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[q][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bw[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int n = n0 + 4 * tx + j;
    if (n >= s.cout) continue;
    const float bj = bias_at(bias, bias_f32, n);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + 4 * ty + i;
      if (m < s.m) y[m * s.cout + n] = lrelu(acc[i][j] + bj, s.slope);
    }
  }
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

extern "C" int tpgan_conv3x3_bias_lrelu_f32(const void* x, const void* wt, const void* bias,
                                            int bias_f32, void* y, int b, int h, int w, int cin,
                                            int cout, float slope, void* stream) {
  const ConvShape s = make_shape(b, h, w, cin, cout, slope, kFBN);
  unsigned int blocks;
  const int err = blocks_for(s, kFBM, &blocks);
  if (err) return err;
  conv3x3_f32_kernel<<<blocks, kFThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wt), bias, bias_f32,
      static_cast<float*>(y), s);
  return static_cast<int>(cudaGetLastError());
}
