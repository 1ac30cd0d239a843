// Shared building blocks of the port's kernels: bf16 and PTX helpers, the
// LayerNorm kernel, and one tiled bf16 GEMM with f32 accumulation on the
// tensor cores (mma.sync m16n8k16 fed by ldmatrix), parameterised by
// operand-source functors and an epilogue functor.
//
// GEMM: C[M, N] = A[M, K] * B[N, K]^T. A is addressed through a functor that
// maps (row, k) to the address of 8 consecutive bf16, B row by row through a
// functor. Either may answer nullptr for zeros. Requirements: K % 8 == 0 and
// 16-byte aligned operands. The temporal and spatial layers' projections run
// on it; the temporal conv and the FF layer run on gemm_sm90.cuh.
// Tile 128 x 128 x 32, 8 warps (2 x 4), each warp 64 x 32 outputs held in
// registers; a 4-stage cp.async pipeline feeds shared memory; the epilogue
// works on the accumulator fragments in registers.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 zero_u4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}
// 16 bytes from gmem, or zeros for nullptr (a plain shared store)
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* gmem) {
  if (gmem != nullptr) cp_async16(smem, gmem);
  else *reinterpret_cast<uint4*>(smem) = zero_u4();
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D(16x8, f32) += A(16x16, bf16, row) * B(16x8, bf16, col). Fragment layout
// (g = lane / 4, t = lane % 4): D[0..1] at row g, cols 2t..2t+1; D[2..3] at
// row g + 8.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// LayerNorm over the last axis, f32 statistics in two passes (mean, then the
// mean of squared deviations, as the TPU kernels), written back as bf16:
// y = bf16(((x - mu) * rsqrt(var + eps)) * w + b). One warp per row; C % 8 == 0.
// ---------------------------------------------------------------------------
static __global__ void ln_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                                       const float* __restrict__ b, bf16* __restrict__ y,
                                       long rows, int C, float eps) {
  const long row = (long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  float s = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
  const float m = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - m;
      v += d * d;
    }
  }
  const float r = rsqrtf(warp_sum(v) / C + eps);
  for (int c = lane * 8; c < C; c += 256) {
    uint4 u = *reinterpret_cast<const uint4*>(xr + c);
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16(((__bfloat162float(e[i]) - m) * r) * w[c + i] + b[c + i]);
    *reinterpret_cast<uint4*>(y + row * C + c) = u;
  }
}

inline cudaError_t launch_ln_apply(const bf16* x, const float* w, const float* b, bf16* y,
                                   long rows, int C, float eps, cudaStream_t stream) {
  const int warps = 8;
  ln_apply_kernel<<<(unsigned)((rows + warps - 1) / warps), warps * 32, 0, stream>>>(
      x, w, b, y, rows, C, eps);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Operand sources: each returns the address of 8 consecutive bf16 (16 bytes)
// in device memory, or nullptr for zeros.
// ---------------------------------------------------------------------------

// A is a plain row-major (M, K) bf16 matrix.
struct ASrcPlain {
  const bf16* a;
  int K;
  __device__ __forceinline__ const bf16* operator()(long row, int k) const {
    return a + row * K + k;
  }
};

// B row functor for a plain row-major (N, K) weight.
struct BRowPlain {
  const bf16* w;
  int N, K;
  __device__ __forceinline__ const bf16* operator()(int n) const {
    return n < N ? w + (long)n * K : nullptr;
  }
};

// ---------------------------------------------------------------------------
// GEMM geometry and the accumulator fragment an epilogue receives: warp tile
// 64 x 32 = 4 m16 tiles x 4 n8 tiles; acc[i][j][e] holds row
// row0 + 16 i + g + 8 (e / 2) and column col0 + 8 j + 2 t + (e % 2), with
// g = lane / 4, t = lane % 4 and (row0, col0) the warp tile's origin.
// ---------------------------------------------------------------------------
constexpr int GEMM_BM = 128, GEMM_BN = 128, GEMM_BK = 32, GEMM_STAGES = 4;
constexpr int GEMM_LDS = GEMM_BK + 8;   // bf16 row stride: conflict-free ldmatrix
constexpr int GEMM_THREADS = 256;
constexpr int GEMM_WM = 64, GEMM_WN = 32;
constexpr int GEMM_STAGE_ELEMS = (GEMM_BM + GEMM_BN) * GEMM_LDS;  // A then B tile
constexpr size_t GEMM_SMEM = (size_t)GEMM_STAGES * GEMM_STAGE_ELEMS * sizeof(bf16);

using Acc = float[4][4][4];

// Epilogue with bias, writing bf16 rows of width N (N % 8 == 0):
//   BIAS_NONE:  out = bf16(acc)
//   BIAS_F32:   out = bf16(acc + bias)              (f32 add, one rounding)
//   BIAS_ROUND: out = bf16(bf16(acc) + bias)        (bias added in bf16)
enum BiasMode { BIAS_NONE = 0, BIAS_F32 = 1, BIAS_ROUND = 2 };

struct EpiBias {
  bf16* out;
  const bf16* bias;
  long M;
  int N;
  int mode;
  __device__ __forceinline__ float apply(float a, int col) const {
    if (mode == BIAS_F32) return a + __bfloat162float(bias[col]);
    if (mode == BIAS_ROUND) return bf16_round(a) + __bfloat162float(bias[col]);
    return a;
  }
  __device__ __forceinline__ void operator()(const Acc& acc, long row0, int col0, int lane) const {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + 8 * j + 2 * (lane % 4);
        if (col >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long row = row0 + 16 * i + lane / 4 + 8 * h;
          if (row >= M) continue;
          *reinterpret_cast<uint32_t*>(out + row * N + col) =
              pack_bf16(apply(acc[i][j][2 * h], col), apply(acc[i][j][2 * h + 1], col + 1));
        }
      }
  }
};

// ---------------------------------------------------------------------------
// The GEMM kernel. Grid: (ceil(M / 128), number of 128-wide column blocks).
// ---------------------------------------------------------------------------
template <class ASrc, class BRow, class Epi>
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(long M, int K, ASrc asrc, BRow brow, Epi epi) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);  // [STAGES][A BM x LDS | B BN x LDS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int wm = warp / 4, wn = warp % 4;
  const long m0 = (long)blockIdx.x * GEMM_BM;
  const int n0 = blockIdx.y * GEMM_BN;
  const int ktiles = (K + GEMM_BK - 1) / GEMM_BK;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // one K tile into one stage: each thread copies two 16-byte chunks of A
  // and two of B
  auto load_stage = [&](int kt, int stage) {
    bf16* sA = stages + stage * GEMM_STAGE_ELEMS;
    bf16* sB = sA + GEMM_BM * GEMM_LDS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * GEMM_THREADS;
      const int r = c >> 2, kk = (c & 3) * 8;
      const long gm = m0 + r;
      const int gk = kt * GEMM_BK + kk;
      cp_async16_or_zero(sA + r * GEMM_LDS + kk, (gm < M && gk < K) ? asrc(gm, gk) : nullptr);
      const bf16* bp = brow(n0 + r);
      cp_async16_or_zero(sB + r * GEMM_LDS + kk, (bp != nullptr && gk < K) ? bp + gk : nullptr);
    }
  };

#pragma unroll
  for (int st = 0; st < GEMM_STAGES - 1; ++st) {
    if (st < ktiles) load_stage(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<GEMM_STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1
    const int nk = kt + GEMM_STAGES - 1;
    if (nk < ktiles) load_stage(nk, nk % GEMM_STAGES);
    cp_async_commit();
    const bf16* sA = stages + (kt % GEMM_STAGES) * GEMM_STAGE_ELEMS + wm * GEMM_WM * GEMM_LDS;
    const bf16* sB = stages + (kt % GEMM_STAGES) * GEMM_STAGE_ELEMS + GEMM_BM * GEMM_LDS +
                     wn * GEMM_WN * GEMM_LDS;
#pragma unroll
    for (int kk = 0; kk < GEMM_BK; kk += 16) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(af[i], sA + (16 * i + lane % 16) * GEMM_LDS + kk + (lane / 16) * 8);
#pragma unroll
      for (int p = 0; p < 2; ++p)
        ldmatrix_x4(bfr[p], sB + (16 * p + lane % 8 + (lane / 16) * 8) * GEMM_LDS + kk +
                                ((lane / 8) % 2) * 8);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          mma16816(acc[i][2 * p], af[i], bfr[p][0], bfr[p][1]);
          mma16816(acc[i][2 * p + 1], af[i], bfr[p][2], bfr[p][3]);
        }
    }
  }
  cp_async_wait<0>();
  epi(acc, m0 + wm * GEMM_WM, n0 + wn * GEMM_WN, lane);
}

template <class ASrc, class BRow, class Epi>
cudaError_t launch_gemm(long M, int n_blocks, int K, ASrc asrc, BRow brow, Epi epi,
                        cudaStream_t stream) {
  auto kern = gemm_kernel<ASrc, BRow, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)GEMM_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((M + GEMM_BM - 1) / GEMM_BM), (unsigned)n_blocks);
  kern<<<grid, GEMM_THREADS, GEMM_SMEM, stream>>>(M, K, asrc, brow, epi);
  return cudaGetLastError();
}

inline int col_blocks(int N) { return (N + GEMM_BN - 1) / GEMM_BN; }

}  // namespace vc
