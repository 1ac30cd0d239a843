// Shared building blocks of the port's kernels: bf16 and warp helpers, the
// mma.sync m16n8k16 tensor-core fragment instructions fed by ldmatrix (the
// frame attentions of the temporal layer and of temporal_attention_fused),
// and the LayerNorm kernel that the temporal, spatial and FF layers run
// before their products. The products themselves run on gemm_sm90.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace vc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ uint4 zero_u4() { return make_uint4(0u, 0u, 0u, 0u); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
// y = bf16(((x - mu) * rsqrt(var + eps)) * w + b). One warp per row, the row
// held in registers: lane l loads its NV = ceil(C / 256) 16-byte vectors
// (l, l + 32, ...) at once, so a warp keeps all its loads in flight, and
// the weights and biases come in 16-byte loads too (a pass over the row per
// statistic, one vector at a time, with scalar weight loads, ran at about
// half the memory rate). The sums run in the same order as a loop over the
// row. C % 8 == 0, C <= 4096.
// ---------------------------------------------------------------------------
template <int NV>
__global__ void __launch_bounds__(256)
ln_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, bf16* __restrict__ y, long rows, int C, float eps) {
  const long row = (long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const bf16* xr = x + row * C;
  uint4 u[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (lane + 32 * k) * 8;
    u[k] = c < C ? *reinterpret_cast<const uint4*>(xr + c) : zero_u4();
  }
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if ((lane + 32 * k) * 8 >= C) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&u[k]);
#pragma unroll
    for (int i = 0; i < 8; ++i) s += __bfloat162float(e[i]);
  }
  const float m = warp_sum(s) / C;
  float v = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    if ((lane + 32 * k) * 8 >= C) continue;
    const bf16* e = reinterpret_cast<const bf16*>(&u[k]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float d = __bfloat162float(e[i]) - m;
      v += d * d;
    }
  }
  const float r = rsqrtf(warp_sum(v) / C + eps);
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = (lane + 32 * k) * 8;
    if (c >= C) continue;
    bf16* e = reinterpret_cast<bf16*>(&u[k]);
    float wv[8], bv[8];  // two 16-byte loads each (w and b are 16-byte aligned)
    *reinterpret_cast<float4*>(wv) = *reinterpret_cast<const float4*>(w + c);
    *reinterpret_cast<float4*>(wv + 4) = *reinterpret_cast<const float4*>(w + c + 4);
    *reinterpret_cast<float4*>(bv) = *reinterpret_cast<const float4*>(b + c);
    *reinterpret_cast<float4*>(bv + 4) = *reinterpret_cast<const float4*>(b + c + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      e[i] = __float2bfloat16(((__bfloat162float(e[i]) - m) * r) * wv[i] + bv[i]);
    *reinterpret_cast<uint4*>(y + row * C + c) = u[k];
  }
}

template <int NV>
cudaError_t launch_ln_rows(const bf16* x, const float* w, const float* b, bf16* y, long rows,
                           int C, float eps, cudaStream_t stream) {
  ln_apply_kernel<NV><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(x, w, b, y, rows, C, eps);
  return cudaGetLastError();
}

inline cudaError_t launch_ln_apply(const bf16* x, const float* w, const float* b, bf16* y,
                                   long rows, int C, float eps, cudaStream_t stream) {
  switch ((C + 255) / 256) {
    case 1: return launch_ln_rows<1>(x, w, b, y, rows, C, eps, stream);
    case 2: return launch_ln_rows<2>(x, w, b, y, rows, C, eps, stream);
    case 3: return launch_ln_rows<3>(x, w, b, y, rows, C, eps, stream);
    case 4: return launch_ln_rows<4>(x, w, b, y, rows, C, eps, stream);
    case 5: return launch_ln_rows<5>(x, w, b, y, rows, C, eps, stream);
    case 6: case 7: case 8: return launch_ln_rows<8>(x, w, b, y, rows, C, eps, stream);
    case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
      return launch_ln_rows<16>(x, w, b, y, rows, C, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vc
