// Non-causal, unmasked softmax attention, flash style.
// Replaces viewcrafter_tpu/ops/pallas/fullkv_attention.py:fullkv_attention.
//
// q, k, v, o: (B, S, H, D) bf16, D in {64, 128}; each may be a column block
// of a wider row-major buffer (the fused spatial layer's (B*S, 3C) Q|K|V),
// so the kernel takes the row strides. One block of 4 warps per
// (query tile, head, batch); each warp owns MT x 16 query rows (MT = 2 at
// D = 64, so every K/V fragment loaded from shared memory feeds two MMAs;
// MT = 1 at D = 128, for registers). The query tile is scaled by
// d^-1/2 * log2(e) and rounded back to bf16 on load (the TPU kernel's q
// fold, fullkv_attention.py:196-198), so the softmax runs in base 2. K/V
// tiles of 64 keys stream through shared memory with cp.async double
// buffering. QK^T and PV use mma.sync m16n8k16 (bf16 in, f32 accumulate);
// the online softmax (running max, rescale, f32 row sums) stays in
// registers; P goes to bf16 for PV; the division by the row sum comes last.
// Keys past Sk are masked to -inf and their V rows zero-filled, so any Sk is
// exact. Bound: ops/kernels/fullkv_attention.py.
#include "common.cuh"

namespace vc {

constexpr int FA_BKV = 64, FA_WARPS = 4, FA_THREADS = 32 * FA_WARPS;

template <int D>
struct FaShape {
  static constexpr int MT = D == 64 ? 2 : 1;  // m16 tiles per warp
  static constexpr int BQ = FA_WARPS * 16 * MT;
  static constexpr int LD = D + 8;            // 16-byte padded rows: conflict-free ldmatrix
  static constexpr size_t SMEM = (size_t)(BQ + 4 * FA_BKV) * LD * sizeof(bf16);
};

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
fullkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              bf16* __restrict__ o, int Sq, int Sk, long q_rs, long kv_rs, long o_rs,
              float qscale) {
  constexpr int MT = FaShape<D>::MT, BQ = FaShape<D>::BQ, LD = FaShape<D>::LD;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + BQ * LD;                        // [2][BKV][LD]
  bf16* sV = sK + 2 * FA_BKV * LD;                // [2][BKV][LD]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  // row strides in elements: H * D for packed (B, S, H, D) tensors
  const bf16* qb = q + (long)b * Sq * q_rs + h * D;
  const bf16* kb = k + (long)b * Sk * kv_rs + h * D;
  const bf16* vb = v + (long)b * Sk * kv_rs + h * D;

  // query tile: scale, round to bf16, store
  for (int c = tid; c < BQ * (D / 8); c += FA_THREADS) {
    const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
    const int gq = qt * BQ + r;
    uint4 u = zero_u4();
    if (gq < Sq) {
      u = *reinterpret_cast<const uint4*>(qb + (long)gq * q_rs + cc);
      bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(__bfloat162float(e[i]) * qscale);
    }
    *reinterpret_cast<uint4*>(sQ + r * LD + cc) = u;
  }

  auto load_kv = [&](int tile, int buf) {
    bf16* dK = sK + buf * FA_BKV * LD;
    bf16* dV = sV + buf * FA_BKV * LD;
    for (int c = tid; c < FA_BKV * (D / 8); c += FA_THREADS) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      const int gk = tile * FA_BKV + r;
      if (gk < Sk) {
        cp_async16(dK + r * LD + cc, kb + (long)gk * kv_rs + cc);
        cp_async16(dV + r * LD + cc, vb + (long)gk * kv_rs + cc);
      } else {
        *reinterpret_cast<uint4*>(dK + r * LD + cc) = zero_u4();
        *reinterpret_cast<uint4*>(dV + r * LD + cc) = zero_u4();
      }
    }
    cp_async_commit();
  };

  const int ntiles = (Sk + FA_BKV - 1) / FA_BKV;
  load_kv(0, 0);
  __syncthreads();  // sQ complete

  uint32_t qf[MT][D / 16][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      ldmatrix_x4(qf[mt][kc],
                  sQ + ((warp * MT + mt) * 16 + (lane % 16)) * LD + kc * 16 + (lane / 16) * 8);

  float oacc[MT][D / 8][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      oacc[mt][j][0] = oacc[mt][j][1] = oacc[mt][j][2] = oacc[mt][j][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      load_kv(t + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + buf * FA_BKV * LD;
    const bf16* cV = sV + buf * FA_BKV * LD;

    // S = Q K^T for this warp's rows x 64 keys (base-2 logits)
    float s[MT][FA_BKV / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < FA_BKV / 8; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int nb = 0; nb < FA_BKV / 16; ++nb) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t kf[4];
        const int key = nb * 16 + (lane % 8) + (lane / 16) * 8;
        const int dd = kc * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(kf, cK + key * LD + dd);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(s[mt][nb * 2], qf[mt][kc], kf[0], kf[1]);
          mma16816(s[mt][nb * 2 + 1], qf[mt][kc], kf[2], kf[3]);
        }
      }
    }
    const int kbase = t * FA_BKV;
    if (kbase + FA_BKV > Sk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < FA_BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kbase + j * 8 + (lane % 4) * 2 + (e & 1) >= Sk) s[mt][j][e] = -INFINITY;
    }

    // online softmax; per m16 tile this thread holds rows g = lane/4
    // (e = 0, 1) and g + 8 (e = 2, 3)
    uint32_t pf[MT][FA_BKV / 16][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {m_run[mt][0], m_run[mt][1]};
#pragma unroll
      for (int j = 0; j < FA_BKV / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      const float alpha0 = exp2f(m_run[mt][0] - mx[0]), alpha1 = exp2f(m_run[mt][1] - mx[1]);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < FA_BKV / 8; ++j) {
        const float p0 = exp2f(s[mt][j][0] - mx[0]), p1 = exp2f(s[mt][j][1] - mx[0]);
        const float p2 = exp2f(s[mt][j][2] - mx[1]), p3 = exp2f(s[mt][j][3] - mx[1]);
        rsum[0] += p0 + p1;
        rsum[1] += p2 + p3;
        pf[mt][j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
        pf[mt][j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
        rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      }
      l_run[mt][0] = l_run[mt][0] * alpha0 + rsum[0];
      l_run[mt][1] = l_run[mt][1] * alpha1 + rsum[1];
      m_run[mt][0] = mx[0];
      m_run[mt][1] = mx[1];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        oacc[mt][j][0] *= alpha0;
        oacc[mt][j][1] *= alpha0;
        oacc[mt][j][2] *= alpha1;
        oacc[mt][j][3] *= alpha1;
      }
    }

    // O += P V
#pragma unroll
    for (int kc = 0; kc < FA_BKV / 16; ++kc) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t vf[4];
        const int key = kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int dd = nd * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(vf, cV + key * LD + dd);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(oacc[mt][nd * 2], pf[mt][kc], vf[0], vf[1]);
          mma16816(oacc[mt][nd * 2 + 1], pf[mt][kc], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }

  bf16* ob = o + (long)b * Sq * o_rs + h * D;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const float inv0 = 1.f / l_run[mt][0], inv1 = 1.f / l_run[mt][1];
    const int row0 = qt * BQ + (warp * MT + mt) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * o_rs + col) =
            __floats2bfloat162_rn(oacc[mt][j][0] * inv0, oacc[mt][j][1] * inv0);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)(row0 + 8) * o_rs + col) =
            __floats2bfloat162_rn(oacc[mt][j][2] * inv1, oacc[mt][j][3] * inv1);
    }
  }
}

template <int D>
cudaError_t launch_fullkv(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Sq,
                          int Sk, int H, long q_rs, long kv_rs, long o_rs, float qscale,
                          cudaStream_t stream) {
  using Shape = FaShape<D>;
  cudaError_t err = cudaFuncSetAttribute(fullkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Shape::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Sq + Shape::BQ - 1) / Shape::BQ), (unsigned)H, (unsigned)B);
  fullkv_kernel<D><<<grid, FA_THREADS, Shape::SMEM, stream>>>(q, k, v, o, Sq, Sk, q_rs, kv_rs,
                                                              o_rs, qscale);
  return cudaGetLastError();
}

}  // namespace vc

// Row strides in elements (multiples of 8: rows start 16-byte aligned); the
// batch stride of each tensor is its sequence length times its row stride.
extern "C" int vc_fullkv_attention_strided(const void* q, const void* k, const void* v, void* o,
                                           int B, int Sq, int Sk, int H, int D, long q_rs,
                                           long kv_rs, long o_rs, float qscale, void* stream) {
  using namespace vc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  if (q_rs % 8 || kv_rs % 8 || o_rs % 8) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)launch_fullkv<64>(qb, kb, vb, ob, B, Sq, Sk, H, q_rs, kv_rs, o_rs, qscale, s);
  if (D == 128)
    return (int)launch_fullkv<128>(qb, kb, vb, ob, B, Sq, Sk, H, q_rs, kv_rs, o_rs, qscale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int vc_fullkv_attention(const void* q, const void* k, const void* v, void* o, int B,
                                   int Sq, int Sk, int H, int D, float qscale, void* stream) {
  const long rs = (long)H * D;
  return vc_fullkv_attention_strided(q, k, v, o, B, Sq, Sk, H, D, rs, rs, rs, qscale, stream);
}
