// Dual-stream cross-attention: softmax(q k_text^T s) v_text +
// softmax(q k_img^T s) v_img in one kernel.
// Replaces viewcrafter_tpu/ops/pallas/cross_attention.py:dual_cross_attention.
//
// q, o: (B, Sq, H, D) bf16; k/v_text: (B, Lt, H, D); k/v_img: (B, Li, H, D);
// D in {64, 128}. Grid (query chunks, H, B), 8 warps. The block copies the
// keys and values of its (b, h), text rows then image rows, into shared
// memory, zero-padded to Lp = a multiple of 16 keys, and keeps them there
// while it walks its run of 128-row query tiles; each warp owns 16 rows.
// Pass 1 computes the f32 logits 16 keys at a time (mma.sync m16n8k16),
// scales them by d^-1/2 after the product (as the TPU kernel) and keeps a
// running (max, sum) pair per stream and row. Pass 2 recomputes the same
// logits, forms exp(l - max) / sum of the column's stream (0 for a padded
// column), rounds the normalised probability to bf16 (the TPU kernel's
// rounding point) and accumulates P V in f32 for both streams at once.
// "No maximum yet" is a finite sentinel and columns outside a stream add an
// explicit 0, so no -inf minus -inf can arise. Bound:
// ops/kernels/cross_attention.py.
#include "common.cuh"

namespace vc {

constexpr int CA_WARPS = 8, CA_THREADS = 32 * CA_WARPS, CA_BQ = 16 * CA_WARPS;
constexpr float CA_NONE = -1e30f;

template <int D>
__global__ void __launch_bounds__(CA_THREADS)
dual_cross_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                  const bf16* __restrict__ vt, const bf16* __restrict__ ki,
                  const bf16* __restrict__ vi, bf16* __restrict__ o, int Sq, int Lt, int Li,
                  int H, int tiles_per_block, float scale) {
  constexpr int LD = D + 8;  // 16-byte padded rows: conflict-free ldmatrix
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int L = Lt + Li, Lp = (L + 15) / 16 * 16;
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* sK = sQ + CA_BQ * LD;                     // [Lp][LD]
  bf16* sV = sK + Lp * LD;                        // [Lp][LD]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const long rs = (long)H * D;
  const bf16* qb = q + (long)b * Sq * rs + h * D;
  bf16* ob = o + (long)b * Sq * rs + h * D;

  for (int c = tid; c < Lp * (D / 8); c += CA_THREADS) {
    const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
    uint4 ku = zero_u4(), vu = zero_u4();
    if (r < Lt) {
      const long off = ((long)b * Lt + r) * rs + h * D + cc;
      ku = *reinterpret_cast<const uint4*>(kt + off);
      vu = *reinterpret_cast<const uint4*>(vt + off);
    } else if (r < L) {
      const long off = ((long)b * Li + (r - Lt)) * rs + h * D + cc;
      ku = *reinterpret_cast<const uint4*>(ki + off);
      vu = *reinterpret_cast<const uint4*>(vi + off);
    }
    *reinterpret_cast<uint4*>(sK + r * LD + cc) = ku;
    *reinterpret_cast<uint4*>(sV + r * LD + cc) = vu;
  }

  const int ntiles = (Sq + CA_BQ - 1) / CA_BQ;
  const int t0 = blockIdx.x * tiles_per_block, t1 = min(ntiles, t0 + tiles_per_block);
  const int nblocks = Lp / 16;

  for (int qt = t0; qt < t1; ++qt) {
    __syncthreads();  // K/V stored (first tile); every warp done with the last sQ
    for (int c = tid; c < CA_BQ * (D / 8); c += CA_THREADS) {
      const int r = c / (D / 8), cc = (c % (D / 8)) * 8;
      const int gq = qt * CA_BQ + r;
      uint4 u = zero_u4();
      if (gq < Sq) u = *reinterpret_cast<const uint4*>(qb + (long)gq * rs + cc);
      *reinterpret_cast<uint4*>(sQ + r * LD + cc) = u;
    }
    __syncthreads();

    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      ldmatrix_x4(qf[kc], sQ + (warp * 16 + (lane % 16)) * LD + kc * 16 + (lane / 16) * 8);

    // scaled logits of this warp's 16 rows against keys 16 nb .. 16 nb + 15:
    // s[j][e], column 16 nb + 8 j + 2 (lane % 4) + (e & 1), row lane / 4 + 8 (e / 2)
    auto logits = [&](int nb, float (&s)[2][4]) {
#pragma unroll
      for (int j = 0; j < 2; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) {
        uint32_t kf[4];
        const int key = nb * 16 + (lane % 8) + (lane / 16) * 8;
        const int dd = kc * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(kf, sK + key * LD + dd);
        mma16816(s[0], qf[kc], kf[0], kf[1]);
        mma16816(s[1], qf[kc], kf[2], kf[3]);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    };

    // pass 1: running max and sum per stream (0 text, 1 image) and row
    float m_run[2][2], l_run[2][2];
#pragma unroll
    for (int sg = 0; sg < 2; ++sg)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m_run[sg][r] = CA_NONE;
        l_run[sg][r] = 0.f;
      }
    for (int nb = 0; nb < nblocks; ++nb) {
      float s[2][4];
      logits(nb, s);
#pragma unroll
      for (int sg = 0; sg < 2; ++sg) {
        const int lo = sg == 0 ? 0 : Lt, hi = sg == 0 ? Lt : L;
        if (nb * 16 >= hi || nb * 16 + 16 <= lo) continue;  // uniform over the warp
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float bm = CA_NONE;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = nb * 16 + j * 8 + (lane % 4) * 2 + e;
              if (col >= lo && col < hi) bm = fmaxf(bm, s[j][2 * r + e]);
            }
          const float mn = fmaxf(m_run[sg][r], bm);
          float acc = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = nb * 16 + j * 8 + (lane % 4) * 2 + e;
              if (col >= lo && col < hi) acc += __expf(s[j][2 * r + e] - mn);
            }
          l_run[sg][r] = l_run[sg][r] * __expf(m_run[sg][r] - mn) + acc;
          m_run[sg][r] = mn;
        }
      }
    }
    // a row's columns are spread over the 4 lanes of a quad: merge them. Each
    // stream has at least one key, so the merged maximum is a real logit.
#pragma unroll
    for (int sg = 0; sg < 2; ++sg)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float m = m_run[sg][r];
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        float l = l_run[sg][r] * __expf(m_run[sg][r] - m);
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        m_run[sg][r] = m;
        l_run[sg][r] = l;
      }

    // pass 2: normalised probabilities in bf16, O += P V
    float oacc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
    for (int nb = 0; nb < nblocks; ++nb) {
      float s[2][4];
      logits(nb, s);
      uint32_t pf[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nb * 16 + j * 8 + (lane % 4) * 2 + (e & 1), r = e / 2;
          const int sg = col < Lt ? 0 : 1;
          p[e] = col < L ? __expf(s[j][e] - m_run[sg][r]) / l_run[sg][r] : 0.f;
        }
        pf[2 * j] = pack_bf16(p[0], p[1]);
        pf[2 * j + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t vf[4];
        const int key = nb * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
        const int dd = nd * 16 + (lane / 16) * 8;
        ldmatrix_x4_trans(vf, sV + key * LD + dd);
        mma16816(oacc[nd * 2], pf, vf[0], vf[1]);
        mma16816(oacc[nd * 2 + 1], pf, vf[2], vf[3]);
      }
    }

    const int row0 = qt * CA_BQ + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + (lane % 4) * 2;
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)row0 * rs + col) =
            __floats2bfloat162_rn(oacc[j][0], oacc[j][1]);
      if (row0 + 8 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long)(row0 + 8) * rs + col) =
            __floats2bfloat162_rn(oacc[j][2], oacc[j][3]);
    }
  }
}

template <int D>
cudaError_t launch_dual_cross(const bf16* q, const bf16* kt, const bf16* vt, const bf16* ki,
                              const bf16* vi, bf16* o, int B, int Sq, int Lt, int Li, int H,
                              int tiles_per_block, float scale, cudaStream_t stream) {
  const int Lp = (Lt + Li + 15) / 16 * 16;
  const size_t smem = (size_t)(CA_BQ + 2 * Lp) * (D + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(dual_cross_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + CA_BQ - 1) / CA_BQ;
  dim3 grid((unsigned)((ntiles + tiles_per_block - 1) / tiles_per_block), (unsigned)H,
            (unsigned)B);
  dual_cross_kernel<D><<<grid, CA_THREADS, smem, stream>>>(q, kt, vt, ki, vi, o, Sq, Lt, Li, H,
                                                           tiles_per_block, scale);
  return cudaGetLastError();
}

}  // namespace vc

extern "C" int vc_dual_cross_attention(const void* q, const void* kt, const void* vt,
                                       const void* ki, const void* vi, void* o, int B, int Sq,
                                       int Lt, int Li, int H, int D, int tiles_per_block,
                                       float scale, void* stream) {
  using namespace vc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Lt < 1 || Li < 1 || Lt + Li > 512 || tiles_per_block < 1) return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* ktb = static_cast<const bf16*>(kt);
  const bf16* vtb = static_cast<const bf16*>(vt);
  const bf16* kib = static_cast<const bf16*>(ki);
  const bf16* vib = static_cast<const bf16*>(vi);
  bf16* ob = static_cast<bf16*>(o);
  if (D == 64)
    return (int)launch_dual_cross<64>(qb, ktb, vtb, kib, vib, ob, B, Sq, Lt, Li, H,
                                      tiles_per_block, scale, s);
  if (D == 128)
    return (int)launch_dual_cross<128>(qb, ktb, vtb, kib, vib, ob, B, Sq, Lt, Li, H,
                                       tiles_per_block, scale, s);
  return (int)cudaErrorInvalidValue;
}
