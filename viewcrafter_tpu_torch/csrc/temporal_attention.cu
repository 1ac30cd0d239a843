// Attention over the T frames of every (batch, pixel, head):
// softmax(q k^T d^-1/2) v on (B, T, N, D) tensors, N = pixels * heads.
// Replaces
// viewcrafter_tpu/ops/pallas/temporal_attention.py:temporal_attention_fused.
//
// One block of 4 warps per problem (b, n). The T rows of q, k and v of one
// problem are N * D elements apart; each is one contiguous D * 2 byte line,
// copied with 16-byte loads into shared memory, where rows T .. 16 NB - 1
// are zeros (T is never padded in device memory, and keys are exactly the T
// real frames: the block-diagonal packing of the TPU kernel exists to fill
// its 128 x 128 matrix unit and is not carried over). Warp w owns query rows
// 16 w .. 16 w + 15 (warps past the last row tile idle): Q K^T on the tensor
// cores (mma.sync m16n8k16) into f32 logits, scaled by d^-1/2 after the
// product; key columns >= T masked to -inf (column 0 is always real, so a
// row's maximum is finite); softmax normalised in f32, then rounded to bf16
// (the TPU kernel's rounding point); P V in f32; bf16 out. All T <= 64 keys
// fit one tile, so there is no online rescale. Bound:
// ops/kernels/temporal_attention.py.
#include "common.cuh"

namespace vc {

constexpr int TA_WARPS = 4, TA_THREADS = 32 * TA_WARPS;

// NB = ceil(T / 16) key blocks (1..4)
template <int D, int NB>
__global__ void __launch_bounds__(TA_THREADS)
temporal_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o, int T, long N,
                     float scale) {
  constexpr int LD = D + 8, TP = 16 * NB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [TP][LD] each
  bf16* sk = sq + TP * LD;
  bf16* sv = sk + TP * LD;
  const long n = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const long base = ((long)b * T * N + n) * D;  // frame t adds t * N * D

  for (int c = tid; c < TP * (D / 8); c += TA_THREADS) {
    const int t = c / (D / 8), cc = (c % (D / 8)) * 8;
    uint4 qu = zero_u4(), ku = zero_u4(), vu = zero_u4();
    if (t < T) {
      const long off = base + (long)t * N * D + cc;
      qu = *reinterpret_cast<const uint4*>(q + off);
      ku = *reinterpret_cast<const uint4*>(k + off);
      vu = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(sq + t * LD + cc) = qu;
    *reinterpret_cast<uint4*>(sk + t * LD + cc) = ku;
    *reinterpret_cast<uint4*>(sv + t * LD + cc) = vu;
  }
  __syncthreads();
  if (warp >= NB || warp * 16 >= T) return;

  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldmatrix_x4(qf[kc], sq + (warp * 16 + (lane % 16)) * LD + kc * 16 + (lane / 16) * 8);

  // s[j][e]: key column 8 j + 2 (lane % 4) + (e & 1), row lane / 4 + 8 (e / 2)
  float s[2 * NB][4];
#pragma unroll
  for (int j = 0; j < 2 * NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t kf[4];
      const int key = nb * 16 + (lane % 8) + (lane / 16) * 8;
      const int dd = kc * 16 + ((lane / 8) % 2) * 8;
      ldmatrix_x4(kf, sk + key * LD + dd);
      mma16816(s[nb * 2], qf[kc], kf[0], kf[1]);
      mma16816(s[nb * 2 + 1], qf[kc], kf[2], kf[3]);
    }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 2 * NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = j * 8 + (lane % 4) * 2 + (e & 1);
      s[j][e] = col < T ? s[j][e] * scale : -INFINITY;
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < 2 * NB; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __expf(s[j][e] - mx[e / 2]);  // exp(-inf) = 0 for masked keys
      sum[e / 2] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  float oacc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < NB; ++kc) {
    uint32_t pf[4];
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = 2 * kc + jj;
      pf[2 * jj] = pack_bf16(s[j][0] / sum[0], s[j][1] / sum[0]);
      pf[2 * jj + 1] = pack_bf16(s[j][2] / sum[1], s[j][3] / sum[1]);
    }
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t vf[4];
      const int key = kc * 16 + (lane % 8) + ((lane / 8) % 2) * 8;
      const int dd = nd * 16 + (lane / 16) * 8;
      ldmatrix_x4_trans(vf, sv + key * LD + dd);
      mma16816(oacc[nd * 2], pf, vf[0], vf[1]);
      mma16816(oacc[nd * 2 + 1], pf, vf[2], vf[3]);
    }
  }

  const int row0 = warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + (lane % 4) * 2;
    if (row0 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (long)row0 * N * D + col) =
          __floats2bfloat162_rn(oacc[j][0], oacc[j][1]);
    if (row0 + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (long)(row0 + 8) * N * D + col) =
          __floats2bfloat162_rn(oacc[j][2], oacc[j][3]);
  }
}

template <int D, int NB>
cudaError_t launch_temporal_attn(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                                 int T, long N, float scale, cudaStream_t stream) {
  constexpr size_t smem = (size_t)3 * 16 * NB * (D + 8) * sizeof(bf16);  // up to 51 KB
  cudaError_t err = cudaFuncSetAttribute(temporal_attn_kernel<D, NB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)N, (unsigned)B);
  temporal_attn_kernel<D, NB><<<grid, TA_THREADS, smem, stream>>>(q, k, v, o, T, N, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_temporal_attn(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                                   int T, long N, float scale, cudaStream_t stream) {
  switch ((T + 15) / 16) {
    case 1: return launch_temporal_attn<D, 1>(q, k, v, o, B, T, N, scale, stream);
    case 2: return launch_temporal_attn<D, 2>(q, k, v, o, B, T, N, scale, stream);
    case 3: return launch_temporal_attn<D, 3>(q, k, v, o, B, T, N, scale, stream);
    case 4: return launch_temporal_attn<D, 4>(q, k, v, o, B, T, N, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace vc

extern "C" int vc_temporal_attention(const void* q, const void* k, const void* v, void* o, int B,
                                     int T, long N, int D, float scale, void* stream) {
  using namespace vc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T < 1 || T > 64 || N < 1 || N > 2147483647L) return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  if (D == 64) return (int)dispatch_temporal_attn<64>(qb, kb, vb, ob, B, T, N, scale, s);
  if (D == 128) return (int)dispatch_temporal_attn<128>(qb, kb, vb, ob, B, T, N, scale, s);
  return (int)cudaErrorInvalidValue;
}
