// Temporal self-attention layer: LayerNorm -> QKV -> attention over the T
// frames of each (pixel, head) -> out projection + bias (no residual).
// Replaces viewcrafter_tpu/ops/pallas/temporal_layer.py:fused_temporal_layer.
//
// The model width C and the attention width inner = heads * D are apart:
// Wqkv is (3 inner, C) and Wo (C, inner). Unsharded inner == C; a tensor-
// parallel rank holds a block of the heads (inner < C), and its output is a
// partial sum of the out projection.
//
// Four launches:
//  1. the LayerNorm (common.cuh: f32 statistics, bf16 out) into xn (N, C);
//  2. the QKV product xn Wqkv^T on the GEMM core (gemm_sm90.cuh: TMA,
//     mbarrier ring, wgmma, persistent), Q|K|V rounded to bf16 into
//     (N, 3 inner), rows (b, t, s);
//  3. the frame attention on the tensor cores (below) into att (N, inner);
//  4. the out projection att Wo^T on the GEMM core, the bias added in bf16
//     (bf16(acc) + bo, as the TPU kernel).
//
// The frame attention. Q|K|V is mapped as a 4-D tensor (3 inner columns, T
// frames, S pixels, B): frames inside pixels, the reverse of its memory
// order, so that one TMA box (64 columns, 32 frames, TL_PIX pixels) lands in
// shared memory as one block of 32 rows per pixel, the frames past T
// zero-filled. A block of TL_PIX warps takes one (head, pixel tile, batch),
// the head fastest so that neighbouring blocks read neighbouring 128-byte
// pieces of the same rows: one box each of q, k and v per 64 columns of the
// head, one mbarrier. Warp w takes pixel w, 16 query rows at a time: Q K^T
// with mma.sync m16n8k16 fed by ldmatrix over all 32 key rows, f32 logits
// times d^-1/2 after the product, keys >= T masked, softmax in f32, the
// probabilities normalised and then rounded to bf16 (the TPU kernel's
// rounding point, not fullkv's deferred division), P V in f32 with P from
// registers, the output rounded to bf16 over the warp's own q rows in shared
// memory. One TMA store per 64 columns writes the block's tile to att, mapped
// the same way; the store writes no frame past T and no pixel past S.
//
// What bounds it: per row of x the four launches move 12 C elements (x in;
// xn out and in; Q|K|V out and in; att out and in; out), 3.54 GB at the
// flagship ds1 site (2, 25, 9216, 320), ~1.06 ms at 3.35 TB/s, against the
// function's own bound of 0.40 ms of operations. A design that keeps Q|K|V
// on chip, the attention in the QKV product's epilogue on the GEMM core
// (A: 4-D boxes of 4 whole pixels of xn; B: one head's 192 q, k and v rows;
// two consumer warpgroups), was no faster over a UNet eval: the tensor cores
// idle through the attention epilogue, and padding the frames to 32 adds 28%
// to the product at T = 25 (PERF.md). Bound: ops/kernels/temporal_layer.py.
#include "gemm_sm90.cuh"

namespace vc {

constexpr int TL_FRAMES = 32;  // rows per pixel in shared memory: T <= 32
constexpr int TL_PIX = 4;      // pixels per block, one warp each
constexpr int TL_THREADS = 32 * TL_PIX;

template <int D>
struct FrameTile {
  static constexpr int PANEL = TL_PIX * TL_FRAMES * 128;  // one 64-column panel
  static constexpr int TILE = (D / 64) * PANEL;            // q, k or v of the block
  static constexpr size_t SMEM = 1024 + 3 * (size_t)TILE + 16;
};

// 16-byte chunk c (8 columns; c / 8 picks the panel) of row r of a tile of
// 128-byte swizzled panels
__device__ __forceinline__ bf16* swz(unsigned char* tile, int panel_bytes, int r, int c) {
  return reinterpret_cast<bf16*>(tile + (c >> 3) * panel_bytes + r * 128 +
                                 (((c & 7) ^ (r & 7)) << 4));
}

// One warp's share of a pixel's frame attention: query rows 16 mh ..
// 16 mh + 15 of the pixel whose 32 rows start at row r0 of the q, k and v
// tiles (128-byte swizzled panels of `panel` bytes; frames past T are zeros
// there). The output, rounded to bf16, goes over those q rows, which no other
// warp reads.
template <int D>
__device__ __forceinline__ void frame_attention_warp(unsigned char* sq, unsigned char* sk,
                                                     unsigned char* sv, int panel, int r0, int mh,
                                                     int T, float scale, int lane) {
  // s[j][e]: key 8 j + 2 (lane % 4) + (e & 1), query row 16 mh + lane / 4 + 8 (e / 2)
  float s[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t qf[4];
    ldmatrix_x4(qf, swz(sq, panel, r0 + 16 * mh + (lane & 15), 2 * kc + (lane >> 4)));
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t kf[4];
      ldmatrix_x4(kf, swz(sk, panel, r0 + 16 * nb + (lane & 7) + ((lane >> 4) << 3),
                          2 * kc + ((lane >> 3) & 1)));
      mma16816(s[2 * nb], qf, kf[0], kf[1]);
      mma16816(s[2 * nb + 1], qf, kf[2], kf[3]);
    }
  }

  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = j * 8 + (lane & 3) * 2 + (e & 1);
      s[j][e] = key < T ? s[j][e] * scale : -INFINITY;  // key 0 is real: a finite maximum
      mx[e / 2] = fmaxf(mx[e / 2], s[j][e]);
    }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = __expf(s[j][e] - mx[e / 2]);  // 0 for a masked key
      sum[e / 2] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 2; ++kc) {  // keys 16 kc .. 16 kc + 15
    if (kc * 16 >= T) break;
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
      ldmatrix_x4_trans(vf, swz(sv, panel, r0 + 16 * kc + (lane & 7) + (((lane >> 3) & 1) << 3),
                                2 * nd + (lane >> 4)));
      mma16816(o[2 * nd], pf, vf[0], vf[1]);
      mma16816(o[2 * nd + 1], pf, vf[2], vf[3]);
    }
  }

  __syncwarp();  // every lane's q fragments are loaded before any row is overwritten
  const int row = r0 + 16 * mh + (lane >> 2);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 2 * (lane & 3);
    *reinterpret_cast<__nv_bfloat162*>(swz(sq, panel, row, j) + col) =
        __floats2bfloat162_rn(o[j][0], o[j][1]);
    *reinterpret_cast<__nv_bfloat162*>(swz(sq, panel, row + 8, j) + col) =
        __floats2bfloat162_rn(o[j][2], o[j][3]);
  }
}

template <int D>
__global__ void __launch_bounds__(TL_THREADS)
frame_attention_kernel(const __grid_constant__ CUtensorMap map_qkv,
                       const __grid_constant__ CUtensorMap map_att, int T, int inner,
                       float scale) {
  using Sh = FrameTile<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sk = sq + Sh::TILE;
  unsigned char* sv = sk + Sh::TILE;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sv + Sh::TILE);
  const int h = blockIdx.x, s0 = blockIdx.y * TL_PIX, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
    mbar_expect_tx(bar, 3 * Sh::TILE);
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn) {
      const int col = h * D + pn * 64;
      tma_load_4d(sq + pn * Sh::PANEL, map_qkv, bar, col, 0, s0, b);
      tma_load_4d(sk + pn * Sh::PANEL, map_qkv, bar, inner + col, 0, s0, b);
      tma_load_4d(sv + pn * Sh::PANEL, map_qkv, bar, 2 * inner + col, 0, s0, b);
    }
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  mbar_wait(bar, 0);

  // warp w: pixel s0 + w, rows 32 w .. 32 w + 31 of each panel
  for (int mh = 0; mh * 16 < T; ++mh)
    frame_attention_warp<D>(sq, sk, sv, Sh::PANEL, warp * TL_FRAMES, mh, T, scale, lane);

  fence_async_shared();  // every thread's output rows visible to the TMA store
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int pn = 0; pn < D / 64; ++pn)
      tma_store_4d(map_att, sq + pn * Sh::PANEL, h * D + pn * 64, 0, s0, b);
    tma_store_commit();
    tma_store_wait_read();  // the tile stays in shared memory until read
  }
}

template <int D>
cudaError_t launch_frame_attention(const CUtensorMap& map_qkv, const CUtensorMap& map_att, int B,
                                   int T, int S, int inner, float scale, cudaStream_t stream) {
  using Sh = FrameTile<D>;
  static bool smem_set[64];
  cudaError_t err = allow_smem_once((const void*)frame_attention_kernel<D>, (int)Sh::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)(inner / D), (unsigned)((S + TL_PIX - 1) / TL_PIX), (unsigned)B);
  frame_attention_kernel<D><<<grid, TL_THREADS, Sh::SMEM, stream>>>(map_qkv, map_att, T, inner,
                                                                     scale);
  return cudaGetLastError();
}

}  // namespace vc

extern "C" int vc_temporal_layer(const void* x, const void* ln_w, const void* ln_b,
                                 const void* wqkv, const void* wo, const void* bo, void* xn,
                                 void* qkv, void* att, void* out, int B, int T, int S, int C,
                                 int heads, int D, float eps, float scale, void* stream) {
  using namespace vc;
  constexpr int BN = 160;
  const int inner = heads * D;
  if (T < 1 || T > TL_FRAMES || (D != 64 && D != 128) || heads < 1 || C < 8 || C % 8 ||
      (S + TL_PIX - 1) / TL_PIX > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long M = (long)B * T * S;
  CUtensorMap m_xn, m_wqkv, m_qkv, m_att_out, m_att, m_wo;
  // Q|K|V and att as (columns, T, S, B): frames inside pixels
  const long qkv_dims[4] = {3L * inner, T, S, B},
             qkv_strides[3] = {3L * inner * S, 3L * inner, 3L * inner * S * T};
  const long att_dims[4] = {inner, T, S, B},
             att_strides[3] = {(long)inner * S, inner, (long)inner * S * T};
  const int box[4] = {64, TL_FRAMES, TL_PIX, 1};
  cudaError_t err = make_panel_map(&m_xn, xn, C, M, 1, C, G_BM);
  if (err == cudaSuccess) err = make_panel_map(&m_wqkv, wqkv, C, 3L * inner, 1, C, BN);
  if (err == cudaSuccess) err = make_map(&m_qkv, qkv, 4, qkv_dims, qkv_strides, box);
  if (err == cudaSuccess) err = make_map(&m_att_out, att, 4, att_dims, att_strides, box);
  if (err == cudaSuccess) err = make_panel_map(&m_att, att, inner, M, 1, inner, G_BM);
  if (err == cudaSuccess) err = make_panel_map(&m_wo, wo, inner, C, 1, inner, BN);
  if (err == cudaSuccess)
    err = launch_ln_apply(static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
                          static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, C, eps, s);
  if (err != cudaSuccess) return (int)err;

  const int row_blocks = (int)((M + G_BM - 1) / G_BM);
  err = launch_gemm_sm90<BN>(m_xn, m_wqkv, GemmTiles{1, M, row_blocks, (3 * inner + BN - 1) / BN},
                             LoadPlain<BN>{(C + 63) / 64},
                             EpiBiasOut<BN>{static_cast<bf16*>(qkv), nullptr, M, 3 * inner,
                                            BIAS_NONE}, s);
  if (err != cudaSuccess) return (int)err;
  err = D == 64 ? launch_frame_attention<64>(m_qkv, m_att_out, B, T, S, inner, scale, s)
                : launch_frame_attention<128>(m_qkv, m_att_out, B, T, S, inner, scale, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm_sm90<BN>(
      m_att, m_wo, GemmTiles{1, M, row_blocks, (C + BN - 1) / BN}, LoadPlain<BN>{(inner + 63) / 64},
      EpiBiasOut<BN>{static_cast<bf16*>(out), static_cast<const bf16*>(bo), M, C, BIAS_ROUND}, s);
}
