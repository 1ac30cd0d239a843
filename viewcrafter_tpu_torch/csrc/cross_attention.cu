// Dual-stream cross-attention for Hopper: softmax(q k_text^T s) v_text +
// softmax(q k_img^T s) v_img in one kernel, s = d^-1/2.
// Replaces viewcrafter_tpu/ops/pallas/cross_attention.py:dual_cross_attention.
//
// q, o: (B, Sq, H, D) bf16; k/v_text: (B, Lt, H, D); k/v_img: (B, Li, H, D);
// D in {64, 128}, Lt + Li <= 512. Semantics of the TPU kernel: f32 logits of
// the bf16 q and k, each stream its own max, exp, sum and normalisation in
// f32, the *normalised* probabilities rounded to bf16, one f32 P [v_text;
// v_img] accumulation for both streams, rounded to bf16.
//
// Bound (H100 SXM, ds1 site q (50, 9216, 5, 64), Lt 77, Li 256): 0.196 TFLOP,
// 0.20 ms of tensor work, 0.18 ms of bytes, and 0.77e9 exponentials (0.21 ms
// on the MUFU if they do not overlap the products).
//
// Grid (query chunks, H, B); a block of two warpgroups walks a run of
// 128-row query tiles of one (b, h), each warpgroup owning 64 rows of every
// tile. Thread 0 loads K and V of both streams by TMA into shared memory
// once, in 16-row boxes (rows past a stream's end read as zeros); each
// warpgroup keeps its own ring of query tiles in flight (TMA + mbarrier),
// refilled by its thread 0 as soon as its products have read a tile. There
// is no producer warpgroup: with wgmma in the kernel, ptxas (CUDA 12.8)
// budgets every thread of a 3-warpgroup block at 168 registers whatever
// setmaxnreg asks, and the flagship path below needs ~220; two warpgroups
// get 255.
//  - The flagship's shapes (D = 64, 65-80 text keys, 193-256 image keys) hold
//    both streams' logits in registers at once: text as one m64n80 wgmma
//    accumulator, image as one m64n256 (both operands in shared memory). The
//    two Q K^T products are issued together; the text softmax (columns past
//    Lt masked, row max by quad shuffles, one exp2 per logit with
//    d^-1/2 log2 e folded into the one multiply, row sum, its reciprocal)
//    runs under the image product; P = bf16(p / sum) is packed in registers
//    as the A operand of O += P V (wgmma, V read transposed from shared
//    memory), and the image softmax runs under the text P V. Both streams
//    accumulate into the same O.
//  - Other shapes take each stream in turn, in 64-key chunks: up to 256 keys
//    (128 at D = 128) in one pass, a longer stream (the gate allows one; no
//    driven path has one) in two passes over groups of chunks, max and sum
//    first (online), then the logits again for P V.
#include <type_traits>

#include "hopper.cuh"

namespace vc {

constexpr int CA_BQ = 128, CA_THREADS = 256, CA_KV_BOX = 16;
constexpr int CA_PAD = 48 * 128;  // the most a last 64-key chunk reads past its 16-row buffer
constexpr int CA_Q_PANEL = 64 * 128;  // bytes of one 64-column panel of a warpgroup's 64 query rows
constexpr float CA_LOG2E = 1.4426950408889634f;

// ---- one consumer warpgroup's work on one stream, 64 query rows ----------
// In s[c][e] (the m64n64 accumulator of chunk c) this thread holds rows
// g = lane / 4 (e % 4 < 2) and g + 8, column 8 (e / 4) + 2 (lane % 4) + e % 2.

// S of NC chunks of 64 keys, the first at key k0 (K rows from dk), masked
// past the stream's L keys
template <int D, int NC>
__device__ __forceinline__ void ca_qk(float (&s)[4][32], uint64_t dq, uint64_t dk, int R, int k0,
                                      int L, int lane) {
  wg_fence();
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int p = kk / 4, ko = (kk % 4) * 32;
      const uint64_t a = wg_desc_plus(dq, p * CA_Q_PANEL + ko);
      const uint64_t b = wg_desc_plus(dk, (p * R + 64 * c) * 128 + ko);
      if (kk == 0) wgmma_ss_init<64>(s[c], a, b);
      else wgmma_ss<64>(s[c], a, b, 1);
    }
  wg_commit();
  wg_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) reg_fence(s[c]);
  if (k0 + 64 * NC > L) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (k0 + 64 * c + 8 * (e / 4) + 2 * (lane % 4) + (e & 1) >= L) s[c][e] = -INFINITY;
  }
}

// running max m and sum l (this thread's share) over NC more chunks of raw
// logits; leaves in s their exponentials against the new max
template <int NC>
__device__ __forceinline__ void ca_stats(float (&s)[4][32], float (&m)[2], float (&l)[2], float c2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], s[c][e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    l[r] *= ex2((m[r] - mx[r]) * c2);  // 0 on the first chunks (m = -inf)
    m[r] = mx[r];
  }
  const float mc[2] = {mx[0] * c2, mx[1] * c2};
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[c][e] = ex2(fmaf(s[c][e], c2, -mc[(e / 2) & 1]));
      l[(e / 2) & 1] += s[c][e];
    }
}

// A fragment of keys 16 kk .. 16 kk + 15: bf16(p * inv)
template <int R>
__device__ __forceinline__ void ca_pack(const float (&s)[R], int kk, const float (&inv)[2],
                                        uint32_t (&a)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack2(s[8 * kk + 2 * r] * inv[r & 1], s[8 * kk + 2 * r + 1] * inv[r & 1]);
}

// O += P V for NC chunks (V rows from dv), P = bf16(p * inv) with p the
// exponentials in s (EXPD) or computed here from raw logits against m
template <int D, int NC, bool EXPD>
__device__ __forceinline__ void ca_pv(float (&o)[D / 2], float (&s)[4][32], const float (&m)[2],
                                      const float (&inv)[2], float c2, uint64_t dv) {
  const float mc[2] = {m[0] * c2, m[1] * c2};
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if constexpr (!EXPD) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[c][e] = ex2(fmaf(s[c][e], c2, -mc[(e / 2) & 1]));
    }
    uint32_t pf[4][4];  // A fragments of keys 64 c + 16 kk .. + 15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ca_pack(s[c], kk, inv, pf[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_vt<D>(o, pf[kk], wg_desc_plus(dv, (64 * c + 16 * kk) * 128));
  }
  wg_commit();
  wg_wait<0>();
  reg_fence(o);
}

// calls f(std::integral_constant<int, n>) for a runtime n in 1 .. G
template <int G, class F>
__device__ __forceinline__ void ca_with_chunks(int n, F&& f) {
  if (n == 1) f(std::integral_constant<int, 1>{});
  if constexpr (G >= 2) if (n == 2) f(std::integral_constant<int, 2>{});
  if constexpr (G >= 3) if (n == 3) f(std::integral_constant<int, 3>{});
  if constexpr (G >= 4) if (n == 4) f(std::integral_constant<int, 4>{});
}

// one stream of L keys (K and V buffers of R rows per panel) into o
template <int D>
__device__ __forceinline__ void ca_stream(float (&o)[D / 2], float (&s)[4][32], uint64_t dq,
                                          const unsigned char* sk, const unsigned char* sv,
                                          int R, int L, int lane, float c2) {
  constexpr int G = D == 64 ? 4 : 2;  // chunks the registers hold at once
  const int nch = (L + 63) / 64;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
  auto finish = [&]() {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
  };
  const uint64_t dk = wg_desc_here(wg_desc(sk, 16, 1024));
  const uint64_t dv = wg_desc_here(wg_desc(sv, R * 128, 1024));
  if (nch <= G) {  // one pass: one exponential per logit
    ca_with_chunks<G>(nch, [&](auto n) {
      ca_qk<D, decltype(n)::value>(s, dq, dk, R, 0, L, lane);
      ca_stats<decltype(n)::value>(s, m, l, c2);
      finish();
      ca_pv<D, decltype(n)::value, true>(o, s, m, inv, c2, dv);
    });
  } else {  // two passes over groups of G chunks
    for (int k0 = 0; k0 < L; k0 += 64 * G) {
      ca_with_chunks<G>(min(G, nch - k0 / 64), [&](auto n) {
        ca_qk<D, decltype(n)::value>(s, dq, wg_desc_plus(dk, k0 * 128), R, k0, L, lane);
        ca_stats<decltype(n)::value>(s, m, l, c2);
      });
    }
    finish();
    for (int k0 = 0; k0 < L; k0 += 64 * G) {
      ca_with_chunks<G>(min(G, nch - k0 / 64), [&](auto n) {
        ca_qk<D, decltype(n)::value>(s, dq, wg_desc_plus(dk, k0 * 128), R, k0, L, lane);
        ca_pv<D, decltype(n)::value, false>(o, s, m, inv, c2, wg_desc_plus(dv, k0 * 128));
      });
    }
  }
}

// ---- the flagship's shapes at D = 64: 65-80 text keys, 193-256 image keys -
// Both streams' logits are in registers at once (text as one m64n80
// accumulator, image as one m64n256), so the text softmax runs under the
// image Q K^T and the image softmax under the text P V.

// this thread's share of one softmax over an accumulator of R / 2 columns,
// masked past L: exponentials in place, 1 / row sum in inv
template <int R>
__device__ __forceinline__ void ca_softmax_whole(float (&s)[R], int L, int lane, float c2,
                                                 float (&inv)[2]) {
  if (R * 2 > L) {
#pragma unroll
    for (int e = 0; e < R; ++e)
      if (8 * (e / 4) + 2 * (lane % 4) + (e & 1) >= L) s[e] = -INFINITY;
  }
  float mx[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < R; ++e) mx[(e / 2) & 1] = fmaxf(mx[(e / 2) & 1], s[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] *= c2;
  }
#pragma unroll
  for (int e = 0; e < R; ++e) {
    s[e] = ex2(fmaf(s[e], c2, -mx[(e / 2) & 1]));
    l[(e / 2) & 1] += s[e];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / l[r];
  }
}

template <class Refill>
__device__ __forceinline__ void ca_tile_flagship(float (&o)[32], uint64_t dq, uint64_t dkt,
                                                 uint64_t dki, uint64_t dvt, uint64_t dvi, int Lt,
                                                 int Li, int lane, float c2, Refill&& refill) {
  float st[40], si[128], inv_t[2], inv_i[2];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk == 0) wgmma_ss_init<80>(st, dq, dkt);
    else wgmma_ss<80>(st, wg_desc_plus(dq, 32 * kk), wg_desc_plus(dkt, 32 * kk), 1);
  }
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk == 0) wgmma_ss_init<256>(si, dq, dki);
    else wgmma_ss<256>(si, wg_desc_plus(dq, 32 * kk), wg_desc_plus(dki, 32 * kk), 1);
  }
  wg_commit();
  wg_wait<1>();  // text logits in; the image product runs on
  reg_fence(st);
  ca_softmax_whole(st, Lt, lane, c2, inv_t);
  uint32_t pt[5][4];
#pragma unroll
  for (int kk = 0; kk < 5; ++kk) ca_pack(st, kk, inv_t, pt[kk]);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 5; ++kk) wgmma_rs_vt<64>(o, pt[kk], wg_desc_plus(dvt, kk * 2048));
  wg_commit();
  wg_wait<1>();  // image logits in; the text P V runs on
  reg_fence(si);
  refill();  // the query tile is read no more
  ca_softmax_whole(si, Li, lane, c2, inv_i);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t pi[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) ca_pack(si, 4 * c + kk, inv_i, pi[kk]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_vt<64>(o, pi[kk], wg_desc_plus(dvi, (64 * c + 16 * kk) * 128));
  }
  wg_commit();
  wg_wait<0>();
  reg_fence(o);
}

template <int D>
__global__ void __launch_bounds__(CA_THREADS, 1)
dual_cross_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_kt,
                  const __grid_constant__ CUtensorMap map_vt,
                  const __grid_constant__ CUtensorMap map_ki,
                  const __grid_constant__ CUtensorMap map_vi, bf16* __restrict__ o, int Sq,
                  int Lt, int Li, int H, int tiles_per_block, int q_stages, float scale) {
  constexpr int PANELS = D / 64, QW = PANELS * CA_Q_PANEL;  // one warpgroup's query rows
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // the query rings ([2 warpgroups][q_stages][PANELS][64 rows][128 B]), then
  // stream buffers of Rt / Ri rows (Lt / Li rounded up to 16) per panel, in
  // the order K text, K img, V text, V img, then CA_PAD zeroed bytes: a
  // 64-key chunk that runs past its buffer's end reads the next buffer or
  // the pad (finite values, times a masked logit or a zero probability)
  const int Rt = (Lt + 15) / 16 * 16, Ri = (Li + 15) / 16 * 16;
  unsigned char* sQ = base;
  unsigned char* sKt = sQ + 2 * q_stages * QW;
  unsigned char* sKi = sKt + PANELS * Rt * 128;
  unsigned char* sVt = sKi + PANELS * Ri * 128;
  unsigned char* sVi = sVt + PANELS * Rt * 128;
  unsigned char* pad = sVi + PANELS * Ri * 128;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(pad + CA_PAD);
  uint64_t* q_full = kv_full + 1;  // [2][q_stages]

  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, tw = tid % 128, warp = tw / 32, lane = tid & 31;
  const int w = __shfl_sync(0xffffffffu, tid / 128, 0);  // warpgroup, uniform over the warp
  const int ntiles = (Sq + CA_BQ - 1) / CA_BQ;
  const int t0 = blockIdx.x * tiles_per_block, t1 = min(ntiles, t0 + tiles_per_block);
  unsigned char* myQ = sQ + w * q_stages * QW;
  uint64_t* my_full = q_full + w * q_stages;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < 2 * q_stages; ++s) mbar_init(q_full + s, 1);
    mbar_init_fence();
  }
  for (int c = tid; c < CA_PAD / 16; c += CA_THREADS) reinterpret_cast<uint4*>(pad)[c] = make_uint4(0, 0, 0, 0);
  fence_async_shared();
  __syncthreads();

  // TMA: K and V of both streams once (thread 0); each warpgroup keeps its
  // own ring of query tiles (its 64 rows) in flight, refilled by its thread
  // 0 as soon as the tile's products have read it
  auto load_q = [&](int t, int stage) {
    mbar_expect_tx(my_full + stage, QW);
    for (int p = 0; p < PANELS; ++p)
      tma_load(myQ + stage * QW + p * CA_Q_PANEL, map_q, my_full + stage, h * D + p * 64,
               t * CA_BQ + w * 64, b);
  };
  if (tid == 0) {
    mbar_expect_tx(kv_full, 2 * PANELS * (Rt + Ri) * 128);
    for (int p = 0; p < PANELS; ++p) {
      for (int r = 0; r < Rt; r += CA_KV_BOX) {
        tma_load(sKt + (p * Rt + r) * 128, map_kt, kv_full, h * D + p * 64, r, b);
        tma_load(sVt + (p * Rt + r) * 128, map_vt, kv_full, h * D + p * 64, r, b);
      }
      for (int r = 0; r < Ri; r += CA_KV_BOX) {
        tma_load(sKi + (p * Ri + r) * 128, map_ki, kv_full, h * D + p * 64, r, b);
        tma_load(sVi + (p * Ri + r) * 128, map_vi, kv_full, h * D + p * 64, r, b);
      }
    }
  }
  if (tw == 0)
    for (int t = t0; t < min(t1, t0 + q_stages); ++t) load_q(t, t - t0);

  const float c2 = scale * CA_LOG2E;  // logit -> base-2 exponent
  const bool flagship = D == 64 && Lt > 64 && Lt <= 80 && Li > 192 && Li <= 256;
  mbar_wait(kv_full, 0);
  float o_acc[D / 2];
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0, qs = i % q_stages;
    mbar_wait(my_full + qs, (i / q_stages) & 1);
    const uint64_t dq = wg_desc(myQ + qs * QW, 16, 1024);
    auto refill = [&]() {
      if (tw == 0 && t + q_stages < t1) load_q(t + q_stages, qs);
    };
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o_acc[j] = 0.f;
    if constexpr (D == 64) {
      if (flagship) {
        ca_tile_flagship(o_acc, wg_desc_here(dq), wg_desc_here(wg_desc(sKt, 16, 1024)),
                         wg_desc_here(wg_desc(sKi, 16, 1024)),
                         wg_desc_here(wg_desc(sVt, Rt * 128, 1024)),
                         wg_desc_here(wg_desc(sVi, Ri * 128, 1024)), Lt, Li, lane, c2, refill);
      }
    }
    if (!flagship) {
      float s[4][32];  // logits of up to four 64-key chunks
      ca_stream<D>(o_acc, s, dq, sKt, sVt, Rt, Lt, lane, c2);
      ca_stream<D>(o_acc, s, dq, sKi, sVi, Ri, Li, lane, c2);
      refill();
    }

    const int row0 = t * CA_BQ + w * 64 + warp * 16 + lane / 4;
    const long rs = (long)H * D;
    bf16* ob = o + (long)b * Sq * rs + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long)(row0 + 8 * r) * rs + col) =
              __floats2bfloat162_rn(o_acc[4 * j + 2 * r], o_acc[4 * j + 2 * r + 1]);
    }
  }
}

constexpr int CA_SMEM_LIMIT = 232448;

template <int D>
static cudaError_t launch_dual_cross(const bf16* q, const bf16* kt, const bf16* vt, const bf16* ki,
                              const bf16* vi, bf16* o, int B, int Sq, int Lt, int Li, int H,
                              int tiles_per_block, float scale, cudaStream_t stream) {
  constexpr int PANELS = D / 64, QTILE = 2 * PANELS * CA_Q_PANEL;  // both warpgroups' rows
  const int Rt = (Lt + 15) / 16 * 16, Ri = (Li + 15) / 16 * 16;
  const size_t kv_bytes = (size_t)2 * PANELS * (Rt + Ri) * 128;
  const size_t fixed = 1024 + kv_bytes + CA_PAD;  // alignment slack, K/V of both streams, pad
  int q_stages = 3;
  while (q_stages > 0 && fixed + (size_t)q_stages * (QTILE + 16) + 8 > (size_t)CA_SMEM_LIMIT)
    --q_stages;
  if (q_stages == 0) return cudaErrorInvalidValue;
  const size_t smem = fixed + (size_t)q_stages * (QTILE + 16) + 8;
  const long rs = (long)H * D;
  CUtensorMap mq, mkt, mvt, mki, mvi;
  cudaError_t err = make_panel_map(&mq, q, rs, Sq, B, rs, CA_BQ / 2);
  if (err == cudaSuccess) err = make_panel_map(&mkt, kt, rs, Lt, B, rs, CA_KV_BOX);
  if (err == cudaSuccess) err = make_panel_map(&mvt, vt, rs, Lt, B, rs, CA_KV_BOX);
  if (err == cudaSuccess) err = make_panel_map(&mki, ki, rs, Li, B, rs, CA_KV_BOX);
  if (err == cudaSuccess) err = make_panel_map(&mvi, vi, rs, Li, B, rs, CA_KV_BOX);
  static bool smem_set[64];  // per device; internal linkage: this library's own
  if (err == cudaSuccess)
    err = allow_smem_once((const void*)dual_cross_kernel<D>, CA_SMEM_LIMIT, smem_set);
  if (err != cudaSuccess) return err;
  const int ntiles = (Sq + CA_BQ - 1) / CA_BQ;
  dim3 grid((unsigned)((ntiles + tiles_per_block - 1) / tiles_per_block), (unsigned)H,
            (unsigned)B);
  dual_cross_kernel<D><<<grid, CA_THREADS, smem, stream>>>(mq, mkt, mvt, mki, mvi, o, Sq, Lt, Li, H,
                                                           tiles_per_block, q_stages, scale);
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
