// Non-causal, unmasked softmax attention for Hopper, FlashAttention-3 style.
// Replaces viewcrafter_tpu/ops/pallas/fullkv_attention.py:fullkv_attention.
//
// q, k, v, o: (B, S, H, D) bf16, D in {64, 128}; each may be a column block
// of a wider row-major buffer (the fused spatial layer's (B*S, 3C) Q|K|V), so
// the kernel takes row strides; the TMA tensor maps carry them.
//
// Bound (H100 SXM, ds1 site (50, 9216, 9216, 5, 64)): 5.4 TFLOP of tensor
// work, 5.5 ms at 989 TF/s, and 2.1e10 exp2 on the MUFU (16 per SM per clock,
// ~5.7 ms): a kernel that runs its softmax between its two products, not
// under them, cannot go below ~11 ms. The design overlaps the two (its times
// beside the bound: PERF.md).
//
// One block of three warpgroups per (128-row query tile, head, batch):
//  - warpgroup 2 is the producer: it gives its registers away (setmaxnreg;
//    ptxas, CUDA 12.8, still compiles the consumers within the launch
//    bound's 168 registers, so S, P and O are sized to fit that) and one
//    thread issues TMA loads: the query tile once, then K and V tiles
//    (128 keys at D = 64, 64 at D = 128) into a ring of stages guarded by
//    mbarriers (full: bytes landed; empty: both consumers done with them);
//  - warpgroups 0 and 1 are consumers of 64 query rows each. A consumer
//    scales its rows of the query tile by d^-1/2 * log2(e) and rounds them to
//    bf16 in shared memory once (the TPU kernel's q fold,
//    fullkv_attention.py:196-198), so the logits are base 2. Per key tile it
//    issues S = Q K^T (wgmma m64nBKVk16, both operands in shared memory) and,
//    behind it, O += P V for the previous tile (wgmma with P as the register
//    A operand, V read transposed from shared memory); it runs the online
//    softmax of the new S (running max, one exp2 per logit, f32 row sums)
//    while that P V product is in flight, then rescales O and rounds the new
//    P to bf16 against the running max. The division by the row sum comes
//    last, on the f32 O.
//  - The two consumers take turns to issue their products (named barriers,
//    ping-pong), so one's softmax runs under the other's tensor work.
// Keys past Sk (TMA zero fill) are masked to -inf, so any Sk is exact; rows
// past Sq are computed on zeros and not stored.
#include "hopper.cuh"

namespace vc {

constexpr int FA_BQ = 128, FA_THREADS = 384;
constexpr int FA_Q_PANEL = FA_BQ * 128;  // bytes of one 64-column panel of the query tile

// key tile: 128 keys at D = 64; 64 at D = 128, so that S, P and O of a
// consumer fit the registers ptxas gives it
template <int D>
struct FaShape {
  static constexpr int PANELS = D / 64;
  static constexpr int BKV = D == 64 ? 128 : 64;
  static constexpr int KV_PANEL = BKV * 128;  // bytes of one panel of a K or V tile
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int Q_BYTES = PANELS * FA_Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
  static constexpr size_t SMEM =
      1024 + (size_t)Q_BYTES + (size_t)2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
};

// S (64 x BKV f32, this thread's R = BKV / 2 values) after masking: softmax
// statistics of the two rows this thread holds (g = lane / 4 and g + 8),
// exponentials in place
template <bool FIRST, int R>
__device__ __forceinline__ void fa_softmax(float (&s)[R], float (&m)[2], float (&l)[2],
                                           float (&alpha)[2]) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = FIRST ? 0.f : ex2(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(s[4 * j + e] - mx[e / 2]);
      rs[e / 2] += s[4 * j + e];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l[r] = FIRST ? rs[r] : l[r] * alpha[r] + rs[r];
  }
}

// P (bf16) as wgmma A fragments, 16 keys each, from the exponentials in s
template <int R>
__device__ __forceinline__ void fa_pack(const float (&s)[R], uint32_t (&pf)[R / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pf[kk][i] = pack2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
fullkv_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o, int Sq, int Sk,
              long o_rs, float qscale) {
  using Sh = FaShape<D>;
  constexpr int ST = Sh::STAGES, PANELS = Sh::PANELS, BKV = Sh::BKV, KVP = Sh::KV_PANEL;
  constexpr int KVB = Sh::KV_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sQ = base;                 // [PANELS][128 rows][128 B]
  unsigned char* sK = sQ + Sh::Q_BYTES;     // [ST][PANELS][BKV rows][128 B]
  unsigned char* sV = sK + ST * KVB;        // [ST][PANELS][BKV rows][128 B]
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + ST * KVB);
  uint64_t* full_q = bar;                   // [1]
  uint64_t* full_k = bar + 1;               // [ST]
  uint64_t* full_v = full_k + ST;           // [ST]
  uint64_t* empty = full_v + ST;            // [ST]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  // warpgroup index, uniform over each warp (warpgroups 0, 1 consume, 2 produces)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int ntiles = (Sk + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k + s, 1);
      mbar_init(full_v + s, 1);
      mbar_init(empty + s, 256);  // every consumer thread arrives
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (tid == 256) {
      prefetch_map(map_q);
      prefetch_map(map_k);
      prefetch_map(map_v);
      mbar_expect_tx(full_q, Sh::Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load(sQ + p * FA_Q_PANEL, map_q, full_q, h * D + p * 64, qt * FA_BQ, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % ST;
        if (t >= ST) mbar_wait(empty + s, ((t / ST) - 1) & 1);
        mbar_expect_tx(full_k + s, KVB);
        for (int p = 0; p < PANELS; ++p)
          tma_load(sK + s * KVB + p * KVP, map_k, full_k + s, h * D + p * 64, t * BKV, b);
        mbar_expect_tx(full_v + s, KVB);
        for (int p = 0; p < PANELS; ++p)
          tma_load(sV + s * KVB + p * KVP, map_v, full_v + s, h * D + p * 64, t * BKV, b);
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<240>();
    const int w = wg, tw = tid - 128 * wg, warp = tw / 32, lane = tid & 31;
    // my turn to issue products: barrier 3 + w, released by the other
    // consumer's arrival; consumer 1 lets consumer 0 go first
    if (w == 1) named_arrive(3, 256);

    // this consumer's 64 query rows: scale by qscale and round to bf16
    mbar_wait(full_q, 0);
#pragma unroll
    for (int p = 0; p < PANELS; ++p) {
      uint4* rows = reinterpret_cast<uint4*>(sQ + p * FA_Q_PANEL + w * 64 * 128);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint4 u = rows[tw + 128 * i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 f = __bfloat1622float2(e[c]);
          e[c] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
        }
        rows[tw + 128 * i] = u;
      }
    }
    fence_async_shared();
    named_sync(1 + w, 128);

    auto issue_qk = [&](float (&s)[BKV / 2], int st) {
      const uint64_t dq = wg_desc_here(wg_desc(sQ + w * 64 * 128, 16, 1024));
      const uint64_t dk = wg_desc_here(wg_desc(sK + st * KVB, 16, 1024));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int ko = (kk % 4) * 32;
        const uint64_t a = wg_desc_plus(dq, (kk / 4) * FA_Q_PANEL + ko);
        const uint64_t b = wg_desc_plus(dk, (kk / 4) * KVP + ko);
        if (kk == 0) wgmma_ss_init<BKV>(s, a, b);
        else wgmma_ss<BKV>(s, a, b, 1);
      }
    };
    float o_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o_acc[i] = 0.f;
    auto issue_pv = [&](const uint32_t (&pf)[BKV / 16][4], int st) {
      const uint64_t dv = wg_desc_here(wg_desc(sV + st * KVB, KVP, 1024));
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) wgmma_rs_vt<D>(o_acc, pf[kk], wg_desc_plus(dv, kk * 2048));
    };
    auto mask = [&](float (&s)[BKV / 2], int t) {
      const int k0 = t * BKV;
      if (k0 + BKV <= Sk) return;
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * (lane % 4) + (e & 1) >= Sk) s[4 * j + e] = -INFINITY;
    };

    float s[BKV / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pf[BKV / 16][4];

    // key tile 0: S only
    named_sync(3 + w, 256);
    mbar_wait(full_k, 0);
    wg_fence();
    issue_qk(s, 0);
    wg_commit();
    named_arrive(3 + (1 - w), 256);
    wg_wait<0>();
    reg_fence(s);
    mask(s, 0);
    fa_softmax<true>(s, m, l, alpha);
    fa_pack(s, pf);

    for (int t = 1; t < ntiles; ++t) {
      const int st = t % ST, sp = (t - 1) % ST;
      named_sync(3 + w, 256);
      mbar_wait(full_k + st, (t / ST) & 1);
      wg_fence();
      issue_qk(s, st);
      wg_commit();
      mbar_wait(full_v + sp, ((t - 1) / ST) & 1);
      issue_pv(pf, sp);
      wg_commit();
      named_arrive(3 + (1 - w), 256);
      wg_wait<1>();  // S of tile t is in; P V of tile t - 1 may still run
      reg_fence(s);
      mask(s, t);
      fa_softmax<false>(s, m, l, alpha);
      wg_wait<0>();
      reg_fence(o_acc);
      mbar_arrive(empty + sp);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o_acc[4 * j] *= alpha[0];
        o_acc[4 * j + 1] *= alpha[0];
        o_acc[4 * j + 2] *= alpha[1];
        o_acc[4 * j + 3] *= alpha[1];
      }
      fa_pack(s, pf);
    }

    // P V of the last tile
    const int sl = (ntiles - 1) % ST;
    named_sync(3 + w, 256);
    mbar_wait(full_v + sl, ((ntiles - 1) / ST) & 1);
    wg_fence();
    issue_pv(pf, sl);
    wg_commit();
    if (w == 0) named_arrive(4, 256);  // consumer 1's last turn; consumer 0 takes no more
    wg_wait<0>();
    reg_fence(o_acc);

    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    const int row0 = qt * FA_BQ + w * 64 + warp * 16 + lane / 4;
    bf16* ob = o + (long)b * Sq * o_rs + h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (long)(row0 + 8 * r) * o_rs + col) =
              __floats2bfloat162_rn(o_acc[4 * j + 2 * r] * inv[r], o_acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

template <int D>
static cudaError_t launch_fullkv(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int Sq,
                          int Sk, int H, long q_rs, long kv_rs, long o_rs, float qscale,
                          cudaStream_t stream) {
  using Sh = FaShape<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_panel_map(&mq, q, (long)H * D, Sq, B, q_rs, FA_BQ);
  if (err == cudaSuccess) err = make_panel_map(&mk, k, (long)H * D, Sk, B, kv_rs, Sh::BKV);
  if (err == cudaSuccess) err = make_panel_map(&mv, v, (long)H * D, Sk, B, kv_rs, Sh::BKV);
  static bool smem_set[64];  // per device; internal linkage: this library's own
  if (err == cudaSuccess)
    err = allow_smem_once((const void*)fullkv_kernel<D>, (int)Sh::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((Sq + FA_BQ - 1) / FA_BQ), (unsigned)H, (unsigned)B);
  fullkv_kernel<D><<<grid, FA_THREADS, Sh::SMEM, stream>>>(mq, mk, mv, o, Sq, Sk, o_rs, qscale);
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
  if (q_rs % 8 || kv_rs % 8 || o_rs % 8 || Sk < 1) return (int)cudaErrorInvalidValue;
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
