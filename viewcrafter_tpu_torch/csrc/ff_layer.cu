// Transformer FeedForward layer: LayerNorm -> GEGLU -> out projection.
// Replaces viewcrafter_tpu/ops/pallas/ff_layer.py:fused_ff_layer.
//
// Three launches: the LayerNorm (f32 statistics, bf16 out; common.cuh), then
// two products on the Hopper GEMM core (gemm_sm90.cuh: TMA, mbarrier ring,
// wgmma, persistent):
//  - GEMM1 xn W1^T with the bias + GEGLU in the epilogue. W1 (2I, C) is
//    mapped as two batches, h rows and gate rows; each stage's B tile holds
//    80 h rows and the 80 matching gate rows, so one m64n160 accumulator
//    holds h in its columns 0..79 and gate in 80..159, the same thread holds
//    both values of every output it gates, and the GEGLU runs on registers.
//  - GEMM2 g W2^T + b2.
// Rounding follows the TPU kernel: y = bf16(acc) + b1 in bf16, GELU(gate) in
// f32 (exact erf) rounded to bf16, g = h * gelu in bf16; out = bf16(acc2) +
// b2 in bf16. The normalised x (N, C) and the gated hidden g (N, I) cross
// device memory (each written once and read by the next product): the
// output accumulator of a row tile at C_out = 1280 does not fit registers,
// so the three stages stay apart.
// Bound: ops/kernels/ff_layer.py.
#include "gemm_sm90.cuh"

extern "C" int vc_ff_layer(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* xn, void* g,
                           void* out, long N, int C, int I, int Cout, float eps, void* stream) {
  using namespace vc;
  constexpr int BN = 160;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 || I % 8 || Cout % 8) return (int)cudaErrorInvalidValue;
  bf16* xnb = static_cast<bf16*>(xn);
  bf16* gb = static_cast<bf16*>(g);
  CUtensorMap m_xn, m_w1, m_g, m_w2;
  cudaError_t err = make_panel_map(&m_xn, xnb, C, N, 1, C, G_BM);
  if (err == cudaSuccess) err = make_panel_map(&m_w1, w1, C, I, 2, C, BN / 2);
  if (err == cudaSuccess) err = make_panel_map(&m_g, gb, I, N, 1, I, G_BM);
  if (err == cudaSuccess) err = make_panel_map(&m_w2, w2, I, Cout, 1, I, BN);
  if (err == cudaSuccess)
    err = launch_ln_apply(static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
                          static_cast<const float*>(ln_b), xnb, N, C, eps, s);
  if (err != cudaSuccess) return (int)err;

  const int row_blocks = (int)((N + G_BM - 1) / G_BM);
  err = launch_gemm_sm90<BN>(m_xn, m_w1, GemmTiles{1, N, row_blocks, (I + BN / 2 - 1) / (BN / 2)},
                             LoadGeglu<BN>{(C + 63) / 64},
                             EpiGeglu<BN>{gb, static_cast<const bf16*>(b1), N, I}, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm_sm90<BN>(
      m_g, m_w2, GemmTiles{1, N, row_blocks, (Cout + BN - 1) / BN}, LoadPlain<BN>{(I + 63) / 64},
      EpiBiasOut<BN>{static_cast<bf16*>(out), static_cast<const bf16*>(b2), N, Cout, BIAS_ROUND},
      s);
}
