// Spatial self-attention layer: LayerNorm -> QKV -> full attention over the S
// tokens of each batch row, per head -> out projection + bias (no residual).
// Replaces viewcrafter_tpu/ops/pallas/spatial_layer.py:fused_spatial_layer.
//
// The TPU kernel keeps a whole row's (S, 3C) Q|K|V in its on-chip memory
// (17.7 MB at S = 9216, C = 320); no SM holds that, so the layer is staged in
// four launches out of this package's own device code: the LayerNorm (f32
// statistics, bf16 out); the QKV GEMM into one (B*S, 3C) bf16 buffer that
// crosses device memory once; the flash-style attention kernel of
// fullkv_attention.cu reading q, k and v as column blocks of that buffer
// (row stride 3C) with q scaled by bf16(d^-1/2 log2 e) in bf16, a base-2
// softmax, unnormalised bf16 probabilities into P V and the division by the
// row sum on the f32 result (the TPU kernel's rounding points), heads landing
// side by side in a (B*S, C) bf16 buffer; the out-projection GEMM with the
// bias added in f32 before the one rounding. Both products run on the GEMM
// core (gemm_sm90.cuh: TMA, mbarrier ring, wgmma, persistent). Bound:
// ops/kernels/spatial_layer.py.
#include "gemm_sm90.cuh"

extern "C" int vc_fullkv_attention_strided(const void* q, const void* k, const void* v, void* o,
                                           int B, int Sq, int Sk, int H, int D, long q_rs,
                                           long kv_rs, long o_rs, float qscale, void* stream);

extern "C" int vc_spatial_layer(const void* x, const void* ln_w, const void* ln_b,
                                const void* wqkv, const void* wo, const void* bo, void* xn,
                                void* qkv, void* att, void* out, int B, int S, int C, int heads,
                                int D, float eps, float qscale, void* stream) {
  using namespace vc;
  constexpr int BN = 160;
  if ((D != 64 && D != 128) || heads * D != C) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long M = (long)B * S;
  CUtensorMap m_xn, m_wqkv, m_att, m_wo;
  cudaError_t err = make_panel_map(&m_xn, xn, C, M, 1, C, G_BM);
  if (err == cudaSuccess) err = make_panel_map(&m_wqkv, wqkv, C, 3L * C, 1, C, BN);
  if (err == cudaSuccess) err = make_panel_map(&m_att, att, C, M, 1, C, G_BM);
  if (err == cudaSuccess) err = make_panel_map(&m_wo, wo, C, C, 1, C, BN);
  if (err == cudaSuccess)
    err = launch_ln_apply(static_cast<const bf16*>(x), static_cast<const float*>(ln_w),
                          static_cast<const float*>(ln_b), static_cast<bf16*>(xn), M, C, eps, s);
  if (err != cudaSuccess) return (int)err;

  const int row_blocks = (int)((M + G_BM - 1) / G_BM), panels = (C + 63) / 64;
  err = launch_gemm_sm90<BN>(m_xn, m_wqkv, GemmTiles{1, M, row_blocks, (3 * C + BN - 1) / BN},
                             LoadPlain<BN>{panels},
                             EpiBiasOut<BN>{static_cast<bf16*>(qkv), nullptr, M, 3 * C, BIAS_NONE}, s);
  if (err != cudaSuccess) return (int)err;

  const bf16* qkvb = static_cast<const bf16*>(qkv);
  int rc = vc_fullkv_attention_strided(qkvb, qkvb + C, qkvb + 2 * C, att, B, S, S, heads, D,
                                       3L * C, 3L * C, (long)C, qscale, stream);
  if (rc != 0) return rc;

  return (int)launch_gemm_sm90<BN>(
      m_att, m_wo, GemmTiles{1, M, row_blocks, (C + BN - 1) / BN}, LoadPlain<BN>{panels},
      EpiBiasOut<BN>{static_cast<bf16*>(out), static_cast<const bf16*>(bo), M, C, BIAS_F32}, s);
}
