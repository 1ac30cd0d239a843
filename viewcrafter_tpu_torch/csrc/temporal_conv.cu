// Conv3d((3,1,1)) over the frame axis as one implicit GEMM on the Hopper
// GEMM core (gemm_sm90.cuh: TMA, mbarrier ring, wgmma, persistent).
// Replaces viewcrafter_tpu/ops/pallas/temporal_conv.py:temporal_conv3.
//
// x (B, T, S, Cin) is mapped as cols = Cin, rows = T * S, batch = B. The
// rows (t, s) of one batch are contiguous, so tap dt of the A tile that
// starts at flat row r0 is the box at row r0 + (dt - 1) * S: TMA reads zeros
// for rows outside [0, T * S), which is the SAME padding at both frame edges
// (a negative row coordinate at the first frame), and a tile may cross frame
// boundaries, so any S works. The K loop is 3 taps x ceil(Cin / 64) panels,
// with no address arithmetic per element. The weight (Cout, 3 * Cin) is
// mapped as cols = Cin, rows = tap, batch = Cout, so a panel never reads
// into the next tap when Cin is not a multiple of 64. f32 accumulation over
// all three taps; the bias (bf16, as the TPU kernel casts it) is added to
// the f32 sum before one rounding.
// Bound at the flagship ds1 site (2, 25, 9216, 320 -> 320): 283 GFLOP,
// 0.29 ms at 989 TF/s, against 0.59 GB of input and output (0.18 ms):
// operations; see ops/kernels/temporal_conv.py.
#include "gemm_sm90.cuh"

extern "C" int vc_temporal_conv3(const void* x, const void* w, const void* bias, void* y, long B,
                                 int T, int S, int Cin, int Cout, void* stream) {
  using namespace vc;
  constexpr int BN = 160;
  if (Cin % 8 || Cout % 8) return (int)cudaErrorInvalidValue;
  const long rows = (long)T * S;
  CUtensorMap ma, mb;
  cudaError_t err = make_panel_map(&ma, x, Cin, rows, B, Cin, G_BM);
  if (err == cudaSuccess) err = make_tile_map(&mb, w, Cin, 3, Cout, Cin, 3L * Cin, 1, BN);
  if (err != cudaSuccess) return (int)err;
  GemmTiles tiles{(int)B, rows, (int)((rows + G_BM - 1) / G_BM), (Cout + BN - 1) / BN};
  LoadConv3<BN> load{(Cin + 63) / 64, S};
  EpiBiasOut<BN> epi{static_cast<bf16*>(y), static_cast<const bf16*>(bias), rows, Cout, BIAS_F32};
  return (int)launch_gemm_sm90<BN>(ma, mb, tiles, load, epi, static_cast<cudaStream_t>(stream));
}
