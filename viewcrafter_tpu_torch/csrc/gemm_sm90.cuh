// The Hopper GEMM core of the port's products (the temporal conv, the FF
// layer, and the projections of the temporal and spatial layers):
// C = A B^T with bf16 operands and f32 accumulation on wgmma, fed by TMA.
//
// Output tiles are BM = 192 rows x BN columns, for (batch, row block, column
// block) in that order of significance, the column block fastest, so that
// the blocks resident at one time share their A rows in L2. The kernel is
// persistent: one block per SM walks the tiles in a static order (tile
// blockIdx.x, then + gridDim.x, ...).
//
// Block of four warpgroups:
//  - warpgroup 0 produces: it gives its registers away (setmaxnreg) and one
//    thread issues the TMA loads of each k step (a 64-deep panel of A,
//    192 rows, and of B, BN rows) into a ring of STAGES stages guarded by
//    mbarriers (full: the stage's bytes landed; empty: every consumer warp
//    is done reading it). It runs up to STAGES k steps ahead, across tile
//    boundaries, so the next tile's loads overlap this tile's epilogue;
//  - warpgroups 1-3 consume 64 rows each: per k step four wgmma m64nBNk16
//    with both operands in shared memory (128-byte swizzled, K-major), one
//    commit group per stage; a stage is released as soon as the group after
//    it is issued and it has completed.
// The epilogue works from the accumulator in registers: the epilogue
// functor turns each pair of accumulator values into a bf16 pair, each warp
// writes its 16 rows, 80 columns at a time, into a padded shared-memory
// buffer of its own (conflict-free), and copies them out as whole 16-byte
// pieces of rows. Stores of the fragments straight from registers (4 bytes
// per thread, 8 rows per warp instruction) cost 40-60% of the kernel.
//
// The loader functor says what a k step loads (`kiters`, `load`): the plain
// product, the conv's three row-shifted taps, the GEGLU's h and gate halves
// of W1. Value 4 j + 2 h + e of a thread's accumulator is row lane / 4 + 8 h
// of its warp's 16, column 8 j + 2 (lane % 4) + e of the tile.
//
// Registers: ptxas (CUDA 12.8) compiles every thread of a block within
// 65536 / threads registers whatever setmaxnreg asks: 128 for these 512
// threads, so BN = 160 (an m64n160 accumulator is 80 registers). 192-row
// tiles (three consumers) ran 14-25% faster than 128-row ones (two
// consumers, 168 registers). 160 divides every flagship width (320, 640,
// 1280, and 2 x 80 for the GEGLU pair); narrower or ragged widths read
// zeros past the tensor (TMA fill) and the epilogue stores nothing there.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace vc {

constexpr int G_NC = 3;  // consumer warpgroups, 64 rows each
constexpr int G_BM = 64 * G_NC;

// epilogue buffer of one warp: 16 rows of 80 columns, padded to 88 so that
// the 8 rows a fragment store touches fall on distinct banks
constexpr int G_EPI_COLS = 80, G_EPI_LD = 88;
constexpr int G_EPI_WARP_BYTES = 16 * G_EPI_LD * 2;

template <int BN>
struct GemmShape {
  static constexpr int THREADS = 128 * (G_NC + 1);
  static constexpr int A_BYTES = G_BM * 128;  // one 64-column panel of the tile's rows
  static constexpr int B_BYTES = BN * 128;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int EPI_BYTES = 4 * G_NC * G_EPI_WARP_BYTES;
  // as many stages as fit beside the 1024-byte alignment, the epilogue
  // buffers and the barriers
  static constexpr int FREE = 232448 - 1024 - 256 - EPI_BYTES;
  static constexpr int STAGES = FREE / STAGE < 6 ? FREE / STAGE : 6;
  static constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE + EPI_BYTES + 16 * STAGES;
};

// The tiles of one launch.
struct GemmTiles {
  int batches;     // outer batch (the conv's B; 1 for a plain product)
  long rows;       // rows per batch
  int row_blocks;  // ceil(rows / G_BM)
  int col_blocks;  // output column blocks of BN
  __host__ __device__ long count() const { return (long)batches * row_blocks * col_blocks; }
};

// One warp's 16 rows of the tile (first row `row0`, first column `col0`)
// through its shared-memory buffer `buf` to epi.out, 80 columns at a time.
template <int BN, class Epi>
__device__ __forceinline__ void store_tile(const Epi& epi, const float (&acc)[BN / 2], bf16* buf,
                                           int b, long row0, int col0, int lane) {
  constexpr int PASSES = Epi::OUT_COLS / G_EPI_COLS, JP = G_EPI_COLS / 8;
  bf16* out = epi.out + (long)b * epi.rows * epi.N;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
#pragma unroll
    for (int jj = 0; jj < JP; ++jj) {
      const int j = pass * JP + jj, c = col0 + 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(buf + (lane / 4 + 8 * h) * G_EPI_LD + 8 * jj +
                                           2 * (lane % 4)) =
            c < epi.N ? epi.pair(acc, j, h, c) : __floats2bfloat162_rn(0.f, 0.f);
    }
    __syncwarp();
#pragma unroll
    for (int i = lane; i < 16 * JP; i += 32) {
      const int r = i / JP, c = col0 + pass * G_EPI_COLS + 8 * (i % JP);
      if (row0 + r < epi.rows && c < epi.N)  // N % 8 == 0: a piece is all in or all out
        *reinterpret_cast<uint4*>(out + (row0 + r) * epi.N + c) =
            *reinterpret_cast<const uint4*>(buf + r * G_EPI_LD + 8 * (i % JP));
    }
    __syncwarp();
  }
}

template <int BN, class Load, class Epi>
__global__ void __launch_bounds__(128 * (G_NC + 1), 1)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                 GemmTiles tiles, Load load, Epi epi) {
  using Sh = GemmShape<BN>;
  constexpr int ST = Sh::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* epi_buf = reinterpret_cast<bf16*>(base + ST * Sh::STAGE);  // [consumer warps][16][88]
  uint64_t* full = reinterpret_cast<uint64_t*>(base + ST * Sh::STAGE + Sh::EPI_BYTES);  // [ST]
  uint64_t* empty = full + ST;                                                          // [ST]

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const long ntiles = tiles.count();
  const int kiters = load.kiters();
  const int per_batch = tiles.row_blocks * tiles.col_blocks;

  if (tid == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128 * G_NC);  // every consumer thread arrives
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();  // what the producer gives away, the consumers take
    if (tid == 0) {
      prefetch_map(map_a);
      prefetch_map(map_b);
      uint32_t it = 0;
      for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int b = (int)(t / per_batch), rem = (int)(t % per_batch);
        const long m0 = (long)(rem / tiles.col_blocks) * G_BM;
        const int nb = rem % tiles.col_blocks;
        for (int ki = 0; ki < kiters; ++ki, ++it) {
          const uint32_t s = it % ST;
          if (it >= ST) mbar_wait(empty + s, ((it / ST) - 1) & 1);
          unsigned char* sa = base + s * Sh::STAGE;
          mbar_expect_tx(full + s, Sh::STAGE);
          load.load(map_a, map_b, sa, sa + Sh::A_BYTES, full + s, b, (int)m0, nb, ki);
        }
      }
    }
  } else {
    // ---------------- consumers ----------------
    setmaxnreg_inc<160>();
    const int w = wg - 1, warp = (tid % 128) / 32, lane = tid & 31;
    // one accumulator for every tile: the first k step of a tile overwrites
    // it (scale_d = 0) with the same instruction as the others, so no
    // register moves sit between the products
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    uint32_t it = 0;
    for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int b = (int)(t / per_batch), rem = (int)(t % per_batch);
      const long m0 = (long)(rem / tiles.col_blocks) * G_BM;
      const int nb = rem % tiles.col_blocks;
      for (int ki = 0; ki < kiters; ++ki) {
        const uint32_t s = (it + ki) % ST;
        mbar_wait(full + s, ((it + ki) / ST) & 1);
        unsigned char* sa = base + s * Sh::STAGE;
        const uint64_t da = wg_desc_here(wg_desc(sa + w * 64 * 128, 16, 1024));
        const uint64_t db = wg_desc_here(wg_desc(sa + Sh::A_BYTES, 16, 1024));
        wg_fence();
        wgmma_ss<BN>(acc, da, db, ki > 0);
#pragma unroll
        for (int kk = 1; kk < 4; ++kk)
          wgmma_ss<BN>(acc, wg_desc_plus(da, 32 * kk), wg_desc_plus(db, 32 * kk), 1);
        wg_commit();
        if (ki > 0) {
          wg_wait<1>();  // the previous stage's products are done with it
          mbar_arrive(empty + (it + ki - 1) % ST);
        }
      }
      wg_wait<0>();
      reg_fence(acc);
      mbar_arrive(empty + (it + kiters - 1) % ST);
      it += kiters;
      store_tile<BN>(epi, acc, epi_buf + (w * 4 + warp) * 16 * G_EPI_LD, b,
                     m0 + w * 64 + warp * 16, nb * Epi::OUT_COLS, lane);
    }
  }
}

inline int sm_count() {
  static int count[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && count[dev]) return count[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) count[dev] = n;
  return n;
}

template <int BN, class Load, class Epi>
cudaError_t launch_gemm_sm90(const CUtensorMap& map_a, const CUtensorMap& map_b, GemmTiles tiles,
                             Load load, Epi epi, cudaStream_t stream) {
  using Sh = GemmShape<BN>;
  auto kern = gemm_sm90_kernel<BN, Load, Epi>;
  static bool smem_set[64];  // per device and instance
  cudaError_t err = allow_smem_once((const void*)kern, (int)Sh::SMEM, smem_set);
  if (err != cudaSuccess) return err;
  const long n = tiles.count();
  if (n == 0) return cudaSuccess;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const unsigned grid = (unsigned)(n < sms ? n : sms);
  kern<<<grid, Sh::THREADS, Sh::SMEM, stream>>>(map_a, map_b, tiles, load, epi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Loaders. `load` issues the TMA boxes of k step `ki` of the tile (batch b,
// first row m0, column block nb) into the stage's A and B panels.
// ---------------------------------------------------------------------------

// A (rows, K) of batch b and B (N, K), both row-major: k step = one panel.
template <int BN>
struct LoadPlain {
  int panels;                      // ceil(K / 64)
  __device__ __forceinline__ int kiters() const { return panels; }
  __device__ __forceinline__ void load(const CUtensorMap& ma, const CUtensorMap& mb, void* sa,
                                       void* sb, uint64_t* bar, int b, int m0, int nb, int ki) const {
    tma_load(sa, ma, bar, ki * 64, m0, b);
    tma_load(sb, mb, bar, ki * 64, nb * BN, 0);
  }
};

// Conv3d((3,1,1)) as an implicit GEMM: A is x of batch b as (T * S, Cin)
// rows; tap dt of the A tile at flat row m0 is the box at row
// m0 + (dt - 1) * S (zeros before frame 0 and past frame T - 1, from the
// map's bounds: SAME padding). B is the weight (Cout, 3, Cin) mapped as
// cols = Cin, rows = tap, batch = Cout. k step = tap-major (dt, panel).
template <int BN>
struct LoadConv3 {
  int panels;  // ceil(Cin / 64)
  int S;
  __device__ __forceinline__ int kiters() const { return 3 * panels; }
  __device__ __forceinline__ void load(const CUtensorMap& ma, const CUtensorMap& mb, void* sa,
                                       void* sb, uint64_t* bar, int b, int m0, int nb, int ki) const {
    const int dt = ki / panels, p = ki - dt * panels;
    tma_load(sa, ma, bar, p * 64, m0 + (dt - 1) * S, b);
    tma_load(sb, mb, bar, p * 64, dt, nb * BN);
  }
};

// GEGLU's first product: B is W1 (2I, C) mapped as batch 0 = the h rows and
// batch 1 = the gate rows; the B tile holds BN / 2 h rows then the matching
// BN / 2 gate rows, so columns j and j + BN / 2 of the accumulator are h and
// gate of the same output column.
template <int BN>
struct LoadGeglu {
  int panels;  // ceil(C / 64)
  __device__ __forceinline__ int kiters() const { return panels; }
  __device__ __forceinline__ void load(const CUtensorMap& ma, const CUtensorMap& mb, void* sa,
                                       void* sb, uint64_t* bar, int b, int m0, int nb, int ki) const {
    tma_load(sa, ma, bar, ki * 64, m0, b);
    tma_load(sb, mb, bar, ki * 64, nb * (BN / 2), 0);
    tma_load(static_cast<unsigned char*>(sb) + (BN / 2) * 128, mb, bar, ki * 64, nb * (BN / 2), 1);
  }
};

// ---------------------------------------------------------------------------
// Epilogues: `pair(acc, j, h, c)` is the bf16 pair of output columns c, c + 1
// (n8 block j of the tile's output columns) in row half h; `out` is
// (batches, rows, N) bf16.
// ---------------------------------------------------------------------------

// How a product's epilogue adds its bias (bf16, one value per column):
//   BIAS_NONE:  out = bf16(acc)                (bias may be nullptr)
//   BIAS_F32:   out = bf16(acc + bias)         (f32 add, one rounding)
//   BIAS_ROUND: out = bf16(bf16(acc) + bias)   (bias added in bf16)
enum BiasMode { BIAS_NONE = 0, BIAS_F32 = 1, BIAS_ROUND = 2 };

template <int BN>
struct EpiBiasOut {
  static constexpr int OUT_COLS = BN;
  bf16* out;
  const bf16* bias;
  long rows;
  int N;
  int mode;
  __device__ __forceinline__ __nv_bfloat162 pair(const float (&acc)[BN / 2], int j, int h,
                                                 int c) const {
    const float a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
    if (mode == BIAS_NONE) return __floats2bfloat162_rn(a0, a1);
    const __nv_bfloat162 bv = *reinterpret_cast<const __nv_bfloat162*>(bias + c);
    if (mode == BIAS_ROUND)  // bf16 + bf16 is exact in f32 before its one rounding
      return __hadd2(__floats2bfloat162_rn(a0, a1), bv);
    const float2 bf = __bfloat1622float2(bv);
    return __floats2bfloat162_rn(a0 + bf.x, a1 + bf.y);
  }
};

// g (rows, I) = h * GELU(gate) with the TPU kernel's rounding: h and gate are
// bf16(acc) + b1 in bf16, GELU in f32 (exact erf) rounded to bf16, the
// product rounded to bf16. The bf16 steps run on pairs (cvt.rn.bf16x2,
// add and multiply in bf16x2): the sum of two bf16 values and the product of
// two are exact in f32 before their one rounding, so the pairs give the bits
// of the f32 formulation with a third of its instructions.
template <int BN>
struct EpiGeglu {
  static constexpr int OUT_COLS = BN / 2;  // accumulator columns j and j + BN / 2: h, gate
  bf16* out;       // g
  const bf16* b1;  // (2I,)
  long rows;
  int N;  // I
  static __device__ __forceinline__ float gelu(float x) {
    return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
  }
  __device__ __forceinline__ __nv_bfloat162 pair(const float (&acc)[BN / 2], int j, int h,
                                                 int c) const {
    const int e = 4 * j + 2 * h, eg = 4 * (j + BN / 16) + 2 * h;
    const __nv_bfloat162 hv = __hadd2(__floats2bfloat162_rn(acc[e], acc[e + 1]),
                                      *reinterpret_cast<const __nv_bfloat162*>(b1 + c));
    const float2 gv = __bfloat1622float2(__hadd2(
        __floats2bfloat162_rn(acc[eg], acc[eg + 1]),
        *reinterpret_cast<const __nv_bfloat162*>(b1 + N + c)));
    return __hmul2(hv, __floats2bfloat162_rn(gelu(gv.x), gelu(gv.y)));
  }
};

}  // namespace vc
