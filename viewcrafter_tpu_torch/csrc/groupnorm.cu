// GroupNorm with an optional SiLU on channels-last (N, S, C), bf16 or f32.
// Replaces viewcrafter_tpu/ops/pallas/groupnorm.py:group_norm_fused.
//
// One launch: a cooperative grid of N x chunks blocks, all resident at once
// (cudaLaunchCooperativeKernel refuses a grid that could not be, and the
// wrapper sizes it by occupancy: two 256-thread blocks per SM), block
// (chunk, n) owning `rows` consecutive rows of sample n.
//  1. Statistics. A row is CV = C / V vectors of 16 bytes. The block walks
//     the row in windows of W = min(CV, 256) vectors and lays its threads
//     over a window as 256 / W row lanes x W vector lanes (thread t at row
//     lane t / W, vector t % W): with W = CV consecutive threads read
//     consecutive memory across row ends, and every lane works whatever C is.
//     Each thread keeps GN_UNROLL 16-byte loads in flight, sums its vector's
//     channels in f32 over its rows, and copies the first `cache_rows` rows of
//     the chunk into shared memory (about 94 KB per block, 25 MB over an
//     H100). The row lanes' partials meet in shared memory and are added in a
//     fixed order per channel, then per group (a group need not be a whole
//     vector: C / G = 10 at C = 320); one (sum, sumsq) pair per group goes to
//     device memory. The sums are taken about a shift, k = the group's first
//     element (row 0 of the sample, the group's first channel), which every
//     block reads before it starts: sums of x - k and (x - k)^2.
//  2. A grid-wide barrier (one counter and a generation word in device
//     memory; the last block to arrive resets the counter and moves the
//     generation on, so the next launch finds it ready; a wait that never
//     ends traps rather than hangs the card). Every launch on a device
//     shares the two words, so two launches must not overlap: the wrapper
//     issues them on the current stream, one after another.
//  3. The fold: every block adds the partials of its sample in chunk order,
//     the same sums in the same order in every block of the sample (no float
//     atomics: a rerun gives the same bits), into mean = k + E[x - k] and
//     rsqrt(max(E[(x - k)^2] - E[x - k]^2, 0) + eps) per group. The TPU
//     kernel takes E[x^2] - mean^2, which cancels on a group whose mean is
//     large against its spread; the shift keeps the one pass and agrees with
//     the mean of squared deviations that the default paths take.
//  4. Normalize: the rows kept in shared memory first, then the rest of the
//     chunk re-read in the reverse of step 1's order, so that the rows read
//     last in step 1 come from L2; y = (x - mean) * inv * scale + bias in
//     f32, SiLU in f32, cast on store.
// x is read from device memory once where a sample's chunks fit the blocks'
// shared memory (up to 25 MB of activation per call), else once plus the
// part that neither shared memory nor L2 kept. Bound: bytes (one read, one
// write); ops/kernels/groupnorm.py.
#include "common.cuh"

namespace vc {

constexpr int GN_THREADS = 256;
constexpr int GN_UNROLL = 8;           // 16-byte loads in flight per thread
constexpr int GN_BLOCK_SMEM = 115712;  // two blocks per SM: (228 KB) / 2 - 1 KB reserved

// 16 bytes of x as V floats and back
template <typename T>
struct GnVec;
template <>
struct GnVec<bf16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
  }
  static __device__ __forceinline__ float one(const bf16* p) { return __bfloat162float(*p); }
  static __device__ __forceinline__ uint4 pack(const float (&v)[8]) {
    uint4 u;
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
    return u;
  }
};
template <>
struct GnVec<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
    v[0] = __uint_as_float(u.x);
    v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z);
    v[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ float one(const float* p) { return *p; }
  static __device__ __forceinline__ uint4 pack(const float (&v)[4]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

// dynamic shared memory of a block: the row lanes' partials, the
// per-channel sums, the per-group statistics, then the cached rows
template <typename T>
struct GnSmem {
  static constexpr int PART = GN_THREADS * GnVec<T>::V * 2 * 4;  // [row lane][channel][2]
  static constexpr int STATS = 256 * 2 * 4;                       // [G <= 256][2]
  static __host__ __device__ int chan(int C) { return ((2 * C * 4 + 15) / 16) * 16; }
  static __host__ __device__ int cache_bytes(int C) {
    return GN_BLOCK_SMEM - PART - STATS - chan(C);
  }
};

__device__ unsigned int gn_arrived = 0;
__device__ unsigned int gn_generation = 0;

// every block of the grid has arrived (and its writes before are visible to
// every block after)
__device__ __forceinline__ void grid_barrier(unsigned int blocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = &gn_generation;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(&gn_arrived, 1u) == blocks - 1) {
      gn_arrived = 0;
      __threadfence();
      atomicAdd(&gn_generation, 1u);
    } else {
      for (unsigned int spins = 0; *gen == g; ++spins) {
        if (spins == (1u << 28)) __trap();
        __nanosleep(64);
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// step 4's loads and stores touch each row for the last time: evict first,
// so that they do not push out of L2 the rows still to be re-read
__device__ __forceinline__ uint4 ld_last(const void* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}
__device__ __forceinline__ void st_last(void* p, const uint4& u) {
  __stcs(reinterpret_cast<uint4*>(p), u);
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS, 2)
group_norm_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, float* __restrict__ partial, T* __restrict__ y,
                  int S, int C, int G, int rows, int chunks, int cache_rows, float count,
                  float eps, int silu) {
  constexpr int V = GnVec<T>::V;
  using Sm = GnSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_part = reinterpret_cast<float*>(smem);                        // [256 V][2]
  float* s_stats = reinterpret_cast<float*>(smem + Sm::PART);            // [G][2]
  float* s_chan = reinterpret_cast<float*>(smem + Sm::PART + Sm::STATS);  // [C][2]
  T* s_cache = reinterpret_cast<T*>(smem + Sm::PART + Sm::STATS + Sm::chan(C));  // [cache_rows][C]

  const int chunk = blockIdx.x, n = blockIdx.y;
  const int r0 = chunk * rows, r1 = min(S, r0 + rows), rc = min(r1, r0 + cache_rows);
  const T* xs = x + (long)n * S * C;
  T* ys = y + (long)n * S * C;
  const int CV = C / V, cg = C / G;

  // ---- 1. statistics ----
  for (int cv0 = 0; cv0 < CV; cv0 += GN_THREADS) {
    const int W = min(GN_THREADS, CV - cv0), RP = GN_THREADS / W;
    const int tx = threadIdx.x % W, ty = threadIdx.x / W;  // ty == RP: no work
    const int col = (cv0 + tx) * V;
    float sum[V], sq[V], sh[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sum[i] = sq[i] = 0.f;
    if (ty < RP) {
#pragma unroll
      for (int i = 0; i < V; ++i) sh[i] = GnVec<T>::one(xs + ((col + i) / cg) * cg);
      int r = r0 + ty;
      for (; r + (GN_UNROLL - 1) * RP < r1; r += GN_UNROLL * RP) {
        uint4 u[GN_UNROLL];
#pragma unroll
        for (int k = 0; k < GN_UNROLL; ++k)
          u[k] = *reinterpret_cast<const uint4*>(xs + (long)(r + k * RP) * C + col);
#pragma unroll
        for (int k = 0; k < GN_UNROLL; ++k) {
          const int rk = r + k * RP;
          if (rk < rc) *reinterpret_cast<uint4*>(s_cache + (long)(rk - r0) * C + col) = u[k];
          float v[V];
          GnVec<T>::unpack(u[k], v);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            const float d = v[i] - sh[i];
            sum[i] += d;
            sq[i] += d * d;
          }
        }
      }
      for (; r < r1; r += RP) {
        const uint4 u = *reinterpret_cast<const uint4*>(xs + (long)r * C + col);
        if (r < rc) *reinterpret_cast<uint4*>(s_cache + (long)(r - r0) * C + col) = u;
        float v[V];
        GnVec<T>::unpack(u, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float d = v[i] - sh[i];
          sum[i] += d;
          sq[i] += d * d;
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s_part[((ty * W + tx) * V + i) * 2] = sum[i];
        s_part[((ty * W + tx) * V + i) * 2 + 1] = sq[i];
      }
    }
    __syncthreads();
    // one thread per channel of the window: add the row lanes in order
    for (int cl = threadIdx.x; cl < W * V; cl += GN_THREADS) {
      float a = 0.f, b = 0.f;
      for (int yy = 0; yy < RP; ++yy) {
        a += s_part[(yy * W * V + cl) * 2];
        b += s_part[(yy * W * V + cl) * 2 + 1];
      }
      s_chan[2 * (cv0 * V + cl)] = a;
      s_chan[2 * (cv0 * V + cl) + 1] = b;
    }
    __syncthreads();
  }
  // one thread per group: add its channels in order
  for (int g = threadIdx.x; g < G; g += GN_THREADS) {
    float a = 0.f, b = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      a += s_chan[2 * c];
      b += s_chan[2 * c + 1];
    }
    reinterpret_cast<float2*>(partial)[((long)n * chunks + chunk) * G + g] = make_float2(a, b);
  }

  // ---- 2. every block's partials written ----
  grid_barrier(gridDim.x * gridDim.y);

  // ---- 3. the fold: lane l of group g adds chunks l, l + L, ... in order;
  // the lanes meet in order ----
  {
    const int L = GN_THREADS / G, g = threadIdx.x % G, l = threadIdx.x / G;
    if (l < L) {
      float a = 0.f, b = 0.f;
      const float2* p = reinterpret_cast<const float2*>(partial) + (long)n * chunks * G + g;
#pragma unroll 8
      for (int ch = l; ch < chunks; ch += L) {
        const float2 v = __ldcg(p + (long)ch * G);  // written by other SMs: read from L2
        a += v.x;
        b += v.y;
      }
      s_part[(l * G + g) * 2] = a;
      s_part[(l * G + g) * 2 + 1] = b;
    }
    __syncthreads();
    if (threadIdx.x < G) {
      float a = 0.f, b = 0.f;
      for (int ll = 0; ll < L; ++ll) {
        a += s_part[(ll * G + g) * 2];
        b += s_part[(ll * G + g) * 2 + 1];
      }
      const float mean_d = a / count;
      const float var = b / count - mean_d * mean_d;
      s_stats[2 * g] = GnVec<T>::one(xs + g * cg) + mean_d;
      s_stats[2 * g + 1] = rsqrtf(fmaxf(var, 0.f) + eps);
    }
    __syncthreads();
  }

  // ---- 4. normalize: the last window first, cached rows, then the rest
  // from the chunk's end backwards ----
  const int last_window = ((CV - 1) / GN_THREADS) * GN_THREADS;
  for (int cv0 = last_window; cv0 >= 0; cv0 -= GN_THREADS) {
    const int W = min(GN_THREADS, CV - cv0), RP = GN_THREADS / W;
    const int tx = threadIdx.x % W, ty = threadIdx.x / W;
    if (ty >= RP) continue;
    const int col = (cv0 + tx) * V;
    float mean[V], inv[V], sc[V], bi[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = col + i, g = c / cg;
      mean[i] = s_stats[2 * g];
      inv[i] = s_stats[2 * g + 1];
      sc[i] = scale[c];
      bi[i] = bias[c];
    }
    auto norm = [&](const uint4& u) {
      float v[V];
      GnVec<T>::unpack(u, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float o = (v[i] - mean[i]) * inv[i] * sc[i] + bi[i];
        if (silu) o = __fdividef(o, 1.f + __expf(-o));  // 0 where exp(-o) overflows
        v[i] = o;
      }
      return GnVec<T>::pack(v);
    };
    for (int r = r0 + ty; r < rc; r += RP)
      st_last(ys + (long)r * C + col,
              norm(*reinterpret_cast<const uint4*>(s_cache + (long)(r - r0) * C + col)));
    if (r0 + ty >= r1) continue;
    int r = r0 + ty + ((r1 - 1 - r0 - ty) / RP) * RP;  // this lane's last row
    for (; r - (GN_UNROLL - 1) * RP >= rc; r -= GN_UNROLL * RP) {
      uint4 u[GN_UNROLL];
#pragma unroll
      for (int k = 0; k < GN_UNROLL; ++k) u[k] = ld_last(xs + (long)(r - k * RP) * C + col);
#pragma unroll
      for (int k = 0; k < GN_UNROLL; ++k) st_last(ys + (long)(r - k * RP) * C + col, norm(u[k]));
    }
    for (; r >= rc; r -= RP)
      st_last(ys + (long)r * C + col, norm(ld_last(xs + (long)r * C + col)));
  }
}

// blocks of one launch that can be resident at once (two per SM), or a
// negated CUDA error. A block's shared memory is GN_BLOCK_SMEM at every C
// (the cache takes what the per-channel sums leave), so the answer depends
// on the device and the type only and is asked once per device; asking also
// raises the kernel's shared-memory limit.
template <typename T>
int group_norm_capacity() {
  static int capacity[64];
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -(int)err;
  if (dev < 64 && capacity[dev] > 0) return capacity[dev];
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(group_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GN_BLOCK_SMEM);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, group_norm_kernel<T>, GN_THREADS,
                                                        GN_BLOCK_SMEM);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  if (dev < 64) capacity[dev] = per_sm * sms;
  return per_sm * sms;
}

template <typename T>
cudaError_t launch_group_norm(const T* x, const float* scale, const float* bias, float* partial,
                              T* y, int N, int S, int C, int G, int rows, int chunks, int silu,
                              float eps, cudaStream_t stream) {
  using Sm = GnSmem<T>;
  if (Sm::cache_bytes(C) < 0) return cudaErrorInvalidValue;
  const int capacity = group_norm_capacity<T>();
  if (capacity < 0) return (cudaError_t)(-capacity);
  if ((long)N * chunks > capacity) return cudaErrorCooperativeLaunchTooLarge;
  int cache_rows = Sm::cache_bytes(C) / (C * (int)sizeof(T));
  cache_rows = cache_rows < rows ? cache_rows : rows;
  const float count = (float)S * (float)(C / G);
  void* args[] = {(void*)&x, (void*)&scale, (void*)&bias, (void*)&partial, (void*)&y, (void*)&S,
                  (void*)&C, (void*)&G, (void*)&rows, (void*)&chunks, (void*)&cache_rows,
                  (void*)&count, (void*)&eps, (void*)&silu};
  return cudaLaunchCooperativeKernel((const void*)group_norm_kernel<T>, dim3(chunks, N),
                                     dim3(GN_THREADS), args, GN_BLOCK_SMEM, stream);
}

}  // namespace vc

// the most blocks (N x chunks) one call may launch, or a negated CUDA error
extern "C" int vc_group_norm_blocks(int itemsize) {
  using namespace vc;
  return itemsize == 2 ? group_norm_capacity<bf16>() : group_norm_capacity<float>();
}

extern "C" int vc_group_norm(const void* x, const void* scale, const void* bias, void* partial,
                             void* y, int N, int S, int C, int G, int rows, int chunks,
                             int itemsize, int silu, float eps, void* stream) {
  using namespace vc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(partial);
  if (G < 1 || G > 256 || C % G || rows < 1 || (long)rows * chunks < S)
    return (int)cudaErrorInvalidValue;
  if (itemsize == 2 && C % 8 == 0)
    return (int)launch_group_norm(static_cast<const bf16*>(x), sc, bi, pa, static_cast<bf16*>(y),
                                  N, S, C, G, rows, chunks, silu, eps, s);
  if (itemsize == 4 && C % 4 == 0)
    return (int)launch_group_norm(static_cast<const float*>(x), sc, bi, pa,
                                  static_cast<float*>(y), N, S, C, G, rows, chunks, silu, eps, s);
  return (int)cudaErrorInvalidValue;
}
