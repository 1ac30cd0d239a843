// GroupNorm with an optional SiLU on channels-last (N, S, C), bf16 or f32.
// Replaces viewcrafter_tpu/ops/pallas/groupnorm.py:group_norm_fused.
//
// Three launches. (1) statistics: grid (chunks, N); a block owns `rows` rows
// of one sample. A row is CV = C / V vectors of 16 bytes. The block walks the
// row in windows of W = min(CV, 256) vectors and lays its threads over a
// window as 256 / W row lanes x W vector lanes, thread t at row lane t / W,
// vector t % W: with W = CV consecutive threads read consecutive memory across
// row ends, and every lane works whatever C is (16 vectors at C = 128, 40 at
// C = 320). A thread keeps f32 sum and sum of squares of its vector's
// channels over its rows; the row lanes' partials meet in shared memory and
// are added in a fixed order per channel, then per group (a group need not
// be a whole vector: C / G = 10 at C = 320). One (sum, sumsq) pair per
// (sample, chunk, group) goes to device memory. (2) fold: one block per
// sample, one thread per group, adds the chunks in chunk order and writes
// mean and rsqrt(max(E[x^2] - mean^2, 0) + eps). No float atomics: a rerun
// gives the same bits. (3) normalize: the same grid and thread layout; y =
// (x - mean) * inv * scale + bias in f32, SiLU in f32, cast on store.
// Bound: bytes (one read, one write; these kernels read x twice);
// ops/kernels/groupnorm.py.
#include "common.cuh"

namespace vc {

constexpr int GN_THREADS = 256;

template <typename T>
struct GnVec;
template <>
struct GnVec<bf16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const bf16* e = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(e[i]);
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint4 u;
    bf16* e = reinterpret_cast<bf16*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = __float2bfloat16(v[i]);
    *reinterpret_cast<uint4*>(p) = u;
  }
};
template <>
struct GnVec<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

// partial: (N, chunks, G, 2). Dynamic shared memory: 2 * C floats (per-channel
// sum, sumsq of this block's rows).
template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, int S, int C, int G,
                int rows, int chunks) {
  constexpr int V = GnVec<T>::N;
  __shared__ float s_part[GN_THREADS * V][2];  // [row lane][channel of the window]
  extern __shared__ float s_chan[];             // [C][2]
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int r0 = chunk * rows, r1 = min(S, r0 + rows);
  const T* xs = x + (long)n * S * C;
  const int CV = C / V;

  for (int cv0 = 0; cv0 < CV; cv0 += GN_THREADS) {
    const int W = min(GN_THREADS, CV - cv0), RP = GN_THREADS / W;
    const int tx = threadIdx.x % W, ty = threadIdx.x / W;  // ty == RP: no work
    float sum[V], sq[V];
#pragma unroll
    for (int i = 0; i < V; ++i) sum[i] = sq[i] = 0.f;
    if (ty < RP) {
      for (int r = r0 + ty; r < r1; r += RP) {
        float v[V];
        GnVec<T>::load(xs + (long)r * C + (cv0 + tx) * V, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          sum[i] += v[i];
          sq[i] += v[i] * v[i];
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s_part[(ty * W + tx) * V + i][0] = sum[i];
        s_part[(ty * W + tx) * V + i][1] = sq[i];
      }
    }
    __syncthreads();
    // one thread per channel of the window: add the row lanes in order
    for (int cl = threadIdx.x; cl < W * V; cl += GN_THREADS) {
      float a = 0.f, b = 0.f;
      for (int y = 0; y < RP; ++y) {
        a += s_part[y * W * V + cl][0];
        b += s_part[y * W * V + cl][1];
      }
      s_chan[2 * (cv0 * V + cl)] = a;
      s_chan[2 * (cv0 * V + cl) + 1] = b;
    }
    __syncthreads();
  }
  // one thread per group: add its channels in order
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += GN_THREADS) {
    float a = 0.f, b = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      a += s_chan[2 * c];
      b += s_chan[2 * c + 1];
    }
    float* p = partial + (((long)n * chunks + chunk) * G + g) * 2;
    p[0] = a;
    p[1] = b;
  }
}

// stats: (N, G, 2) = (mean, rsqrt(var + eps)). Grid N, one thread per group.
__global__ void gn_fold_kernel(const float* __restrict__ partial, float* __restrict__ stats, int G,
                               int chunks, float count, float eps) {
  const int n = blockIdx.x, g = threadIdx.x;
  if (g >= G) return;
  float a = 0.f, b = 0.f;
  for (int ch = 0; ch < chunks; ++ch) {
    const float* p = partial + (((long)n * chunks + ch) * G + g) * 2;
    a += p[0];
    b += p[1];
  }
  const float mean = a / count;
  const float var = b / count - mean * mean;
  stats[((long)n * G + g) * 2] = mean;
  stats[((long)n * G + g) * 2 + 1] = rsqrtf(fmaxf(var, 0.f) + eps);
}

template <typename T>
__global__ void __launch_bounds__(GN_THREADS)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                const float* __restrict__ bias, const float* __restrict__ stats,
                T* __restrict__ y, int S, int C, int G, int rows, int silu) {
  constexpr int V = GnVec<T>::N;
  const int chunk = blockIdx.x, n = blockIdx.y;
  const int r0 = chunk * rows, r1 = min(S, r0 + rows);
  const T* xs = x + (long)n * S * C;
  T* ys = y + (long)n * S * C;
  const int CV = C / V, cg = C / G;
  const float* st = stats + (long)n * G * 2;

  for (int cv0 = 0; cv0 < CV; cv0 += GN_THREADS) {
    const int W = min(GN_THREADS, CV - cv0), RP = GN_THREADS / W;
    const int cv = cv0 + threadIdx.x % W, ty = threadIdx.x / W;
    if (ty >= RP) continue;
    float mean[V], inv[V], sc[V], bi[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = cv * V + i, g = c / cg;
      mean[i] = st[2 * g];
      inv[i] = st[2 * g + 1];
      sc[i] = scale[c];
      bi[i] = bias[c];
    }
    for (int r = r0 + ty; r < r1; r += RP) {
      float v[V];
      GnVec<T>::load(xs + (long)r * C + cv * V, v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float o = (v[i] - mean[i]) * inv[i] * sc[i] + bi[i];
        if (silu) o = o * (1.f / (1.f + __expf(-o)));
        v[i] = o;
      }
      GnVec<T>::store(ys + (long)r * C + cv * V, v);
    }
  }
}

template <typename T>
cudaError_t launch_group_norm(const T* x, const float* scale, const float* bias, float* partial,
                              float* stats, T* y, int N, int S, int C, int G, int rows,
                              int chunks, int silu, float eps, cudaStream_t stream) {
  const size_t chan_smem = (size_t)2 * C * sizeof(float);
  if (chan_smem > 30 * 1024) return cudaErrorInvalidValue;  // + 16 KB static stays under 48 KB
  static_assert(GN_THREADS * GnVec<T>::N * 2 * sizeof(float) <= 16 * 1024, "s_part");
  dim3 grid((unsigned)chunks, (unsigned)N);
  gn_stats_kernel<T><<<grid, GN_THREADS, chan_smem, stream>>>(x, partial, S, C, G, rows, chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_fold_kernel<<<N, ((G + 31) / 32) * 32, 0, stream>>>(
      partial, stats, G, chunks, (float)S * (float)(C / G), eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, GN_THREADS, 0, stream>>>(x, scale, bias, stats, y, S, C, G, rows, silu);
  return cudaGetLastError();
}

}  // namespace vc

extern "C" int vc_group_norm(const void* x, const void* scale, const void* bias, void* partial,
                             void* stats, void* y, int N, int S, int C, int G, int rows,
                             int chunks, int itemsize, int silu, float eps, void* stream) {
  using namespace vc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  float* pa = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  if (G < 1 || G > 256 || C % G || rows < 1 || (long)rows * chunks < S)
    return (int)cudaErrorInvalidValue;
  if (itemsize == 2 && C % 8 == 0)
    return (int)launch_group_norm(static_cast<const bf16*>(x), sc, bi, pa, st,
                                  static_cast<bf16*>(y), N, S, C, G, rows, chunks, silu, eps, s);
  if (itemsize == 4 && C % 4 == 0)
    return (int)launch_group_norm(static_cast<const float*>(x), sc, bi, pa, st,
                                  static_cast<float*>(y), N, S, C, G, rows, chunks, silu, eps, s);
  return (int)cudaErrorInvalidValue;
}
