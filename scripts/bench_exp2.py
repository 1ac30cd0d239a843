"""Exponentials per clock on one SM of a Hopper card, by recipe: the question
the spatial layer's attention stage asks at D = 64, where the softmax's
exponentials cost as much as its products.

Each recipe runs the softmax's inner work on 16 independent logits per
thread (x - m, the exponential, two f32 row sums, and, where the recipe says
so, P packed to bf16x2), in a loop, in one wave of 4 blocks of 256 threads
per SM on average. Each block records its SM and clock64() at its start and
end; an SM's rate is the work of its blocks over the span from the first
start to the last end on it (one clock), so the rate is per SM per clock
whatever the clock was and however the blocks landed:

  mufu_f32         ex2.approx.ftz.f32
  mufu_f32_pack    the same, and P packed (cvt.rn.bf16x2.f32)
  mufu_bf16x2      x - m packed to bf16x2, ex2.approx.ftz.bf16x2, unpacked
                   to f32 for the sums
  mufu_f16x2       x - m packed to f16x2, ex2.approx.f16x2, to f32 for the
                   sums, then P packed to bf16x2
  fma_k_of_16      k of the 16 logits through the FMA-pipe exp2 (Cody-Waite
                   split by the 1.5 * 2^23 rounding trick, a degree-4
                   polynomial on [-0.5, 0.5], the exponent added as an integer
                   shift; the recipe lives only in this script), the rest
                   ex2.approx.ftz.f32; P packed

Then each recipe's largest relative error against float64 exp2 over
[-125, 0] (and over [-14, 0], where the 16-bit forms still hold normal
numbers), and its value at -inf.

Run on the card from the repository root:

    python scripts/bench_exp2.py [--out output/bench_exp2.json]

It builds its kernels with nvcc (sm_90a) into output/bench_exp2/ and prints
one JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "output" / "bench_exp2"

SOURCE = r"""
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float ex2f(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t ex2_f16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.f16x2 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -125.f);
  const float t = x + 12582912.f;  // 1.5 * 2^23: rounds x to an integer j
  const float f = x - (t - 12582912.f);  // in [-0.5, 0.5]
  float p = fmaf(0.009570101276040077f, f, 0.05591785907745361f);
  p = fmaf(p, f, 0.240247443318367f);
  p = fmaf(p, f, 0.6931217908859253f);
  p = fmaf(p, f, 0.9999992847442627f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

__device__ __forceinline__ unsigned smid() {
  unsigned id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// MODE 0: f32 MUFU (NPOLY of the 16 on the FMA pipe), P packed when PACK;
// 1: bf16x2 MUFU; 2: f16x2 MUFU. Per block: its SM, and clock64() at its
// start and end (one SM's clock)
template <int MODE, int NPOLY, bool PACK>
__global__ void __launch_bounds__(256) tput(float* out, long long* cycles, int iters, float seed) {
  float x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = -(seed + 0.37f * i + 1e-3f * threadIdx.x);
  float m = 0.f, l0 = 0.f, l1 = 0.f;
  uint32_t pk = 0;
  const long long c0 = clock64();
  for (int it = 0; it < iters; ++it) {
    m += 1e-7f;
    if (MODE == 0) {
      float e[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) e[i] = i < NPOLY ? exp2_fma(x[i] - m) : ex2f(x[i] - m);
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        l0 += e[i];
        l1 += e[i + 1];
        if (PACK) pk ^= pack_bf16(e[i], e[i + 1]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        float lo, hi;
        if (MODE == 1) {
          const uint32_t y = ex2_bf16x2(pack_bf16(x[i] - m, x[i + 1] - m));
          lo = __uint_as_float(y << 16);
          hi = __uint_as_float(y & 0xffff0000u);
          pk ^= y;
        } else {
          const uint32_t y = ex2_f16x2(pack_f16(x[i] - m, x[i + 1] - m));
          const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&y));
          lo = f.x;
          hi = f.y;
          pk ^= pack_bf16(lo, hi);
        }
        l0 += lo;
        l1 += hi;
      }
    }
  }
  const long long c1 = clock64();
  out[blockIdx.x * blockDim.x + threadIdx.x] = l0 + l1 + __uint_as_float(pk & 0x3f800000u);
  if (threadIdx.x == 0) {
    cycles[3 * blockIdx.x] = smid();
    cycles[3 * blockIdx.x + 1] = c0;
    cycles[3 * blockIdx.x + 2] = c1;
  }
}

// y = f(x) per recipe: 0 f32 MUFU, 1 FMA exp2, 2 bf16x2 MUFU, 3 f16x2 MUFU
__global__ void accuracy(const float* x, float* y, int n, int mode) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  if (mode == 0) y[i] = ex2f(v);
  else if (mode == 1) y[i] = exp2_fma(v);
  else if (mode == 2) y[i] = __uint_as_float(ex2_bf16x2(pack_bf16(v, v)) << 16);
  else {
    const uint32_t r = ex2_f16x2(pack_f16(v, v));
    y[i] = __half2float(*reinterpret_cast<const __half*>(&r));
  }
}

template <int MODE, int NPOLY, bool PACK>
static float run_one(int blocks, int iters, long long* cycles_host) {
  float* out;
  long long* cyc;
  cudaMalloc(&out, sizeof(float) * blocks * 256);
  cudaMalloc(&cyc, 3 * sizeof(long long) * blocks);
  tput<MODE, NPOLY, PACK><<<blocks, 256>>>(out, cyc, iters / 10, 1.0f);  // warm up
  tput<MODE, NPOLY, PACK><<<blocks, 256>>>(out, cyc, iters, 1.0f);
  cudaError_t err = cudaDeviceSynchronize();
  cudaMemcpy(cycles_host, cyc, 3 * sizeof(long long) * blocks, cudaMemcpyDeviceToHost);
  cudaFree(out);
  cudaFree(cyc);
  return err == cudaSuccess ? 0.f : -1.f;
}

extern "C" int bench(int recipe, int blocks, int iters, long long* cycles_host) {
  float r = -1.f;
  switch (recipe) {
    case 0: r = run_one<0, 0, false>(blocks, iters, cycles_host); break;
    case 1: r = run_one<0, 0, true>(blocks, iters, cycles_host); break;
    case 2: r = run_one<1, 0, true>(blocks, iters, cycles_host); break;
    case 3: r = run_one<2, 0, true>(blocks, iters, cycles_host); break;
    case 4: r = run_one<0, 2, true>(blocks, iters, cycles_host); break;
    case 5: r = run_one<0, 3, true>(blocks, iters, cycles_host); break;
    case 6: r = run_one<0, 4, true>(blocks, iters, cycles_host); break;
    case 7: r = run_one<0, 6, true>(blocks, iters, cycles_host); break;
    case 8: r = run_one<0, 8, true>(blocks, iters, cycles_host); break;
    case 9: r = run_one<0, 16, true>(blocks, iters, cycles_host); break;
  }
  return r == 0.f ? 0 : 1;
}

extern "C" int eval_accuracy(const float* x_host, float* y_host, int n, int mode) {
  float *x, *y;
  cudaMalloc(&x, sizeof(float) * n);
  cudaMalloc(&y, sizeof(float) * n);
  cudaMemcpy(x, x_host, sizeof(float) * n, cudaMemcpyHostToDevice);
  accuracy<<<(n + 255) / 256, 256>>>(x, y, n, mode);
  cudaError_t err = cudaMemcpy(y_host, y, sizeof(float) * n, cudaMemcpyDeviceToHost);
  cudaFree(x);
  cudaFree(y);
  return err == cudaSuccess ? 0 : 1;
}

extern "C" int sm_count() {
  int n = 0;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, 0);
  return n;
}
"""

RECIPES = ["mufu_f32", "mufu_f32_pack", "mufu_bf16x2", "mufu_f16x2", "fma_2_of_16",
           "fma_3_of_16", "fma_4_of_16", "fma_6_of_16", "fma_8_of_16", "fma_16_of_16"]
ACCURACY = ["mufu_f32", "fma", "mufu_bf16x2", "mufu_f16x2"]


def build() -> ctypes.CDLL:
    BUILD.mkdir(parents=True, exist_ok=True)
    src, lib = BUILD / "bench_exp2.cu", BUILD / "libbench_exp2.so"
    src.write_text(SOURCE)
    subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", str(src), "-o", str(lib)], check=True)
    return ctypes.CDLL(str(lib))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--iters", type=int, default=20000)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = build()
    sms = lib.sm_count()
    blocks_per_sm = 4  # 1024 threads an SM, all resident
    blocks = sms * blocks_per_sm
    rates = {}
    for i, name in enumerate(RECIPES):
        cyc = (ctypes.c_longlong * (3 * blocks))()
        if lib.bench(i, blocks, args.iters, cyc):
            raise RuntimeError(f"{name}: launch failed")
        rec = np.array(cyc[:], dtype=np.int64).reshape(blocks, 3)
        elems_per_block = 256.0 * args.iters * 16
        per_sm = []
        for sm in np.unique(rec[:, 0]):
            mine = rec[rec[:, 0] == sm]
            per_sm.append(elems_per_block * len(mine) / float(mine[:, 2].max() - mine[:, 1].min()))
        per_sm = np.array(per_sm)
        rates[name] = {"exp_per_clk_per_sm": float(np.median(per_sm)),
                       "min_max_over_sms": [float(per_sm.min()), float(per_sm.max())]}
    grid = np.concatenate([np.linspace(-125.0, 0.0, 1 << 20), [-np.inf]]).astype(np.float32)
    acc = {}
    for mode, name in enumerate(ACCURACY):
        y = np.empty_like(grid)
        if lib.eval_accuracy(grid.ctypes.data_as(ctypes.c_void_p), y.ctypes.data_as(ctypes.c_void_p),
                             grid.size, mode):
            raise RuntimeError(f"{name}: accuracy launch failed")
        ref = np.exp2(grid.astype(np.float64))
        fin = np.isfinite(grid)
        rel = np.abs(y[fin].astype(np.float64) / ref[fin] - 1)
        near = grid[fin] >= -14.0
        acc[name] = {"max_rel_err_m125_0": float(rel.max()),
                     "max_rel_err_m14_0": float(rel[near].max()),
                     "at_minus_inf": float(y[-1])}
    res = {"nvidia_smi": smi, "sms": sms, "threads_per_sm": 256 * blocks_per_sm,
           "iters": args.iters, "rates": rates, "accuracy": acc}
    text = json.dumps(res)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
