// Plain fp32 building blocks of the two scans' backward kernels
// (mamba2_scan_bwd, rwkv6_scan_bwd): 64 x 64 tiles in shared memory, one
// block of 256 threads, each thread owning a 4 x 4 grid of a tile's
// elements (rows ti + 16 m, columns tj + 16 n; ti = tid / 16, tj = tid % 16).
//
// A tile is 64 rows of kLd = 65 floats: the odd stride puts the 16 rows or
// columns a warp reads at one step on 16 distinct banks, row-major or
// transposed.  Shorter dimensions (dh, ds, dk, dv below 64, a chunk's
// steps past the end of the sequence) are zero-filled on load, so every
// product runs over whole tiles and the zeros add nothing.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace tile64 {

constexpr int kQ = 64;             // chunk steps; every dimension is padded to it
constexpr int kLd = kQ + 1;        // row stride of a tile, in floats
constexpr int kTile = kQ * kLd;    // floats of one tile
constexpr int kThreads = 256;

__device__ __forceinline__ int row0() { return threadIdx.x >> 4; }
__device__ __forceinline__ int col0() { return threadIdx.x & 15; }

// acc[m][n] += sum_k a(row0 + 16 m, k) * b(col0 + 16 n, k), k < 64
template <class A, class B>
__device__ __forceinline__ void product(float (&acc)[4][4], A a, B b) {
  const int ti = row0(), tj = col0();
#pragma unroll 4
  for (int k = 0; k < kQ; ++k) {
    float av[4], bv[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) av[m] = a(ti + 16 * m, k);
#pragma unroll
    for (int n = 0; n < 4; ++n) bv[n] = b(tj + 16 * n, k);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// dst[i][c] = src[i * width + c] for i < rows and c < width, else 0
template <class T>
__device__ __forceinline__ void load(float* dst, const T* src, int rows, int width) {
  for (int e = threadIdx.x; e < kQ * kQ; e += kThreads) {
    const int i = e >> 6, c = e & 63;
    dst[i * kLd + c] = (i < rows && c < width) ? to_f32(src[(long long)i * width + c]) : 0.f;
  }
}

// dst[i * width + c] = src[i][c] for i < rows and c < width
__device__ __forceinline__ void store(float* dst, const float* src, int rows, int width) {
  for (int e = threadIdx.x; e < kQ * kQ; e += kThreads) {
    const int i = e >> 6, c = e & 63;
    if (i < rows && c < width) dst[(long long)i * width + c] = src[i * kLd + c];
  }
}

// the sum over the block of each thread's v (every thread gets it); red
// holds kThreads floats of shared memory, free before and after
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  const float total = red[0];
  __syncthreads();
  return total;
}

}  // namespace tile64
