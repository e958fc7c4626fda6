// Mamba2 (SSD) chunked selective scan for Hopper (sm_90a), bf16 in and out,
// fp32 arithmetic and state, returning the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py
// (mamba2_scan / _mamba2_kernel).  Per head, with h a [ds, dh] state:
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t + D x_t
//
// evaluated chunk by chunk (Q = 64 steps): with cum the inclusive cumsum of
// dt a inside the chunk,
//
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//          + exp(cum_i) C_i^T h_prev + D x_i
//   h    = exp(cum_Q) h_prev + sum_j exp(cum_Q - cum_j) dt_j B_j x_j^T
//
// On the TPU the chunk axis is the inner, sequential grid axis and h lives
// in VMEM scratch between grid steps.  Blocks on Hopper run in no order, so
// one block of 256 threads owns one (batch, head) row and loops over the
// chunks itself; h stays in shared memory for the whole sequence and is
// written out once at the end (the prefill's decode state).  B and C are
// read per group: head bh reads row bh / heads_per_group, so Mamba2's one
// group shared by every head is never repeated in memory.
//
// What bounds it on an H100: at the Zamba2-7B prefill shape (448 rows of
// 512 steps, dh = ds = 64) the bytes are x and y (29 MB each), dt, the
// shared B/C and the final state, about 68 MB or 0.020 ms at 3.35 TB/s; the
// four 64 x 64 x 64 products per chunk are about 7.5 GFLOP.  This first
// version does those products in fp32 on the CUDA cores (no tensor cores):
// each thread owns a 4 x 4 tile of every product, operands come from
// padded shared-memory tiles (pitch 65 floats, so the rows a warp reads sit
// in distinct banks), and the triangular mask is applied by selection, so
// exp() is never taken of a positive exponent.  The cumulative log-decays
// come from one warp's shuffle scan.  wgmma, TMA and skipping the upper
// triangle are later work.
//
// Ragged tail: steps past S load as x = B = C = 0 and dt = 0, so they
// leave the state unchanged and their y rows are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;        // chunk length
constexpr int kMaxD = 64;     // dh, ds <= 64
constexpr int kPitch = kMaxD + 1;
constexpr int kThreads = 256;

struct Params {
  const __nv_bfloat16* x;   // [BH, S, dh]
  const float* dt;          // [BH, S]
  const float* a;           // [BH]
  const __nv_bfloat16* b;   // [G, S, ds]
  const __nv_bfloat16* c;   // [G, S, ds]
  const float* d;           // [BH]
  __nv_bfloat16* y;         // [BH, S, dh]
  float* h_out;             // [BH, ds, dh]
  int seq, dh, ds, heads_per_group;
};

// floats of dynamic shared memory
constexpr int kSmemFloats = 5 * kQ * kPitch + 3 * kQ;

__global__ void __launch_bounds__(kThreads)
mamba2_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Xs = smem;                 // [Q][pitch]   x chunk
  float* Bs = Xs + kQ * kPitch;     // [Q][pitch]   B chunk
  float* Cs = Bs + kQ * kPitch;     // [Q][pitch]   C chunk
  float* Ms = Cs + kQ * kPitch;     // [Q][pitch]   masked C B^T decay dt
  float* Hs = Ms + kQ * kPitch;     // [ds][pitch]  running state
  float* dts = Hs + kQ * kPitch;    // [Q] dt
  float* cum = dts + kQ;            // [Q] inclusive cumsum of dt a
  float* wts = cum + kQ;            // [Q] exp(cum_Q - cum_j) dt_j

  const int row = blockIdx.x;
  const int grp = row / p.heads_per_group;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float a = p.a[row];
  const float dskip = p.d[row];
  const __nv_bfloat16* xb = p.x + (long long)row * p.seq * p.dh;
  const float* dtb = p.dt + (long long)row * p.seq;
  const __nv_bfloat16* bb = p.b + (long long)grp * p.seq * p.ds;
  const __nv_bfloat16* cb = p.c + (long long)grp * p.seq * p.ds;
  __nv_bfloat16* yb = p.y + (long long)row * p.seq * p.dh;

  for (int e = tid; e < kMaxD * kPitch; e += kThreads) Hs[e] = 0.f;

  for (int t0 = 0; t0 < p.seq; t0 += kQ) {
    // ---- load the chunk (zeros past the end and past dh / ds) -----------
    for (int e = tid; e < kQ * kMaxD; e += kThreads) {
      const int t = e / kMaxD, col = e % kMaxD;
      const bool in = t0 + t < p.seq;
      float xv = 0.f, bv = 0.f, cv = 0.f;
      if (in && col < p.dh)
        xv = __bfloat162float(xb[(long long)(t0 + t) * p.dh + col]);
      if (in && col < p.ds) {
        bv = __bfloat162float(bb[(long long)(t0 + t) * p.ds + col]);
        cv = __bfloat162float(cb[(long long)(t0 + t) * p.ds + col]);
      }
      Xs[t * kPitch + col] = xv;
      Bs[t * kPitch + col] = bv;
      Cs[t * kPitch + col] = cv;
    }
    if (tid < 32) {
      // warp scan of dt * a over the 64 steps, two per lane
      const int t = 2 * tid;
      const float d0 = (t0 + t < p.seq) ? dtb[t0 + t] : 0.f;
      const float d1 = (t0 + t + 1 < p.seq) ? dtb[t0 + t + 1] : 0.f;
      const float l0 = d0 * a, l1 = d1 * a;
      float incl = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - (l0 + l1);
      dts[t] = d0;
      dts[t + 1] = d1;
      cum[t] = excl + l0;
      cum[t + 1] = incl;
    }
    __syncthreads();

    // ---- M = (C B^T) * exp(cum_i - cum_j) * dt_j for j <= i, else 0 --------
    {
      float acc[4][4] = {};
      for (int k = 0; k < p.ds; ++k) {
        float cr[4], br[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = Cs[(ty + 16 * r) * kPitch + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) br[q] = Bs[(tx + 16 * q) * kPitch + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cr[r], br[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = tx + 16 * q;
          Ms[i * kPitch + j] =
              (j <= i) ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
      }
      if (tid < kQ) wts[tid] = expf(cum[kQ - 1] - cum[tid]) * dts[tid];
    }
    __syncthreads();

    // ---- y = M x + exp(cum) (C h_prev) + D x --------------------------------
    {
      float acc[4][4] = {};
      float st[4][4] = {};
      for (int j = 0; j < kQ; ++j) {
        float mr[4], xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) mr[r] = Ms[(ty + 16 * r) * kPitch + j];
#pragma unroll
        for (int q = 0; q < 4; ++q) xr[q] = Xs[j * kPitch + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(mr[r], xr[q], acc[r][q]);
      }
      for (int s = 0; s < p.ds; ++s) {
        float cr[4], hr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cr[r] = Cs[(ty + 16 * r) * kPitch + s];
#pragma unroll
        for (int q = 0; q < 4; ++q) hr[q] = Hs[s * kPitch + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) st[r][q] = fmaf(cr[r], hr[q], st[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
        if (t0 + i >= p.seq) continue;
        const float ec = expf(cum[i]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = tx + 16 * q;
          if (col < p.dh) {
            const float v = acc[r][q] + ec * st[r][q] + dskip * Xs[i * kPitch + col];
            yb[(long long)(t0 + i) * p.dh + col] = __float2bfloat16(v);
          }
        }
      }
    }
    __syncthreads();  // every thread has read h_prev

    // ---- h = exp(cum_Q) h_prev + sum_j w_j B_j x_j^T ------------------------
    {
      const float total = expf(cum[kQ - 1]);
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          acc[r][q] = total * Hs[(ty + 16 * r) * kPitch + tx + 16 * q];
      for (int j = 0; j < kQ; ++j) {
        const float w = wts[j];
        float br[4], xr[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) br[r] = Bs[j * kPitch + ty + 16 * r] * w;
#pragma unroll
        for (int q = 0; q < 4; ++q) xr[q] = Xs[j * kPitch + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(br[r], xr[q], acc[r][q]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          Hs[(ty + 16 * r) * kPitch + tx + 16 * q] = acc[r][q];
    }
    __syncthreads();  // the next chunk overwrites X, B, C
  }

  float* hb = p.h_out + (long long)row * p.ds * p.dh;
  for (int e = tid; e < p.ds * p.dh; e += kThreads) {
    const int s = e / p.dh, col = e % p.dh;
    hb[e] = Hs[s * kPitch + col];
  }
}

}  // namespace

// x [BH, S, dh] bf16, dt [BH, S] f32, a/d [BH] f32, b/c [G, S, ds] bf16
// with BH = G * heads_per_group, all contiguous; dh, ds <= 64.  Writes
// y [BH, S, dh] bf16 and the final state h [BH, ds, dh] f32.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int mamba2_scan(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* d,
                           void* y, void* h_out, int rows, int seq, int dh,
                           int ds, int heads_per_group, void* stream) {
  if (dh < 1 || dh > kMaxD || ds < 1 || ds > kMaxD || heads_per_group < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.c = static_cast<const __nv_bfloat16*>(c);
  p.d = static_cast<const float*>(d);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.h_out = static_cast<float*>(h_out);
  p.seq = seq; p.dh = dh; p.ds = ds; p.heads_per_group = heads_per_group;
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mamba2_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mamba2_scan_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
