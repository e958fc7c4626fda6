// RWKV-6 ("Finch") chunked WKV scan for Hopper (sm_90a), bf16 r/k/v in and
// y out, fp32 log-decays, arithmetic and state, returning the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py
// (rwkv6_scan / _rwkv6_kernel).  Per head, with S a [dk, dv] state and
// per-channel decays w_t = exp(logw_t):
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// evaluated chunk by chunk (Q = 32 steps): with cum the inclusive cumsum of
// logw inside the chunk and cp = cum - logw,
//
//   y_i = sum_{j<i} (sum_c r_ic k_jc exp(cp_ic - cum_jc)) v_j
//         + (sum_c r_ic u_c k_ic) v_i + (r_i * exp(cp_i))^T S_prev
//   S   = diag(exp(cum_Q)) S_prev + sum_j (k_j * exp(cum_Q - cum_j)) v_j^T
//
// The TPU kernel factorises the intra-chunk term as (r exp(cp)) (k exp(-cum))^T
// and masks the product afterwards.  Its k exp(-cum) grows as e^{-cum}: at
// RWKV6-7B's width one chunk's log-decays already sum to about -72, near
// fp32's e^88.7 limit, and faster decays overflow.  This kernel never forms
// a positive exponent: each pair j < i takes exp(cp_i - cum_j) <= 0 per
// channel, and the state terms use exp(cp_i) and exp(cum_Q - cum_j), both
// <= 1.  The price is one exp per (i, j, channel) of the lower triangle,
// 32 x 31 / 2 x 64 per chunk.
//
// On the TPU the chunk axis is the inner, sequential grid axis and S lives
// in VMEM scratch.  Here one block of 256 threads owns one (batch, head)
// row and loops over the chunks; S stays in shared memory and is written
// out once at the end (the prefill's decode state).  The per-channel
// cumulative log-decays come from warp shuffle scans (lane = step).
//
// What bounds it on an H100: at the RWKV6-7B prefill shape (256 rows of 512
// steps, dk = dv = 64) the bytes are r, k, v (bf16, 50 MB), logw (fp32,
// 34 MB), y and the final state, about 105 MB or 0.031 ms at 3.35 TB/s; the
// products are about 3 GFLOP.  This first version computes them in fp32 on
// the CUDA cores from padded shared-memory tiles (pitch 65 floats); wgmma,
// TMA and a cheaper safe factorisation are later work.
//
// Ragged tail: steps past S load as r = k = v = 0 and logw = 0, so they
// leave the state unchanged and their y rows are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kQ = 32;        // chunk length (one warp lane per step)
constexpr int kMaxD = 64;     // dk, dv <= 64
constexpr int kPitch = kMaxD + 1;
constexpr int kAttPitch = kQ + 1;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const __nv_bfloat16* r;   // [BH, S, dk]
  const __nv_bfloat16* k;   // [BH, S, dk]
  const __nv_bfloat16* v;   // [BH, S, dv]
  const float* logw;        // [BH, S, dk]
  const float* u;           // [BH, dk]
  __nv_bfloat16* y;         // [BH, S, dv]
  float* s_out;             // [BH, dk, dv]
  int seq, dk, dv;
};

constexpr int kSmemFloats =
    5 * kQ * kPitch + kQ * kAttPitch + kMaxD * kPitch + kMaxD;

__global__ void __launch_bounds__(kThreads)
rwkv6_scan_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Rs = smem;                 // [Q][pitch] r, then r * exp(cp)
  float* Ks = Rs + kQ * kPitch;     // [Q][pitch] k, then k * exp(cum_Q - cum)
  float* Vs = Ks + kQ * kPitch;     // [Q][pitch] v
  float* Cm = Vs + kQ * kPitch;     // [Q][pitch] logw, then cum
  float* Cp = Cm + kQ * kPitch;     // [Q][pitch] cum - logw
  float* Att = Cp + kQ * kPitch;    // [Q][Q + 1] intra-chunk weights
  float* Ss = Att + kQ * kAttPitch; // [dk][pitch] running state
  float* Us = Ss + kMaxD * kPitch;  // [dk] bonus

  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long base_k = (long long)row * p.seq * p.dk;
  const long long base_v = (long long)row * p.seq * p.dv;
  const __nv_bfloat16* rb = p.r + base_k;
  const __nv_bfloat16* kb = p.k + base_k;
  const __nv_bfloat16* vb = p.v + base_v;
  const float* wb = p.logw + base_k;
  __nv_bfloat16* yb = p.y + base_v;

  for (int e = tid; e < kMaxD * kPitch; e += kThreads) Ss[e] = 0.f;
  for (int c = tid; c < kMaxD; c += kThreads)
    Us[c] = c < p.dk ? p.u[(long long)row * p.dk + c] : 0.f;

  for (int t0 = 0; t0 < p.seq; t0 += kQ) {
    // ---- load the chunk (zeros past the end and past dk / dv) -----------
    for (int e = tid; e < kQ * kMaxD; e += kThreads) {
      const int t = e / kMaxD, col = e % kMaxD;
      const bool in = t0 + t < p.seq;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (in && col < p.dk) {
        const long long off = (long long)(t0 + t) * p.dk + col;
        rv = __bfloat162float(rb[off]);
        kv = __bfloat162float(kb[off]);
        wv = wb[off];
      }
      if (in && col < p.dv) vv = __bfloat162float(vb[(long long)(t0 + t) * p.dv + col]);
      Rs[t * kPitch + col] = rv;
      Ks[t * kPitch + col] = kv;
      Vs[t * kPitch + col] = vv;
      Cm[t * kPitch + col] = wv;
    }
    __syncthreads();

    // ---- per-channel inclusive scan over the 32 steps: lane = step --------
    for (int c = warp; c < p.dk; c += kWarps) {
      const float w = Cm[lane * kPitch + c];
      float incl = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      Cm[lane * kPitch + c] = incl;
      Cp[lane * kPitch + c] = incl - w;
    }
    __syncthreads();

    // ---- Att[i][j] = sum_c r_ic k_jc exp(cp_ic - cum_jc), j < i;
    //      Att[i][i] = sum_c r_ic u_c k_ic; zero above ---------------------
    {
      const int i = tid >> 3;          // 32 rows, 8 threads each
      const int g = tid & 7;           // columns g, g + 8, g + 16, g + 24
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      float bonus = 0.f;
      if (i > g) {                     // some column of this thread is < i
        for (int c = 0; c < p.dk; ++c) {
          const float rc = Rs[i * kPitch + c];
          const float cpc = Cp[i * kPitch + c];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = g + 8 * q;
            if (j < i)
              acc[q] = fmaf(rc * Ks[j * kPitch + c],
                            __expf(cpc - Cm[j * kPitch + c]), acc[q]);
          }
        }
      }
      if (g == (i & 7)) {              // the thread whose columns hold j = i
        for (int c = 0; c < p.dk; ++c)
          bonus = fmaf(Rs[i * kPitch + c] * Us[c], Ks[i * kPitch + c], bonus);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = g + 8 * q;
        Att[i * kAttPitch + j] = j < i ? acc[q] : (j == i ? bonus : 0.f);
      }
    }
    __syncthreads();

    // ---- r <- r * exp(cp); k <- k * exp(cum_Q - cum) (exponents <= 0) ----
    for (int e = tid; e < kQ * p.dk; e += kThreads) {
      const int t = e / p.dk, c = e % p.dk;
      Rs[t * kPitch + c] *= __expf(Cp[t * kPitch + c]);
      Ks[t * kPitch + c] *= __expf(Cm[(kQ - 1) * kPitch + c] - Cm[t * kPitch + c]);
    }
    __syncthreads();

    // ---- y = Att v + (r exp(cp)) S_prev ----------------------------------
    {
      const int tx = lane;             // columns tx, tx + 32
      const int ty = warp;             // rows ty + 8 m, m < 4
      float acc[4][2] = {};
      for (int j = 0; j < kQ; ++j) {
        const float v0 = Vs[j * kPitch + tx], v1 = Vs[j * kPitch + tx + 32];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float a = Att[(ty + 8 * m) * kAttPitch + j];
          acc[m][0] = fmaf(a, v0, acc[m][0]);
          acc[m][1] = fmaf(a, v1, acc[m][1]);
        }
      }
      for (int c = 0; c < p.dk; ++c) {
        const float s0 = Ss[c * kPitch + tx], s1 = Ss[c * kPitch + tx + 32];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float rr = Rs[(ty + 8 * m) * kPitch + c];
          acc[m][0] = fmaf(rr, s0, acc[m][0]);
          acc[m][1] = fmaf(rr, s1, acc[m][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int i = ty + 8 * m;
        if (t0 + i >= p.seq) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = tx + 32 * h;
          if (col < p.dv)
            yb[(long long)(t0 + i) * p.dv + col] = __float2bfloat16(acc[m][h]);
        }
      }
    }
    __syncthreads();  // every thread has read S_prev

    // ---- S = diag(exp(cum_Q)) S_prev + sum_j k~_j v_j^T -------------------
    {
      const int tx = lane;             // columns tx, tx + 32
      const int ty = warp;             // channels ty + 8 m, m < 8
      float acc[8][2];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int c = ty + 8 * m;
        const float decay = __expf(Cm[(kQ - 1) * kPitch + c]);
        acc[m][0] = decay * Ss[c * kPitch + tx];
        acc[m][1] = decay * Ss[c * kPitch + tx + 32];
      }
      for (int j = 0; j < kQ; ++j) {
        const float v0 = Vs[j * kPitch + tx], v1 = Vs[j * kPitch + tx + 32];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const float kk = Ks[j * kPitch + ty + 8 * m];
          acc[m][0] = fmaf(kk, v0, acc[m][0]);
          acc[m][1] = fmaf(kk, v1, acc[m][1]);
        }
      }
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int c = ty + 8 * m;
        Ss[c * kPitch + tx] = acc[m][0];
        Ss[c * kPitch + tx + 32] = acc[m][1];
      }
    }
    __syncthreads();  // the next chunk overwrites r, k, v, cum
  }

  float* sb = p.s_out + (long long)row * p.dk * p.dv;
  for (int e = tid; e < p.dk * p.dv; e += kThreads) {
    const int c = e / p.dv, col = e % p.dv;
    sb[e] = Ss[c * kPitch + col];
  }
}

}  // namespace

// r/k [BH, S, dk] bf16, v [BH, S, dv] bf16, logw [BH, S, dk] f32 (<= 0),
// u [BH, dk] f32, all contiguous; dk, dv <= 64.  Writes y [BH, S, dv] bf16
// and the final state [BH, dk, dv] f32.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, void* y,
                          void* s_out, int rows, int seq, int dk, int dv,
                          void* stream) {
  if (dk < 1 || dk > kMaxD || dv < 1 || dv > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.r = static_cast<const __nv_bfloat16*>(r);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.s_out = static_cast<float*>(s_out);
  p.seq = seq; p.dk = dk; p.dv = dv;
  const int smem = kSmemFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rwkv6_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  rwkv6_scan_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
