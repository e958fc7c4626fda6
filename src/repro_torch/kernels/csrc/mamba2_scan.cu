// Mamba2 (SSD) chunked selective scan for Hopper (sm_90a), bf16 in and out,
// fp32 state, returning the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/mamba2_scan.py
// (mamba2_scan / _mamba2_kernel).  Per head, with h a [ds, dh] state:
//
//   h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T,   y_t = C_t^T h_t + D x_t
//
// evaluated chunk by chunk (Q = 64 steps): with cum the inclusive cumsum of
// dt a inside the chunk,
//
//   y_i  = exp(cum_i) C_i^T h_prev
//          + sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + D x_i
//   h    = exp(cum_Q) h_prev + sum_j B_j (exp(cum_Q - cum_j) dt_j) x_j^T
//
// On the TPU the chunk axis is the inner, sequential grid axis and h lives
// in VMEM scratch between grid steps.  Blocks on Hopper run in no order, so
// a block walks the chunks of its rows itself and keeps h in shared memory;
// the final state is written once at the end (the prefill's decode state).
//
// What bounds it on an H100: bytes.  At the Zamba2-7B prefill shape (448
// rows of 512 steps, dh = ds = 64, one B/C group per sequence) it reads x,
// dt and the shared B/C and writes y and the final state, about 68 MB or
// 0.020 ms at 3.35 TB/s, against about 7.5 GFLOP of chunk products.  The
// chunk-to-chunk chain of each head is serial, so what sets the time is
// the instructions each chunk step issues.  The design:
//
//   * Tensor cores.  One warpgroup owns one head, and each chunk's four
//     products are wgmma m64n64k16 (bf16 in, fp32 accumulate): C B^T and
//     C h_prev with both operands read from shared memory through
//     128-byte-swizzle descriptors (B K-major; h and x N-major through the
//     transpose bit), M x and B_w^T x with the A operand in registers.  One
//     instruction per 64 x 64 x 16 step replaces 32 mma.sync and their
//     ldmatrix loads.  C, B and x are bf16 already and enter exactly.  The
//     operands made in fp32 (the decayed M = C B^T exp(cum_i - cum_j) dt_j,
//     B scaled by the state weights, and the state h itself) enter as a
//     split pair hi + lo of bf16 (hi = bf16(v), lo = bf16(v - hi)), two
//     products each, which keeps them to about 2^-16 of their value: the
//     output is as close to the fp32 recurrence as bf16 rounding of y
//     allows.
//   * The upper triangle.  M is zero there (selected, so exp never sees a
//     positive exponent) and never leaves registers: the accumulators of
//     C B^T are re-packed as the register A operand of M x, as flash
//     attention does with P.  A wgmma spans all 64 rows of the chunk, so
//     the triangle's zeros ride along at no instruction cost.
//   * Loads.  Each chunk's x, B and C tiles arrive with cp.async into a
//     double buffer while the block computes on the previous chunk; dt for
//     the next chunk is prefetched into registers.  Tiles are 64 x 64 bf16
//     with 128-byte rows, XOR-swizzled as wgmma's 128-byte layout expects.
//   * Stores.  y leaves in 16-byte stores: a 4 x 4 transpose over the 4
//     lanes of each accumulator row gives each lane 8 consecutive columns.
//   * Parallelism.  A block of 2 warpgroups owns two heads of one sequence
//     (Mamba2 shares one B/C group among all the heads of a sequence): the
//     two heads share each chunk's B and C loads.  About 99 KB of shared
//     memory and 128 registers a thread put two blocks, four heads, on
//     each SM, so the 448 rows of Zamba2 run in one wave.  Where the heads
//     of a group are odd in number (B/C per head), a block of one
//     warpgroup owns one head.
//   * Two block barriers per chunk: one after the chunk's data and
//     log-decays land, one before the state is rewritten.
//
// Ragged tail: steps past S load as x = B = C = 0 and dt = 0, so they
// leave the state unchanged and their y rows are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kQ = 64;             // chunk length
constexpr int kMaxD = 64;          // dh, ds <= 64, multiples of 8
constexpr int kTile = kQ * 64;     // bf16 elements of one 64 x 64 tile
constexpr float kLog2e = 1.4426950408889634f;

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

template <int HPB>
struct Smem {
  // [2 buffers] x (B tile, C tile, HPB x tiles); [HPB] h hi; [HPB] h lo;
  // then fp32 [2 parities][HPB][kQ] log2-domain cumsum and dt
  static constexpr int kBufTiles = 2 + HPB;
  static constexpr int kTiles = 2 * kBufTiles + 2 * HPB;
  static constexpr int kBytes = kTiles * kTile * 2 + 2 * 2 * HPB * kQ * 4 + 1024;
};

template <int HPB>
__global__ void __launch_bounds__(128 * HPB, 2)
mamba2_scan_kernel(const Params p) {
  using SM = Smem<HPB>;
  constexpr int kThreads = 128 * HPB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // wgmma reads the tiles through 128-byte-swizzle descriptors: 1024-aligned
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  float* cum2_all = reinterpret_cast<float*>(tiles + SM::kTiles * kTile);  // [2][HPB][kQ]
  float* dts_all = cum2_all + 2 * HPB * kQ;                                // [2][HPB][kQ]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int hh = warp / 4;      // head of this warp within the block
  const int w = warp % 4;       // chunk rows 16w..16w+15 (y) and state rows (h)
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int row_base = blockIdx.x * HPB;
  const int row = row_base + hh;
  const int grp = row_base / p.heads_per_group;
  const int S = p.seq;
  const int n_chunks = (S + kQ - 1) / kQ;

  auto tile = [&](int buf, int k) { return tiles + (buf * SM::kBufTiles + k) * kTile; };
  __nv_bfloat16* Hhi = tiles + (2 * SM::kBufTiles + hh) * kTile;
  __nv_bfloat16* Hlo = tiles + (2 * SM::kBufTiles + HPB + hh) * kTile;

  // one chunk's B, C and x tiles into buffer `buf`, 16 bytes a copy,
  // zero-filled past S and past ds / dh
  auto issue = [&](int chunk, int buf) {
    const int t0 = chunk * kQ;
    for (int e = tid; e < SM::kBufTiles * kQ * 8; e += kThreads) {
      const int k = e / (kQ * 8);
      const int r = (e / 8) % kQ;
      const int col = (e % 8) * 8;
      const __nv_bfloat16* src;
      int width;
      if (k == 0) {
        src = p.b + ((long long)grp * S + t0 + r) * p.ds + col;
        width = p.ds;
      } else if (k == 1) {
        src = p.c + ((long long)grp * S + t0 + r) * p.ds + col;
        width = p.ds;
      } else {
        src = p.x + ((long long)(row_base + k - 2) * S + t0 + r) * p.dh + col;
        width = p.dh;
      }
      const bool in = (t0 + r < S) && (col < width);
      cp_async16(smem_addr(tile(buf, k) + swz(r, col)), in ? src : p.x, in ? 16 : 0);
    }
    cp_async_commit();
  };

  const float* dt_row = p.dt + (long long)row * S;
  const float a2 = p.a[row] * kLog2e;
  const float dskip = p.d[row];
  float dt0 = 0.f, dt1 = 0.f;   // this lane's two dt of the next chunk (warp 0 of a head)
  if (w == 0) {
    dt0 = (2 * lane < S) ? dt_row[2 * lane] : 0.f;
    dt1 = (2 * lane + 1 < S) ? dt_row[2 * lane + 1] : 0.f;
  }
  issue(0, 0);
  for (int e = tid; e < 2 * HPB * kTile / 2; e += kThreads)
    reinterpret_cast<uint32_t*>(tiles + 2 * SM::kBufTiles * kTile)[e] = 0u;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * kQ;
    const int buf = chunk & 1;
    float* cum2 = cum2_all + (buf * HPB + hh) * kQ;
    float* dts = dts_all + (buf * HPB + hh) * kQ;
    cp_async_wait<0>();
    fence_proxy_async();   // the copies and the state writes, to wgmma's reads
    if (w == 0) {
      // log2-domain inclusive cumsum of dt * a over the 64 steps, two a lane
      const float l0 = dt0 * a2, l1 = dt1 * a2;
      float incl = l0 + l1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      cum2[2 * lane] = incl - l1;
      cum2[2 * lane + 1] = incl;
      dts[2 * lane] = dt0;
      dts[2 * lane + 1] = dt1;
    }
    __syncthreads();   // the chunk's tiles, log-decays and the state are in place
    if (chunk + 1 < n_chunks) {
      issue(chunk + 1, buf ^ 1);
      if (w == 0) {
        const int t = t0 + kQ + 2 * lane;
        dt0 = (t < S) ? dt_row[t] : 0.f;
        dt1 = (t + 1 < S) ? dt_row[t + 1] : 0.f;
      }
    }
    const __nv_bfloat16* Bs = tile(buf, 0);
    const __nv_bfloat16* Cs = tile(buf, 1);
    const __nv_bfloat16* Xs = tile(buf, 2 + hh);
    const int i0 = 16 * w + gid;   // this thread's two chunk rows
    const int i1 = i0 + 8;
    const float ci0 = cum2[i0], ci1 = cum2[i1];
    const float cq = cum2[kQ - 1];

    const uint32_t cs = smem_addr(Cs), bs = smem_addr(Bs), xs = smem_addr(Xs);
    const uint32_t hs_hi = smem_addr(Hhi), hs_lo = smem_addr(Hlo);

    // ---- G = C B^T (64 x 64, k = s): both operands K-major in shared memory ----
    float g[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) g[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(g, desc_sw128(cs + kk * 32, 16), desc_sw128(bs + kk * 32, 16), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(g);

    // ---- M = G exp(cum_i - cum_j) dt_j for j <= i, as hi + lo register A
    //      operands of M x (k-step jj covers n-tiles 2jj, 2jj+1 of G) ----
    uint32_t mhi[4][4], mlo[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * jj + half;
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e < 2) ? i0 : i1;
          const float ci = (e < 2) ? ci0 : ci1;
          const int j = 8 * n + 2 * tig + (e & 1);
          m[e] = (j <= i) ? g[4 * n + e] * fast_exp2(ci - cum2[j]) * dts[j] : 0.f;
        }
        split2(m[0], m[1], mhi[jj][2 * half], mlo[jj][2 * half]);
        split2(m[2], m[3], mhi[jj][2 * half + 1], mlo[jj][2 * half + 1]);
      }
    }

    // ---- y = exp(cum_i) C_i^T h_prev + M x ----
    float y[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) y[i] = 0.f;
    if (chunk > 0) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_sw128(cs + kk * 32, 16);
        wgmma_ss_n64_bt(y, da, desc_sw128(hs_hi + kk * 2048, 8192), 1);
        wgmma_ss_n64_bt(y, da, desc_sw128(hs_lo + kk * 2048, 8192), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(y);
      const float e0 = fast_exp2(ci0), e1 = fast_exp2(ci1);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        y[4 * n + 0] *= e0; y[4 * n + 1] *= e0;
        y[4 * n + 2] *= e1; y[4 * n + 3] *= e1;
      }
    }
    wgmma_fence();
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const uint64_t db = desc_sw128(xs + jj * 2048, 8192);
      wgmma_rs_n64(y, mhi[jj], db);
      wgmma_rs_n64(y, mlo[jj], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(y);

    // ---- y += D x, packed to bf16; a 4 x 4 transpose over the 4 lanes of a
    //      row gives each lane 8 consecutive columns, one 16-byte store ----
    __nv_bfloat16* yb = p.y + (long long)row * S * p.dh;
#pragma unroll
    for (int yh = 0; yh < 2; ++yh) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? i1 : i0;
        uint32_t v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int n = 4 * yh + t;
          const int col = 8 * n + 2 * tig;
          const float2 xv = unpack2(*reinterpret_cast<const uint32_t*>(Xs + swz(i, col)));
          v[t] = pack_bf16x2(y[4 * n + 2 * half] + dskip * xv.x,
                             y[4 * n + 2 * half + 1] + dskip * xv.y);
        }
        transpose_quad(v, tig);
        const int col = 32 * yh + 8 * tig;
        if (t0 + i < S && col < p.dh)
          *reinterpret_cast<uint4*>(yb + (long long)(t0 + i) * p.dh + col) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();   // every warp has read h_prev

    // ---- h = exp(cum_Q) h_prev + sum_j B_j (exp(cum_Q - cum_j) dt_j) x_j^T,
    //      state rows s = 16w..16w+15 ----
    float hacc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) hacc[i] = 0.f;
    uint32_t shi[4][4], slo[4][4];   // (B o w)^T rows s as register A operands, k = j
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ab[4];
      ldmatrix_x4_trans(ab, smem_addr(Bs + swz(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                                16 * w + ((lane >> 3) & 1) * 8)));
      const int j0 = 16 * kk + 2 * tig;
      const float w0 = fast_exp2(cq - cum2[j0]) * dts[j0];
      const float w1 = fast_exp2(cq - cum2[j0 + 1]) * dts[j0 + 1];
      const float w8 = fast_exp2(cq - cum2[j0 + 8]) * dts[j0 + 8];
      const float w9 = fast_exp2(cq - cum2[j0 + 9]) * dts[j0 + 9];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 v = unpack2(ab[e]);
        split2(v.x * ((e < 2) ? w0 : w8), v.y * ((e < 2) ? w1 : w9), shi[kk][e], slo[kk][e]);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(xs + kk * 2048, 8192);
      wgmma_rs_n64(hacc, shi[kk], db);
      wgmma_rs_n64(hacc, slo[kk], db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_operands(hacc);
    const float decay = fast_exp2(cq);
    const bool last = chunk + 1 == n_chunks;
    float* hb = p.h_out + (long long)row * p.ds * p.dh;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = 8 * t + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = 16 * w + gid + 8 * half;
        uint32_t* phi = reinterpret_cast<uint32_t*>(Hhi + swz(s, col));
        uint32_t* plo = reinterpret_cast<uint32_t*>(Hlo + swz(s, col));
        const float2 oh = unpack2(*phi), ol = unpack2(*plo);
        const float v0 = decay * (oh.x + ol.x) + hacc[4 * t + 2 * half];
        const float v1 = decay * (oh.y + ol.y) + hacc[4 * t + 2 * half + 1];
        split2(v0, v1, *phi, *plo);
        if (last && s < p.ds && col < p.dh)
          *reinterpret_cast<float2*>(hb + s * p.dh + col) = make_float2(v0, v1);
      }
    }
  }
}

template <int HPB>
cudaError_t launch(const Params& p, int rows, cudaStream_t stream) {
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        mamba2_scan_kernel<HPB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<HPB>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  mamba2_scan_kernel<HPB><<<rows / HPB, 128 * HPB, Smem<HPB>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x [BH, S, dh] bf16, dt [BH, S] f32, a/d [BH] f32, b/c [G, S, ds] bf16
// with BH = G * heads_per_group, all contiguous; dh, ds multiples of 8 up
// to 64.  Writes y [BH, S, dh] bf16 and the final state h [BH, ds, dh] f32.
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int mamba2_scan(const void* x, const void* dt, const void* a,
                           const void* b, const void* c, const void* d,
                           void* y, void* h_out, int rows, int seq, int dh,
                           int ds, int heads_per_group, void* stream) {
  if (dh < 8 || dh > kMaxD || dh % 8 || ds < 8 || ds > kMaxD || ds % 8 ||
      heads_per_group < 1 || seq < 1)
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // two heads of one group per block where a group's heads pair up
  if (heads_per_group % 2 == 0) return static_cast<int>(launch<2>(p, rows, s));
  return static_cast<int>(launch<1>(p, rows, s));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
