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
#include "tile64.cuh"

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

// ---------------------------------------------------------------------------
// The backward: mamba2_scan_bwd.
//
// The TPU kernel has no backward: the reference differentiates its jnp twin
// (mamba2_chunked_jnp) with JAX.  This kernel computes the same gradients,
// given dy and an optional gradient of the final state, chunk by chunk in
// reverse.  Per chunk (Q = 64 steps, cum the inclusive cumsum of dt a, h0
// the state at the chunk's start, g the gradient of the state at its end;
// for j <= i, zero above: L_ij = exp(cum_i - cum_j), CBL_ij = (C_i . B_j)
// L_ij, dML_ij = (dy_i . x_j) L_ij, P_ij = dML_ij (C_i . B_j)):
//
//   dx_j  = dt_j sum_i CBL_ij dy_i + D dy_j + w_j g^T B_j,   w_j = exp(cum_Q - cum_j) dt_j
//   dC_i  = sum_j dML_ij dt_j B_j + exp(cum_i) h0 dy_i
//   dB_j  = dt_j sum_i dML_ij C_i + w_j g x_j
//   dcum_i = sum_j P_ij dt_j - dt_i sum_k P_ki + exp(cum_i) C_i . (h0 dy_i)
//            - dt_i exp(cum_Q - cum_i) B_i^T g x_i  (+ <g, h_end> at i = Q - 1)
//   ddt_i = sum_k P_ki + exp(cum_Q - cum_i) B_i^T g x_i + a R_i,   da += sum_i dt_i R_i
//   g    <- exp(cum_Q) g + sum_i exp(cum_i) C_i dy_i^T
//
// with R the reverse cumsum of dcum inside the chunk (cum = a cumsum(dt)).
// Every exponent is <= 0.  dD = sum dy . x.  B and C are read by group; dB
// and dC leave as per-row fp32 partials [BH, S, ds], which the wrapper sums
// over a group's rows in a fixed order (no float atomics).
//
// States: a first forward walk writes each chunk's starting state and the
// final state into an fp32 scratch [BH, nc + 1, ds, dh] (recomputed rather
// than saved by the forward: 58.7 MB at Zamba2's [448, 512, 64], which
// training would hold from each layer's forward to its backward, 1.4 GB
// over 24 layers; recomputing costs one state update per chunk, a ninth of
// the backward's products, and the scratch lives only during the call).
//
// What bounds it on an H100: bytes, at Zamba2's shape about 91 MB read and
// written (0.027 ms at 3.35 TB/s; the scratch adds 2 x 66 MB through L2)
// against about 19 GFLOP of fp32 products.  This first version is plain
// fp32 FMA: one block of 256 threads a row (Zamba2: 448 blocks), every
// operand in shared memory as 64 x 64 fp32 tiles (tile64.cuh), each thread
// a 4 x 4 register tile of each product; the rows' chains are serial, the
// products run at the shared-memory load rate.  Making it fast (the
// tensor-core products of the forward) is later work.
namespace bwd {

using tile64::block_sum;
using tile64::col0;
using tile64::kLd;
using tile64::kQ;
using tile64::kThreads;
using tile64::kTile;
using tile64::load;
using tile64::product;
using tile64::row0;
using tile64::store;
using tile64::zero;

struct BwdParams {
  const __nv_bfloat16 *x, *b, *c, *dy;
  const float *dt, *a, *d, *dh_final;   // dh_final: null = zero
  __nv_bfloat16* dx;
  float *ddt, *da, *dd, *db, *dc, *states;
  int seq, dh, ds, heads_per_group, chunks;
};

// shared memory: 9 fp32 tiles, then vectors of kQ floats, then kThreads
constexpr int kTiles = 9;
constexpr int kVecs = 10;
constexpr int kSmem = (kTiles * kTile + kVecs * kQ + kThreads) * 4;

__global__ void __launch_bounds__(kThreads, 1) mamba2_bwd_kernel(const BwdParams p) {
  extern __shared__ float sm[];
  float *X = sm, *DY = X + kTile, *Bt = DY + kTile, *Ct = Bt + kTile;
  float *H0 = Ct + kTile, *G = H0 + kTile;
  float *M1 = G + kTile, *M2 = M1 + kTile, *M3 = M2 + kTile;
  float *dtv = M3 + kTile, *cum = dtv + kQ, *ecum = cum + kQ, *tail = ecum + kQ;
  float *rowp = tail + kQ, *colp = rowp + kQ, *qv = colp + kQ, *czv = qv + kQ;
  float *dcum = czv + kQ, *misc = dcum + kQ, *red = misc + kQ;

  const int row = blockIdx.x, tid = threadIdx.x;
  const int ti = row0(), tj = col0();
  const int group = row / p.heads_per_group;
  const long long xrow = (long long)row * p.seq;     // x, dy, dt, db, dc rows
  const long long grow = (long long)group * p.seq;   // b, c rows
  const float a = p.a[row], dskip = p.d[row];
  const long long state_elems = (long long)p.ds * p.dh;
  float* states = p.states + (long long)row * (p.chunks + 1) * state_elems;

  // the chunk's dt and inclusive cumsum of dt a (one thread, in order)
  auto chunk_scalars = [&](int base, int steps) {
    if (tid < kQ) dtv[tid] = tid < steps ? p.dt[xrow + base + tid] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < kQ; ++i) {
        run += dtv[i] * a;
        cum[i] = run;
      }
    }
    __syncthreads();
  };

  // --- the forward walk: each chunk's starting state, then the final one
  for (int e = tid; e < kTile; e += kThreads) G[e] = 0.f;
  for (int ci = 0; ci < p.chunks; ++ci) {
    const int base = ci * kQ, steps = min(kQ, p.seq - base);
    __syncthreads();
    store(states + ci * state_elems, G, p.ds, p.dh);
    load(X, p.x + (xrow + base) * p.dh, steps, p.dh);
    load(Bt, p.b + (grow + base) * p.ds, steps, p.ds);
    chunk_scalars(base, steps);
    const float total = cum[kQ - 1];
    if (tid < kQ) tail[tid] = __expf(total - cum[tid]) * dtv[tid];   // w_j
    __syncthreads();
    float acc[4][4];
    const float decay = __expf(total);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = decay * G[(ti + 16 * m) * kLd + tj + 16 * n];
    product(acc, [&](int s, int j) { return Bt[j * kLd + s] * tail[j]; },
            [&](int q, int j) { return X[j * kLd + q]; });
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) G[(ti + 16 * m) * kLd + tj + 16 * n] = acc[m][n];
  }
  __syncthreads();
  store(states + p.chunks * state_elems, G, p.ds, p.dh);

  // --- the reverse walk; G is now the gradient of the state
  if (p.dh_final)
    load(G, p.dh_final + (long long)row * state_elems, p.ds, p.dh);
  else
    for (int e = tid; e < kTile; e += kThreads) G[e] = 0.f;
  float dd_part = 0.f, da_run = 0.f;
  for (int ci = p.chunks - 1; ci >= 0; --ci) {
    const int base = ci * kQ, steps = min(kQ, p.seq - base);
    __syncthreads();
    load(X, p.x + (xrow + base) * p.dh, steps, p.dh);
    load(DY, p.dy + (xrow + base) * p.dh, steps, p.dh);
    load(Bt, p.b + (grow + base) * p.ds, steps, p.ds);
    load(Ct, p.c + (grow + base) * p.ds, steps, p.ds);
    load(H0, states + ci * state_elems, p.ds, p.dh);
    // <g, h_end>: the gradient of the chunk's total log-decay
    const float* hend = states + (ci + 1) * state_elems;
    float part = 0.f;
    for (int e = tid; e < p.ds * p.dh; e += kThreads)
      part += G[(e / p.dh) * kLd + e % p.dh] * hend[e];
    const float g_hend = block_sum(part, red);
    chunk_scalars(base, steps);
    const float total = cum[kQ - 1];
    if (tid < kQ) {
      ecum[tid] = __expf(cum[tid]);
      tail[tid] = __expf(total - cum[tid]);
    }
    // M1 = C B^T on and below the diagonal
    float acc[4][4];
    zero(acc);
    product(acc, [&](int i, int s) { return Ct[i * kLd + s]; },
            [&](int j, int s) { return Bt[j * kLd + s]; });
    float cbv[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) cbv[m][n] = acc[m][n];
    // dm = dy x^T; M1 = CBL, M2 = dML, M3 = P
    zero(acc);
    product(acc, [&](int i, int q) { return DY[i * kLd + q]; },
            [&](int j, int q) { return X[j * kLd + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = ti + 16 * m, j = tj + 16 * n;
        const float l = j <= i ? __expf(cum[i] - cum[j]) : 0.f;
        M1[i * kLd + j] = cbv[m][n] * l;
        M2[i * kLd + j] = acc[m][n] * l;
        M3[i * kLd + j] = acc[m][n] * l * cbv[m][n];
      }
    __syncthreads();
    if (tid < kQ) {                       // sum_j P_ij dt_j
      float s = 0.f;
      for (int j = 0; j < kQ; ++j) s = fmaf(M3[tid * kLd + j], dtv[j], s);
      rowp[tid] = s;
    } else if (tid < 2 * kQ) {            // sum_i P_ij
      const int j = tid - kQ;
      float s = 0.f;
      for (int i = 0; i < kQ; ++i) s += M3[i * kLd + j];
      colp[j] = s;
    }
    // dx_j = dt_j sum_i CBL_ij dy_i + D dy_j + w_j g^T B_j
    float gb[4][4];
    zero(acc);
    zero(gb);
    product(acc, [&](int j, int i) { return M1[i * kLd + j]; },
            [&](int q, int i) { return DY[i * kLd + q]; });
    product(gb, [&](int j, int s) { return Bt[j * kLd + s]; },
            [&](int q, int s) { return G[s * kLd + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = ti + 16 * m, q = tj + 16 * n;
        const float v = dtv[j] * (acc[m][n] + tail[j] * gb[m][n]) + dskip * DY[j * kLd + q];
        if (j < steps && q < p.dh)
          p.dx[(xrow + base + j) * p.dh + q] = __float2bfloat16(v);
        dd_part = fmaf(DY[j * kLd + q], X[j * kLd + q], dd_part);
      }
    __syncthreads();                      // M1 and M3 are free
    // dB_j = dt_j sum_i dML_ij C_i + w_j g x_j; M1 = B_j . g x_j terms
    float gx[4][4];
    zero(acc);
    zero(gx);
    product(acc, [&](int j, int i) { return M2[i * kLd + j]; },
            [&](int s, int i) { return Ct[i * kLd + s]; });
    product(gx, [&](int j, int q) { return X[j * kLd + q]; },
            [&](int s, int q) { return G[s * kLd + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = ti + 16 * m, s = tj + 16 * n;
        const float v = dtv[j] * (acc[m][n] + tail[j] * gx[m][n]);
        if (j < steps && s < p.ds) p.db[(xrow + base + j) * p.ds + s] = v;
        M1[j * kLd + s] = Bt[j * kLd + s] * gx[m][n];
      }
    // dC_i = sum_j dML_ij dt_j B_j + exp(cum_i) h0 dy_i; M3 = C_i . h0 dy_i terms
    float z[4][4];
    zero(acc);
    zero(z);
    product(acc, [&](int i, int j) { return M2[i * kLd + j] * dtv[j]; },
            [&](int s, int j) { return Bt[j * kLd + s]; });
    product(z, [&](int i, int q) { return DY[i * kLd + q]; },
            [&](int s, int q) { return H0[s * kLd + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = ti + 16 * m, s = tj + 16 * n;
        const float v = acc[m][n] + ecum[i] * z[m][n];
        if (i < steps && s < p.ds) p.dc[(xrow + base + i) * p.ds + s] = v;
        M3[i * kLd + s] = Ct[i * kLd + s] * z[m][n];
      }
    __syncthreads();
    if (tid < kQ) {
      float s1 = 0.f, s2 = 0.f;
      for (int s = 0; s < kQ; ++s) {
        s1 += M1[tid * kLd + s];
        s2 += M3[tid * kLd + s];
      }
      qv[tid] = s1;
      czv[tid] = s2;
    }
    __syncthreads();
    if (tid < kQ) {
      const int i = tid;
      dcum[i] = rowp[i] - dtv[i] * colp[i] + ecum[i] * czv[i] - dtv[i] * tail[i] * qv[i] +
                (i == kQ - 1 ? g_hend : 0.f);
    }
    __syncthreads();
    if (tid == 0) {                       // the reverse cumsum, in order
      float rev = 0.f;
      for (int i = kQ - 1; i >= 0; --i) {
        rev += dcum[i];
        misc[i] = rev;
        da_run = fmaf(dtv[i], rev, da_run);
      }
    }
    __syncthreads();
    if (tid < steps)
      p.ddt[xrow + base + tid] = colp[tid] + tail[tid] * qv[tid] + a * misc[tid];
    // g <- exp(cum_Q) g + sum_i exp(cum_i) C_i dy_i^T
    const float decay = __expf(total);
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) acc[m][n] = decay * G[(ti + 16 * m) * kLd + tj + 16 * n];
    product(acc, [&](int s, int i) { return Ct[i * kLd + s] * ecum[i]; },
            [&](int q, int i) { return DY[i * kLd + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) G[(ti + 16 * m) * kLd + tj + 16 * n] = acc[m][n];
  }
  const float dd = block_sum(dd_part, red);
  if (tid == 0) {
    p.dd[row] = dd;
    p.da[row] = da_run;
  }
}

}  // namespace bwd

// The backward of mamba2_scan.  Inputs as mamba2_scan's, plus dy [BH, S,
// dh] bf16 and dh_final [BH, ds, dh] f32 (null: zero).  Writes dx [BH, S,
// dh] bf16, ddt [BH, S], da and dd [BH], and per-row dB and dC partials
// [BH, S, ds], all f32; states is f32 scratch of BH x (ceil(S / 64) + 1) x
// ds x dh.  Launches on `stream`; returns cudaGetLastError() after the
// launch.
extern "C" int mamba2_scan_bwd(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* d,
                               const void* dy, const void* dh_final, void* dx,
                               void* ddt, void* da, void* dd, void* db, void* dc,
                               void* states, int rows, int seq, int dh, int ds,
                               int heads_per_group, void* stream) {
  if (dh < 8 || dh > kMaxD || dh % 8 || ds < 8 || ds > kMaxD || ds % 8 ||
      heads_per_group < 1 || seq < 1 || rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd::mamba2_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  bwd::BwdParams p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.b = static_cast<const __nv_bfloat16*>(b);
  p.c = static_cast<const __nv_bfloat16*>(c);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.d = static_cast<const float*>(d);
  p.dh_final = static_cast<const float*>(dh_final);
  p.dx = static_cast<__nv_bfloat16*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.da = static_cast<float*>(da);
  p.dd = static_cast<float*>(dd);
  p.db = static_cast<float*>(db);
  p.dc = static_cast<float*>(dc);
  p.states = static_cast<float*>(states);
  p.seq = seq; p.dh = dh; p.ds = ds; p.heads_per_group = heads_per_group;
  p.chunks = (seq + bwd::kQ - 1) / bwd::kQ;
  bwd::mamba2_bwd_kernel<<<rows, bwd::kThreads, bwd::kSmem,
                           static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
