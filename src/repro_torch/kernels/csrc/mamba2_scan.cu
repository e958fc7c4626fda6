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

// ---------------------------------------------------------------------------
// The backward: mamba2_scan_bwd, on the tensor cores.
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
// Every exponent is <= 0.  dD = sum dy . x.  B and C are read by group.
//
// What bounds it on an H100: bytes, at Zamba2's [448, 512, 64] about 91 MB
// of inputs and gradients read and written once (0.027 ms at 3.35 TB/s)
// against about 19 GFLOP of chunk products (ten 64^3 products a chunk, the
// state's recompute included; 0.019 ms at the bf16 rate); each row's
// chunk chain is serial, so what sets the time is the instructions and
// latencies of each chunk step.  The design is the forward's:
//
//   * Tensor cores.  One warpgroup owns one head; every product is wgmma
//     m64n64k16, fp32 accumulate.  x, dy, B and C enter exactly (bf16).
//     The operands made in fp32 enter as a split pair hi + lo of bf16
//     (split2: two products each, about 2^-16 of their value): the
//     decayed CBL^T dt and dML^T (for dx and dB) and dML dt (for dC), kept
//     in registers as the A operand, re-packed from the accumulators of
//     B C^T, x dy^T and dy x^T, as the forward does with M; (C exp(cum))^T,
//     read transposed with ldmatrix and scaled in registers; the state
//     gradient g, kept as tiles in shared memory where it is a B operand
//     (B g).  Two operands take three parts (split3, three products,
//     about 2^-24): (B w)^T in the states' recompute, and g in x g^T and
//     in its carry from chunk to chunk.  Both reach dcum (through the
//     states in <g, h_end>, and through q_j = B_j . (x g^T)_j), whose
//     terms cancel, so as pairs each put about 2^-16 of its value into
//     da: 2e-5 of max |da| in the plain model of these operands
//     (ref.mamba2_bwd_chunks), against 1e-6 to 5e-6 with three parts.
//   * Scratch.  A forward walk recomputes each chunk's starting state h0
//     (the forward's state update) and writes it to an fp32 scratch with
//     z = dy h0^T, the one product that needs h0; the reverse walk loads z
//     into registers at a chunk's start, ahead of dC, and each state ahead
//     of <g, h_end>, so h0 never takes shared memory there.  Both are kept
//     in the accumulators' own register order (coalesced 16-byte stores
//     and loads): (2 chunks + 1) x 16 KB a row, 125 MB at Zamba2's shape,
//     read within the call.
//   * Registers over occupancy.  A block of two warpgroups owns two heads
//     of one B/C group, sharing each chunk's B and C loads, and may use
//     255 registers a thread, so one block runs on an SM: Zamba2's 448
//     rows take 224 blocks, 1.7 waves of 132.  Two blocks an SM (four
//     heads, one wave) would cap a thread at 128 registers: that version
//     spilled 0.8-1.7 KB a thread, and each reverse chunk step took 3.4 x
//     as long (71k cycles against 21k, H100).
//   * Loads behind the products.  Each chunk step's B (C), x and dy tiles
//     arrive by cp.async into one of two buffers (128-byte swizzle) while
//     the step before computes, the next chunk's dt in registers.  Shared
//     memory: two buffers of 48 KB, g's three tiles (48 KB), a 16 KB
//     exchange and the chunk's vectors, about 166 KB.  Where a group's
//     heads are odd in number a block of one warpgroup owns one head.
//   * Sums in a fixed order, no float atomics: the block adds its two
//     heads' dB and dC through the exchange and writes one fp32 partial
//     [rows / 2, S, ds] a pair, which the wrapper
//     sums over each group's pairs in order; dt, a and D's gradients are
//     fp32 sums in fixed trees.  Two calls give the same bits.
namespace bwd {

using namespace sm90;

struct BwdParams {
  const __nv_bfloat16 *x, *b, *c, *dy;
  const float *dt, *a, *d, *dh_final;   // dh_final: null = zero
  __nv_bfloat16* dx;
  float *ddt, *da, *dd;
  float *db, *dc;       // per block (a pair of heads, or one) [rows / HPB, S, ds]
  float* scratch;       // per row (2 chunks + 1) x 4096: states, then z
  int seq, dh, ds, heads_per_group, chunks;
};

constexpr int kFrag = 4096;   // floats of one 64 x 64 fp32 tile in the scratch
// per head, fp32: cum2, dt, colp, q, czv [64] each, rowp [4][64], misc [16]
constexpr int kVec = 5 * kQ + 4 * kQ + 16;

template <int HPB>
struct BwdSmem {
  // two buffers of (B, C, then x and dy a head); g hi, lo and a third a head
  static constexpr int kBufTiles = 2 + 2 * HPB;
  static constexpr int kTiles = 2 * kBufTiles + 3 * HPB;
  static constexpr int kXBytes = HPB == 2 ? 128 * 32 * 4 : 0;   // the pair's exchange
  static constexpr int kBytes = kTiles * kTile * 2 + kXBytes + HPB * kVec * 4 + 1024;
};

// A operands (T w)^T of a 64 x 64 bf16 tile T (rows k), rows s = 16 w ..
// read transposed with ldmatrix and scaled by weight(k), as a split pair,
// or with `third` as three parts hi + lo + third (split3)
template <typename F>
__device__ __forceinline__ void scaled_transpose(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                                 const __nv_bfloat16* t, int w, int lane,
                                                 int tig, F weight,
                                                 uint32_t (*third)[4] = nullptr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ab[4];
    ldmatrix_x4_trans(ab, smem_addr(t + swz(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                            16 * w + ((lane >> 3) & 1) * 8)));
    const int j0 = 16 * kk + 2 * tig;
    const float w0 = weight(j0), w1 = weight(j0 + 1), w8 = weight(j0 + 8),
                w9 = weight(j0 + 9);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 v = unpack2(ab[e]);
      const float v0 = v.x * ((e < 2) ? w0 : w8), v1 = v.y * ((e < 2) ? w1 : w9);
      if (third) split3(v0, v1, hi[kk][e], lo[kk][e], third[kk][e]);
      else split2(v0, v1, hi[kk][e], lo[kk][e]);
    }
  }
}

template <int HPB>
__global__ void __launch_bounds__(128 * HPB, 1) mamba2_bwd_kernel(const BwdParams p) {
  using SM = BwdSmem<HPB>;
  constexpr int kThreads = 128 * HPB;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  float4* xbuf = reinterpret_cast<float4*>(tiles + SM::kTiles * kTile);

  const int tid = threadIdx.x;
  const int hh = tid / 128;     // head of this warpgroup within the block
  const int tw = tid % 128;
  const int w = tw / 32;        // rows 16 w .. 16 w + 15 of every accumulator
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int row_base = blockIdx.x * HPB;
  const int row = row_base + hh;
  const int grp = row_base / p.heads_per_group;
  const int S = p.seq;
  const int nc = p.chunks;

  // buffer `buf`'s B, C, and this head's x and dy tiles
  const __nv_bfloat16 *Bs, *Cs, *Xs, *DYs;
  uint32_t bs, cs, xs, dys;
  auto use_buffer = [&](int buf) {
    Bs = tiles + buf * SM::kBufTiles * kTile;
    Cs = Bs + kTile;
    Xs = Bs + (2 + 2 * hh) * kTile;
    DYs = Xs + kTile;
    bs = smem_addr(Bs); cs = smem_addr(Cs); xs = smem_addr(Xs); dys = smem_addr(DYs);
  };
  __nv_bfloat16* Ghi = tiles + (2 * SM::kBufTiles + 3 * hh) * kTile;
  __nv_bfloat16* Glo = Ghi + kTile;
  __nv_bfloat16* Gl3 = Glo + kTile;   // g's third part (split3); unused forward
  const uint32_t ghi = smem_addr(Ghi), glo = smem_addr(Glo), gl3 = smem_addr(Gl3);
  auto put_g = [&](int at, float v0, float v1) {   // g's three parts at `at`
    split3(v0, v1, *reinterpret_cast<uint32_t*>(Ghi + at), *reinterpret_cast<uint32_t*>(Glo + at),
           *reinterpret_cast<uint32_t*>(Gl3 + at));
  };
  float* vec = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(xbuf) + SM::kXBytes) +
               hh * kVec;
  float *cum2 = vec, *dts = vec + kQ, *colp = vec + 2 * kQ, *qv = vec + 3 * kQ,
        *czv = vec + 4 * kQ, *rowp = vec + 5 * kQ, *misc = vec + 9 * kQ;

  // step k of the two walks' 2 nc chunk steps (the forward walk's chunk k,
  // then the reverse walk's 2 nc - 1 - k): its B (C in reverse), x and dy
  // tiles into buffer k & 1, 16 bytes a copy, zero past S and past ds / dh
  auto issue = [&](int k) {
    if (k >= 2 * nc) return;
    const bool with_c = k >= nc;
    const int t0 = (with_c ? 2 * nc - 1 - k : k) * kQ;
    __nv_bfloat16* buf = tiles + (k & 1) * SM::kBufTiles * kTile;
    for (int e = tid; e < (2 + 2 * HPB) * kQ * 8; e += kThreads) {
      const int slot = e / (kQ * 8);
      if (slot == 1 && !with_c) continue;
      const int r = (e / 8) % kQ;
      const int col = (e % 8) * 8;
      const __nv_bfloat16* src;
      int width;
      if (slot < 2) {
        src = (slot ? p.c : p.b) + ((long long)grp * S + t0 + r) * p.ds + col;
        width = p.ds;
      } else {
        const int h = (slot - 2) / 2;
        src = ((slot & 1) ? p.dy : p.x) + ((long long)(row_base + h) * S + t0 + r) * p.dh + col;
        width = p.dh;
      }
      const bool in = (t0 + r < S) && (col < width);
      cp_async16(smem_addr(buf + slot * kTile + swz(r, col)), in ? src : p.x, in ? 16 : 0);
    }
    cp_async_commit();
  };
  const float* dt_row = p.dt + (long long)row * S;
  const float a = p.a[row];
  const float a2 = a * kLog2e;
  // warp 0 of a head: a chunk's two dt of this lane, loaded a chunk ahead
  float dtn[2] = {0.f, 0.f};
  auto load_dt = [&](int chunk) {
    if (w != 0 || chunk < 0 || chunk >= nc) return;
    const int t = chunk * kQ + 2 * lane;
    dtn[0] = t < S ? dt_row[t] : 0.f;
    dtn[1] = t + 1 < S ? dt_row[t + 1] : 0.f;
  };
  // warp 0 of a head: the chunk's dt and log2-domain inclusive cumsum of dt a
  auto chunk_scalars = [&]() {
    if (w != 0) return;
    const float l0 = dtn[0] * a2, l1 = dtn[1] * a2;
    float incl = l0 + l1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    cum2[2 * lane] = incl - l1;
    cum2[2 * lane + 1] = incl;
    dts[2 * lane] = dtn[0];
    dts[2 * lane + 1] = dtn[1];
  };
  float* scratch = p.scratch + (long long)row * (2 * nc + 1) * kFrag;
  const int r0 = 16 * w + gid;   // this thread's accumulator rows r0, r0 + 8

  // ---- the forward walk: each chunk's starting state and its z = dy h0^T
  //      into the scratch; h in registers (rows s, columns q) and as hi + lo
  //      tiles in the g tiles ----
  float h[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) h[i] = 0.f;
  for (int e = tw; e < kTile; e += 128) Ghi[e] = Glo[e] = __float2bfloat16(0.f);
  load_dt(0);
  issue(0);
  for (int ci = 0; ci < nc; ++ci) {
    chunk_scalars();
    cp_async_wait<0>();
    fence_proxy_async();   // the copies and the state writes, to wgmma's reads
    __syncthreads();
    issue(ci + 1);         // the next step's tiles load while this one computes
    use_buffer(ci & 1);
    load_dt(ci + 1 < nc ? ci + 1 : nc - 1);
    frag_store(scratch + ci * kFrag, h, tw);
    float acc[32];
    zero(acc);
    wgmma_fence();
    ss_product<false>(acc, dys, ghi, false);   // z = dy h0^T
    ss_product<false>(acc, dys, glo, true);
    wait_products(acc);
    frag_store(scratch + (nc + 1 + ci) * kFrag, acc, tw);
    const float cq = cum2[kQ - 1];
    // (B w)^T, w_j = exp(cum_Q - cum_j) dt_j, in three parts: the states
    // feed <g, h_end> and z, and so dcum, whose terms cancel
    uint32_t shi[4][4], slo[4][4], s3[4][4];
    scaled_transpose(shi, slo, Bs, w, lane, tig,
                     [&](int j) { return fast_exp2(cq - cum2[j]) * dts[j]; }, s3);
    zero(acc);
    wgmma_fence();
    rs_product(acc, shi, slo, xs, s3);         // (B w)^T x
    wait_products(acc);
    fence_fragments(shi);
    fence_fragments(slo);
    fence_fragments(s3);
    const float decay = fast_exp2(cq);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * n + 2 * half;
        h[i] = fmaf(decay, h[i], acc[i]);
        h[i + 1] = fmaf(decay, h[i + 1], acc[i + 1]);
        const int at = swz(r0 + 8 * half, 8 * n + 2 * tig);
        split2(h[i], h[i + 1], *reinterpret_cast<uint32_t*>(Ghi + at),
               *reinterpret_cast<uint32_t*>(Glo + at));
      }
    __syncthreads();   // every warp is done with this chunk's tiles
  }
  frag_store(scratch + nc * kFrag, h, tw);

  // ---- the reverse walk; the g tiles hold the state's gradient ----
  {
    float gi[32];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int s = r0 + 8 * half, q = 8 * n + 2 * tig;
        float2 v = make_float2(0.f, 0.f);
        if (p.dh_final && s < p.ds && q < p.dh)
          v = *reinterpret_cast<const float2*>(p.dh_final +
                                               ((long long)row * p.ds + s) * p.dh + q);
        gi[4 * n + 2 * half] = v.x;
        gi[4 * n + 2 * half + 1] = v.y;
        put_g(swz(s, q), v.x, v.y);
      }
    // <g, h_end> of the last chunk, as four warp partials
    float part = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) part = fmaf(gi[i], h[i], part);
    part = warp_sum(part);
    if (lane == 0) misc[1 + 4 * ((nc - 1) & 1) + w] = part;
  }
  float dd_part = 0.f, da_run = 0.f;
  const float dskip = p.d[row];
  // this head's part of a dB or dC tile (rows r0, r0 + 8 of the chunk,
  // columns s) summed with the other head's through xbuf and written as
  // the block's partial by head `reader` (dB head 0 on named barrier 3, dC
  // head 1 on barrier 4, so each head writes half the sums).  A head's
  // write follows its own read of the exchange before, and the two
  // exchanges of a chunk take two barriers, so a head that runs ahead
  // cannot complete a barrier with its own two arrivals; the chunk's last
  // __syncthreads keeps chunks apart.  a + b == b + a in fp32: the bits do
  // not depend on which head adds.
  auto put_sum = [&](float* out, float (&v)[32], int t0, int reader) {
    if constexpr (HPB == 2) {
      if (hh != reader) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          xbuf[j * 128 + tw] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
        named_barrier_arrive(3 + reader, 256);
        return;
      }
      named_barrier(3 + reader, 256);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 x = xbuf[j * 128 + tw];
        v[4 * j] += x.x; v[4 * j + 1] += x.y; v[4 * j + 2] += x.z; v[4 * j + 3] += x.w;
      }
    }
    float* base = out + (long long)blockIdx.x * S * p.ds;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = t0 + r0 + 8 * half;
      if (t >= S) continue;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int s = 8 * n + 2 * tig;
        if (s < p.ds)
          *reinterpret_cast<float2*>(base + (long long)t * p.ds + s) =
              make_float2(v[4 * n + 2 * half], v[4 * n + 2 * half + 1]);
      }
    }
  };

  for (int ci = nc - 1; ci >= 0; --ci) {
    const int t0 = ci * kQ;
    const int step = 2 * nc - 1 - ci;
    chunk_scalars();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    issue(step + 1);
    use_buffer(step & 1);
    load_dt(ci - 1);
    float zr[32];   // this chunk's dy h0^T, loaded ahead of dC
    frag_load(zr, scratch + (nc + 1 + ci) * kFrag, tw);
    const float cq = cum2[kQ - 1];
    float cr[2], dtr[2], tail[2], ecum[2];   // this thread's two rows
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      cr[r] = cum2[r0 + 8 * r];
      dtr[r] = dts[r0 + 8 * r];
      tail[r] = fast_exp2(cq - cr[r]);
      ecum[r] = fast_exp2(cr[r]);
    }

    // ---- B C^T and x dy^T (rows j, columns i): CBL^T dt and dML^T as
    //      split A operands; P's row and column sums ----
    uint32_t chi[4][4], clo[4][4], mhi[4][4], mlo[4][4];
    {
      float cb[32], dm[32];
      zero(cb);
      zero(dm);
      wgmma_fence();
      ss_product<false>(cb, bs, cs, false);
      ss_product<false>(dm, xs, dys, false);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(cb);
      fence_operands(dm);
      float colp_part[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 ci2 = *reinterpret_cast<const float2*>(cum2 + 8 * n + 2 * tig);
        float cv[4], mv[4], rp[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const int i = 8 * n + 2 * tig + (e & 1);
          const float l =
              i >= r0 + 8 * r ? fast_exp2(((e & 1) ? ci2.y : ci2.x) - cr[r]) : 0.f;
          const float pv = dm[4 * n + e] * l * cb[4 * n + e];
          colp_part[r] += pv;
          rp[e & 1] = fmaf(pv, dtr[r], rp[e & 1]);
          cv[e] = cb[4 * n + e] * l * dtr[r];
          mv[e] = dm[4 * n + e] * l;
        }
        // n-tiles (2 kk, 2 kk + 1) are the A operand of k-step kk
        const int kk = n / 2, at = 2 * (n % 2);
        split2(cv[0], cv[1], chi[kk][at], clo[kk][at]);
        split2(cv[2], cv[3], chi[kk][at + 1], clo[kk][at + 1]);
        split2(mv[0], mv[1], mhi[kk][at], mlo[kk][at]);
        split2(mv[2], mv[3], mhi[kk][at + 1], mlo[kk][at + 1]);
#pragma unroll
        for (int k = 0; k < 2; ++k) {   // this warp's column sums, over gid
          float v = rp[k];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (gid == 0) rowp[w * kQ + 8 * n + 2 * tig + k] = v;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = colp_part[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) colp[r0 + 8 * r] = v;
      }
    }

    // ---- dx = w_j (B g)_j + sum_i CBL_ij dt_j dy_i + D dy_j ----
    {
      float acc[32];
      zero(acc);
      wgmma_fence();
      ss_product<true>(acc, bs, ghi, false);
      ss_product<true>(acc, bs, glo, true);
      wait_products(acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= tail[(i >> 1) & 1] * dtr[(i >> 1) & 1];
      wgmma_fence();
      rs_product(acc, chi, clo, dys);
      wait_products(acc);
      fence_fragments(chi);
      fence_fragments(clo);
      __nv_bfloat16* dxb = p.dx + (long long)row * S * p.dh;
#pragma unroll
      for (int yh = 0; yh < 2; ++yh) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r0 + 8 * half;
          uint32_t v[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int n = 4 * yh + t;
            const int col = 8 * n + 2 * tig;
            const float2 dyv = unpack2(*reinterpret_cast<const uint32_t*>(DYs + swz(i, col)));
            const float2 xv = unpack2(*reinterpret_cast<const uint32_t*>(Xs + swz(i, col)));
            dd_part = fmaf(dyv.x, xv.x, fmaf(dyv.y, xv.y, dd_part));
            v[t] = pack_bf16x2(fmaf(dskip, dyv.x, acc[4 * n + 2 * half]),
                               fmaf(dskip, dyv.y, acc[4 * n + 2 * half + 1]));
          }
          transpose_quad(v, tig);
          const int col = 32 * yh + 8 * tig;
          if (t0 + i < S && col < p.dh)
            *reinterpret_cast<uint4*>(dxb + (long long)(t0 + i) * p.dh + col) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
      }
    }

    // ---- dB = dt_j (tail_j (x g^T)_j + sum_i dML_ij C_i); q_j = B_j . (x g^T)_j ----
    {
      float acc[32];
      zero(acc);
      wgmma_fence();
      ss_product<false>(acc, xs, ghi, false);
      ss_product<false>(acc, xs, glo, true);
      ss_product<false>(acc, xs, gl3, true);
      wait_products(acc);
      float qp[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 bv = unpack2(
              *reinterpret_cast<const uint32_t*>(Bs + swz(r0 + 8 * half, 8 * n + 2 * tig)));
          qp[half] = fmaf(bv.x, acc[4 * n + 2 * half],
                          fmaf(bv.y, acc[4 * n + 2 * half + 1], qp[half]));
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = qp[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) qv[r0 + 8 * r] = v;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= tail[(i >> 1) & 1];
      wgmma_fence();
      rs_product(acc, mhi, mlo, cs);
      wait_products(acc);
      fence_fragments(mhi);
      fence_fragments(mlo);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= dtr[(i >> 1) & 1];
      put_sum(p.db, acc, t0, 0);
    }

    // ---- dC = exp(cum_i) z_i + sum_j dML_ij dt_j B_j; czv_i = C_i . z_i ----
    float he[32];   // the state at this chunk's start: h_end of the chunk before
    if (ci > 0) frag_load(he, scratch + ci * kFrag, tw);
    {
      uint32_t dhi[4][4], dlo[4][4];
      {
        float dm[32];
        zero(dm);
        wgmma_fence();
        ss_product<false>(dm, dys, xs, false);   // dy x^T, rows i, columns j
        wait_products(dm);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 cj = *reinterpret_cast<const float2*>(cum2 + 8 * n + 2 * tig);
          const float2 dj = *reinterpret_cast<const float2*>(dts + 8 * n + 2 * tig);
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int j = 8 * n + 2 * tig + (e & 1);
            v[e] = j <= r0 + 8 * r ? dm[4 * n + e] *
                                         fast_exp2(cr[r] - ((e & 1) ? cj.y : cj.x)) *
                                         ((e & 1) ? dj.y : dj.x)
                                   : 0.f;
          }
          const int kk = n / 2, at = 2 * (n % 2);
          split2(v[0], v[1], dhi[kk][at], dlo[kk][at]);
          split2(v[2], v[3], dhi[kk][at + 1], dlo[kk][at + 1]);
        }
      }
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = zr[i];
      float zp[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 cv = unpack2(
              *reinterpret_cast<const uint32_t*>(Cs + swz(r0 + 8 * half, 8 * n + 2 * tig)));
          zp[half] = fmaf(cv.x, acc[4 * n + 2 * half],
                          fmaf(cv.y, acc[4 * n + 2 * half + 1], zp[half]));
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v = zp[r];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) czv[r0 + 8 * r] = v;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= ecum[(i >> 1) & 1];
      wgmma_fence();
      rs_product(acc, dhi, dlo, bs);
      wait_products(acc);
      fence_fragments(dhi);
      fence_fragments(dlo);
      put_sum(p.dc, acc, t0, 1);
    }
    named_barrier(1 + hh, 128);   // this head's colp, q, czv and rowp are written

    // ---- dcum, its reverse cumsum R, ddt and da (warp 0 of the head) ----
    if (w == 0) {
      const float gh = misc[1 + 4 * (ci & 1)] + misc[2 + 4 * (ci & 1)] +
                       misc[3 + 4 * (ci & 1)] + misc[4 + 4 * (ci & 1)];
      float dc[2], tl[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * lane + k;
        const float rpi = rowp[i] + rowp[kQ + i] + rowp[2 * kQ + i] + rowp[3 * kQ + i];
        tl[k] = fast_exp2(cq - cum2[i]);
        dc[k] = rpi - dts[i] * colp[i] + fast_exp2(cum2[i]) * czv[i] - dts[i] * tl[k] * qv[i] +
                (i == kQ - 1 ? gh : 0.f);
      }
      const float pair = dc[0] + dc[1];
      float suf = pair;   // sum of the pairs of this lane and the lanes above
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_down_sync(0xffffffffu, suf, off);
        if (lane + off < 32) suf += v;
      }
      const float rev[2] = {suf, suf - dc[0]};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int i = 2 * lane + k;
        if (t0 + i < S) p.ddt[(long long)row * S + t0 + i] = colp[i] + tl[k] * qv[i] + a * rev[k];
        da_run = fmaf(dts[i], rev[k], da_run);
      }
    }

    // ---- g <- exp(cum_Q) g + (C exp(cum))^T dy; <g, h_end> of the chunk before ----
    {
      uint32_t shi[4][4], slo[4][4];
      scaled_transpose(shi, slo, Cs, w, lane, tig, [&](int i) { return fast_exp2(cum2[i]); });
      const float decay = fast_exp2(cq);
      float acc[32];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int at = swz(r0 + 8 * half, 8 * n + 2 * tig);
          const float2 oh = unpack2(*reinterpret_cast<const uint32_t*>(Ghi + at));
          const float2 ol = unpack2(*reinterpret_cast<const uint32_t*>(Glo + at));
          const float2 o3 = unpack2(*reinterpret_cast<const uint32_t*>(Gl3 + at));
          acc[4 * n + 2 * half] = decay * (oh.x + (ol.x + o3.x));
          acc[4 * n + 2 * half + 1] = decay * (oh.y + (ol.y + o3.y));
        }
      wgmma_fence();
      rs_product(acc, shi, slo, dys);
      wait_products(acc);
      fence_fragments(shi);
      fence_fragments(slo);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          put_g(swz(r0 + 8 * half, 8 * n + 2 * tig), acc[4 * n + 2 * half],
                acc[4 * n + 2 * half + 1]);
        }
      if (ci > 0) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < 32; ++i) part = fmaf(acc[i], he[i], part);
        part = warp_sum(part);
        if (lane == 0) misc[1 + 4 * ((ci - 1) & 1) + w] = part;
      }
    }
    __syncthreads();   // every warp is done with this chunk's tiles and vectors
  }
  dd_part = warp_sum(dd_part);
  const float da = warp_sum(da_run);   // da_run is 0 outside warp 0
  if (lane == 0) misc[9 + w] = dd_part;
  named_barrier(1 + hh, 128);
  if (tw == 0) {
    p.dd[row] = misc[9] + misc[10] + misc[11] + misc[12];
    p.da[row] = da;
  }
}

template <int HPB>
cudaError_t launch(const BwdParams& p, int rows, cudaStream_t stream) {
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(mamba2_bwd_kernel<HPB>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           BwdSmem<HPB>::kBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  mamba2_bwd_kernel<HPB><<<rows / HPB, 128 * HPB, BwdSmem<HPB>::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace bwd

// The backward of mamba2_scan.  Inputs as mamba2_scan's, plus dy [BH, S,
// dh] bf16 and dh_final [BH, ds, dh] f32 (null: zero).  Writes dx [BH, S,
// dh] bf16, ddt [BH, S], da and dd [BH], all f32, and dB and dC as f32
// partials [BH / P, S, ds], each the sum over P consecutive rows of one
// group (P = 2 where heads_per_group is even, else 1); scratch is f32 of
// BH x (2 ceil(S / 64) + 1) x 4096.  Launches on `stream`; returns
// cudaGetLastError() after the launch.
extern "C" int mamba2_scan_bwd(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* d,
                               const void* dy, const void* dh_final, void* dx,
                               void* ddt, void* da, void* dd, void* db, void* dc,
                               void* scratch, int rows, int seq, int dh, int ds,
                               int heads_per_group, void* stream) {
  if (dh < 8 || dh > kMaxD || dh % 8 || ds < 8 || ds > kMaxD || ds % 8 ||
      heads_per_group < 1 || seq < 1 || rows < 1 || rows % heads_per_group)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.scratch = static_cast<float*>(scratch);
  p.seq = seq; p.dh = dh; p.ds = ds; p.heads_per_group = heads_per_group;
  p.chunks = (seq + kQ - 1) / kQ;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (heads_per_group % 2 == 0) return static_cast<int>(bwd::launch<2>(p, rows, s));
  return static_cast<int>(bwd::launch<1>(p, rows, s));
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
