// RWKV-6 ("Finch") chunked WKV scan for Hopper (sm_90a), bf16 r/k/v in and
// y out, fp32 log-decays, arithmetic and state, returning the final state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rwkv6_scan.py
// (rwkv6_scan / _rwkv6_kernel).  Per head, with S a [dk, dv] state and
// per-channel decays w_t = exp(logw_t):
//
//   y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T),   S_t = diag(w_t) S_{t-1} + k_t v_t^T
//
// evaluated chunk by chunk (Q = 64 steps): with cum the inclusive cumsum of
// logw inside the chunk and cp = cum - logw (the exclusive one),
//
//   y_i = sum_{j<i} A_ij v_j + (sum_c r_ic u_c k_ic) v_i + (r_i * exp(cp_i))^T S_prev
//   A_ij = sum_c r_ic k_jc exp(cp_ic - cum_jc)
//   S   = diag(exp(cum_Q)) S_prev + sum_j (k_j * exp(cum_Q - cum_j)) v_j^T
//
// The TPU kernel factorises A as (r exp(cp)) (k exp(-cum))^T; its
// k exp(-cum) grows as e^{-cum}, which at RWKV6-7B's decays (chunk sums of
// logw near -70 per 32 steps, far lower at 64) overflows fp32.  This kernel
// never forms a positive exponent.  Sub-chunk reference points: the chunk
// is cut into 4 sub-chunks of L = 16 rows, one per warp.  For sub-chunk a
// with ref_a = cum at the step before its first row, and every column j
// before it,
//
//   A[i in a, j < 16a] = r^_i . k^_j,  r^_i = r_i exp(cp_i - ref_a),  k^_j = k_j exp(ref_a - cum_j)
//
// with both exponents <= 0: where one factor underflows, the true weight
// exp(cp_i - cum_j) is smaller still.  Inside each diagonal 16 x 16 block
// the same holds one level down: its rows 8..15 against its columns 0..7
// factorise around the cum of its 8th row.  Only the 8 triangles of 8
// steps left on the diagonal take one exp per (i, j, channel), 8 x 28 x 64
// a chunk of 64 steps, spread over the lanes, more to the warps that form
// fewer off-diagonal scores (the old kernel took 63,488 exps per 64 steps,
// on an uneven triangle).  All exps are 2^x on the special-function unit, the
// log-decays kept in log2 units.
//
// What bounds it on an H100: bytes.  At the RWKV6-7B prefill shape (256
// rows of 512 steps, dk = dv = 64) it reads r, k, v (bf16, 50 MB) and logw
// (fp32, 34 MB) and writes y and the final state, about 105 MB or 0.031 ms
// at 3.35 TB/s, against about 3 GFLOP.  The chunk-to-chunk chain of a head
// is serial, so what sets the time is what each chunk step issues.  The
// design:
//
//   * Tensor cores.  One warpgroup owns one head (one block of 128
//     threads).  Warp a forms its sub-chunk's off-diagonal scores r^ k^T
//     with mma.sync m16n8k16 (k^ differs per sub-chunk, so it cannot be one
//     wgmma B operand); the scores never leave registers and, with the
//     diagonal block and the bonus u on its diagonal, become the register A
//     operand of the wgmma m64n64k16 products A v, as P does in flash
//     attention.  r~ S_prev (r~ = r exp(cp)) and the state update
//     (k exp(cum_Q - cum))^T v are wgmma m64n64k16 too.  Operands made in
//     fp32 (r^, k^, A, r~, the decayed k and the state) enter as split
//     pairs hi + lo of bf16, two or three products each, which keeps them
//     to about 2^-16 of their value; r, k and v are bf16 and exact.
//   * Loads.  Each chunk's r, k, v tiles (64 x 64 bf16, 128-byte rows,
//     XOR-swizzled as wgmma's 128-byte layout expects) and logw tile (fp32,
//     rows padded to 68 floats so that 8 rows at one column hit 8 bank
//     groups) arrive with 16-byte cp.async into a double buffer while the
//     block computes on the previous chunk.
//   * Stores.  y leaves in 16-byte stores (a 4 x 4 transpose over the 4
//     lanes of each accumulator row); the state is kept in shared memory
//     as a hi + lo pair of bf16 tiles, the wgmma B operand, and written out
//     once in fp32 at the end (the prefill's decode state).
//   * Parallelism.  About 104 KB of shared memory puts two blocks on each
//     SM, so RWKV6's 256 rows run in one wave.  Four block barriers per
//     chunk: after the chunk lands, after its cumsum, after the diagonal
//     blocks, before the state is rewritten.
//
// Ragged tail: steps past S load as r = k = v = 0 and logw = 0, so they
// leave the state unchanged and their y rows are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kQ = 64;                     // chunk length
constexpr int kL = 16;                     // sub-chunk length: one warp's rows
constexpr int kMaxD = 64;                  // dk, dv: multiples of 8 up to 64
constexpr int kTile = kQ * 64;             // bf16 elements of one 64 x 64 tile
constexpr int kWP = 68;                    // fp32 pitch of the log-decay tile
constexpr int kDP = kL + 1;                // fp32 pitch of a diagonal block
constexpr int kTri = 8 * 7 / 2;            // strictly-lower pairs of an 8-step triangle
constexpr int kPairs = 4 * 2 * kTri;       // the triangles of the 4 diagonal blocks
constexpr int kMaxRounds = 2;              // rounds of 32 pairs a warp, at most
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

// [2 buffers] x (r, k, v) tiles and the state's hi and lo tiles (bf16), then
// fp32 [2 buffers][kQ][kWP] log-decays, [4 warps][kL][kDP] diagonal blocks
// and [kMaxD] bonus
constexpr int kBf16Tiles = 2 * 3 + 2;
constexpr int kLogwFloats = kQ * kWP;
constexpr int kSmemBytes =
    kBf16Tiles * kTile * 2 + (2 * kLogwFloats + 4 * kL * kDP + kMaxD) * 4 + 1024;

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

// 8 bf16 of a 16-byte word as floats
__device__ __forceinline__ void unpack8(const uint4& w, float (&f)[8]) {
  const uint32_t words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 t = unpack2(words[q]);
    f[2 * q] = t.x;
    f[2 * q + 1] = t.y;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
rwkv6_scan_kernel(const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // wgmma reads the tiles through 128-byte-swizzle descriptors: 1024-aligned
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u));
  float* wbuf = reinterpret_cast<float*>(tiles + kBf16Tiles * kTile);
  float* diag_all = wbuf + 2 * kLogwFloats;
  float* us = diag_all + 4 * kL * kDP;

  const int tid = threadIdx.x;
  const int w = tid / 32;         // sub-chunk rows 16w..16w+15, state rows too
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int row = blockIdx.x;
  const int S = p.seq;
  const int n_chunks = (S + kQ - 1) / kQ;
  const long long base_k = (long long)row * S * p.dk;
  const long long base_v = (long long)row * S * p.dv;

  auto tile = [&](int buf, int t) { return tiles + (buf * 3 + t) * kTile; };
  __nv_bfloat16* Shi = tiles + 6 * kTile;
  __nv_bfloat16* Slo = tiles + 7 * kTile;
  float* diag = diag_all + w * kL * kDP;

  // one chunk's r, k, v and logw into buffer `buf`, 16 bytes a copy,
  // zero-filled past S and past dk / dv
  auto issue = [&](int chunk, int buf) {
    const int t0 = chunk * kQ;
    for (int e = tid; e < 3 * kQ * 8; e += kThreads) {
      const int t = e / (kQ * 8);
      const int r = (e / 8) % kQ;
      const int col = (e % 8) * 8;
      const int width = t == 2 ? p.dv : p.dk;
      const __nv_bfloat16* src =
          (t == 0 ? p.r + base_k : t == 1 ? p.k + base_k : p.v + base_v) +
          (long long)(t0 + r) * width + col;
      const bool in = (t0 + r < S) && (col < width);
      cp_async16(smem_addr(tile(buf, t) + swz(r, col)), in ? src : p.r, in ? 16 : 0);
    }
    float* wdst = wbuf + buf * kLogwFloats;
    for (int e = tid; e < kQ * 16; e += kThreads) {
      const int r = e / 16;
      const int col = (e % 16) * 4;
      const bool in = (t0 + r < S) && (col < p.dk);
      const float* src = p.logw + base_k + (long long)(t0 + r) * p.dk + col;
      cp_async16(smem_addr(wdst + r * kWP + col), in ? src : p.logw, in ? 16 : 0);
    }
    cp_async_commit();
  };

  for (int c = tid; c < kMaxD; c += kThreads)
    us[c] = c < p.dk ? p.u[(long long)row * p.dk + c] : 0.f;
  issue(0, 0);
  for (int e = tid; e < kTile; e += kThreads)   // S hi and lo: 2 x kTile bf16
    reinterpret_cast<uint32_t*>(Shi)[e] = 0u;

  // this lane's pairs (i > j, rows of the chunk) of the 8 triangles of 8
  // steps on the diagonal, 224 pairs in 7 rounds of 32: two rounds each to
  // warps 0-2, one to warp 3, which forms the most off-diagonal scores (the
  // fastest split on the card, against 3-2-1-1, 3-2-2-0 and 3-3-1-0).
  // pdst is the pair's place among the diagonal blocks, -1 for the lanes
  // past the last pair (which repeat a valid pair and do not write).
  const int r_begin = 2 * w;
  const int n_rounds = w < 3 ? 2 : 1;
  int pli[kMaxRounds], plj[kMaxRounds], pdst[kMaxRounds];
#pragma unroll
  for (int q = 0; q < kMaxRounds; ++q) {
    const int g = 32 * (r_begin + q) + lane;
    const bool valid = q < n_rounds && g < kPairs;
    const int pr = valid ? g : 0;
    const int blk = pr / (2 * kTri), tri = pr % (2 * kTri) / kTri, pt = pr % kTri;
    int li = 1;
    while ((li + 1) * li / 2 <= pt) ++li;
    const int lj = pt - li * (li - 1) / 2;
    pli[q] = kL * blk + 8 * tri + li;
    plj[q] = kL * blk + 8 * tri + lj;
    pdst[q] = valid ? blk * kL * kDP + (8 * tri + li) * kDP + 8 * tri + lj : -1;
  }

  const int i0 = kL * w + gid;     // this thread's chunk rows (y) and state rows (S)
  const int i1 = i0 + 8;

  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const int t0 = chunk * kQ;
    const int buf = chunk & 1;
    float* cum = wbuf + buf * kLogwFloats;
    cp_async_wait<0>();
    fence_proxy_async();   // the copies and the state writes, to wgmma's reads
    __syncthreads();       // the chunk's tiles and the state are in place
    if (chunk + 1 < n_chunks) issue(chunk + 1, buf ^ 1);
    // log2-domain inclusive cumsum of logw over the 64 steps, in place, one
    // channel a thread
    if (tid < kMaxD) {
      float acc = 0.f;
#pragma unroll 16
      for (int t = 0; t < kQ; ++t) {
        acc = fmaf(cum[t * kWP + tid], kLog2e, acc);
        cum[t * kWP + tid] = acc;
      }
    }
    __syncthreads();

    const __nv_bfloat16* R = tile(buf, 0);
    const __nv_bfloat16* K = tile(buf, 1);
    const __nv_bfloat16* V = tile(buf, 2);

    // ---- the diagonal block: A[i][j], j < i inside this warp's sub-chunk.
    //      Inside each half (8 steps) one exp per (i, j, channel), the pairs
    //      of all four blocks spread over the warps and lanes; the quadrant of the second half's
    //      rows against the first half's columns factorises around
    //      ref' = cum at the block's 8th row (below, on mma.sync) ----
#pragma unroll
    for (int q = 0; q < kMaxRounds; ++q) {
      if (q >= n_rounds) break;
      const int i = pli[q], j = plj[q];
      const float* ci = cum + (i - 1) * kWP;   // cp_i = cum_{i-1}
      const float* cj = cum + j * kWP;
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        float rv[8], kv[8];
        unpack8(*reinterpret_cast<const uint4*>(R + swz(i, 8 * g)), rv);
        unpack8(*reinterpret_cast<const uint4*>(K + swz(j, 8 * g)), kv);
        const float4 a0 = *reinterpret_cast<const float4*>(ci + 8 * g);
        const float4 a1 = *reinterpret_cast<const float4*>(ci + 8 * g + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(cj + 8 * g);
        const float4 b1 = *reinterpret_cast<const float4*>(cj + 8 * g + 4);
        const float dexp[8] = {a0.x - b0.x, a0.y - b0.y, a0.z - b0.z, a0.w - b0.w,
                               a1.x - b1.x, a1.y - b1.y, a1.z - b1.z, a1.w - b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(rv[e] * kv[e], fast_exp2(dexp[e]), acc);
      }
      if (pdst[q] >= 0) diag_all[pdst[q]] = acc;
    }
    // the bonus on the diagonal: sum_c r_ic u_c k_ic, half the channels a lane
    {
      const int li = lane & 15, half = lane >> 4;
      const int i = kL * w + li;
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int c = 32 * half + 8 * g;
        float rv[8], kv[8];
        unpack8(*reinterpret_cast<const uint4*>(R + swz(i, c)), rv);
        unpack8(*reinterpret_cast<const uint4*>(K + swz(i, c)), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(rv[e] * us[c + e], kv[e], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);
      if (half == 0) diag[li * kDP + li] = acc;
    }

    // ---- the off-diagonal scores of this sub-chunk, r^ k^T over the
    //      columns before it (n-tiles 0 .. 2w-1), on mma.sync ----
    float off[6][4];
#pragma unroll
    for (int n = 0; n < 6; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) off[n][e] = 0.f;
    if (w > 0) {
      const float* ref = cum + (kL * w - 1) * kWP;
      uint32_t rh[4][4], rl[4][4];   // r^ as mma.sync A fragments, k = channel
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e & 1) ? i1 : i0;
          const int c = 16 * kk + 2 * tig + ((e & 2) ? 8 : 0);
          const float2 rv = unpack2(*reinterpret_cast<const uint32_t*>(R + swz(i, c)));
          const float2 cp = *reinterpret_cast<const float2*>(cum + (i - 1) * kWP + c);
          const float2 rf = *reinterpret_cast<const float2*>(ref + c);
          split2(rv.x * fast_exp2(cp.x - rf.x), rv.y * fast_exp2(cp.y - rf.y),
                 rh[kk][e], rl[kk][e]);
        }
      }
#pragma unroll
      for (int n = 0; n < 6; ++n) {
        if (n < 2 * w) {
          const int j = 8 * n + gid;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t bh[2], bl[2];
#pragma unroll
            for (int hc = 0; hc < 2; ++hc) {
              const int c = 16 * kk + 2 * tig + 8 * hc;
              const float2 kv = unpack2(*reinterpret_cast<const uint32_t*>(K + swz(j, c)));
              const float2 cj = *reinterpret_cast<const float2*>(cum + j * kWP + c);
              const float2 rf = *reinterpret_cast<const float2*>(ref + c);
              split2(kv.x * fast_exp2(rf.x - cj.x), kv.y * fast_exp2(rf.y - cj.y),
                     bh[hc], bl[hc]);
            }
            mma_m16n8k16(off[n], rh[kk], bh[0], bh[1]);
            mma_m16n8k16(off[n], rh[kk], bl[0], bl[1]);
            mma_m16n8k16(off[n], rl[kk], bh[0], bh[1]);
          }
        }
      }
    }
    // the quadrant: rows 8..15 (the A operand's upper rows, its lower rows
    // zero) against columns 0..7 of this warp's block; its rows land in
    // quad[2], quad[3], where n-tile 2w of A keeps them
    float quad[4] = {0.f, 0.f, 0.f, 0.f};
    {
      const float* refm = cum + (kL * w + 7) * kWP;
      uint32_t qh[4][4], ql[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qh[kk][e] = ql[kk][e] = 0u;
          if (e & 1) {
            const int c = 16 * kk + 2 * tig + ((e & 2) ? 8 : 0);
            const float2 rv = unpack2(*reinterpret_cast<const uint32_t*>(R + swz(i1, c)));
            const float2 cp = *reinterpret_cast<const float2*>(cum + (i1 - 1) * kWP + c);
            const float2 rf = *reinterpret_cast<const float2*>(refm + c);
            split2(rv.x * fast_exp2(cp.x - rf.x), rv.y * fast_exp2(cp.y - rf.y),
                   qh[kk][e], ql[kk][e]);
          }
        }
      }
      const int j = kL * w + gid;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bh[2], bl[2];
#pragma unroll
        for (int hc = 0; hc < 2; ++hc) {
          const int c = 16 * kk + 2 * tig + 8 * hc;
          const float2 kv = unpack2(*reinterpret_cast<const uint32_t*>(K + swz(j, c)));
          const float2 cj = *reinterpret_cast<const float2*>(cum + j * kWP + c);
          const float2 rf = *reinterpret_cast<const float2*>(refm + c);
          split2(kv.x * fast_exp2(rf.x - cj.x), kv.y * fast_exp2(rf.y - cj.y), bh[hc], bl[hc]);
        }
        mma_m16n8k16(quad, qh[kk], bh[0], bh[1]);
        mma_m16n8k16(quad, qh[kk], bl[0], bl[1]);
        mma_m16n8k16(quad, ql[kk], bh[0], bh[1]);
      }
    }
    __syncthreads();   // the diagonal blocks are in shared memory

    // Three wgmma phases: A v, then r~ S_prev (its operands made while A v
    // runs), then dS, each waited on before the next, so that few register
    // fragments are live at a time (all of them live at once spilled, and
    // ptxas then serialised the wgmma).
    const uint32_t vs = smem_addr(V), shs = smem_addr(Shi), sls = smem_addr(Slo);

    // ---- A (rows 16w.., all 64 columns) as hi + lo register A operands of
    //      A v: k-step jj covers columns 16jj..16jj+15 ----
    uint32_t ahi[4][4], alo[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = 2 * jj + h;
        float m[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int li = (e < 2) ? gid : gid + 8;
          const int lj = 8 * h + 2 * tig + (e & 1);
          m[e] = jj < w ? off[n < 6 ? n : 0][e]
                 : jj != w || lj > li ? 0.f
                 : h == 0 && e >= 2 ? quad[e] : diag[li * kDP + lj];
        }
        split2(m[0], m[1], ahi[jj][2 * h], alo[jj][2 * h]);
        split2(m[2], m[3], ahi[jj][2 * h + 1], alo[jj][2 * h + 1]);
      }
    }
    float y[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) y[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_sw128(vs + kk * 2048, 8192);
      wgmma_rs_n64(y, ahi[kk], db);
      wgmma_rs_n64(y, alo[kk], db);
    }
    wgmma_commit();

    // ---- y += r~ S_prev, r~ = r exp(cp) as hi + lo register A operands,
    //      k = channel ----
    if (chunk > 0) {
      uint32_t thi[4][4], tlo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = (e & 1) ? i1 : i0;
          const int c = 16 * kk + 2 * tig + ((e & 2) ? 8 : 0);
          const float2 rv = unpack2(*reinterpret_cast<const uint32_t*>(R + swz(i, c)));
          const float2 cp = i > 0 ? *reinterpret_cast<const float2*>(cum + (i - 1) * kWP + c)
                                  : make_float2(0.f, 0.f);
          split2(rv.x * fast_exp2(cp.x), rv.y * fast_exp2(cp.y), thi[kk][e], tlo[kk][e]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dh = desc_sw128(shs + kk * 2048, 8192);
        const uint64_t dl = desc_sw128(sls + kk * 2048, 8192);
        wgmma_rs_n64(y, thi[kk], dh);
        wgmma_rs_n64(y, thi[kk], dl);
        wgmma_rs_n64(y, tlo[kk], dh);
      }
      wgmma_commit();
      wgmma_wait_all();
    } else {
      wgmma_wait_all();
    }
    fence_operands(y);

    // ---- y packed to bf16; a 4 x 4 transpose over the 4 lanes of a row
    //      gives each lane 8 consecutive columns, one 16-byte store ----
    __nv_bfloat16* yb = p.y + base_v;
#pragma unroll
    for (int yh = 0; yh < 2; ++yh) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = half ? i1 : i0;
        uint32_t v[4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int n = 4 * yh + t;
          v[t] = pack_bf16x2(y[4 * n + 2 * half], y[4 * n + 2 * half + 1]);
        }
        transpose_quad(v, tig);
        const int col = 32 * yh + 8 * tig;
        if (t0 + i < S && col < p.dv)
          *reinterpret_cast<uint4*>(yb + (long long)(t0 + i) * p.dv + col) =
              make_uint4(v[0], v[1], v[2], v[3]);
      }
    }

    // ---- dS = (k exp(cum_Q - cum))^T v: state rows c = i0, i1 as hi + lo
    //      register A operands, k = step (ldmatrix.trans of the k tile) ----
    const float q0 = cum[(kQ - 1) * kWP + i0];
    const float q1 = cum[(kQ - 1) * kWP + i1];
    float ds[32];
    {
      uint32_t khi[4][4], klo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t kt[4];
        ldmatrix_x4_trans(kt, smem_addr(K + swz(16 * kk + (lane & 7) + (lane >> 4) * 8,
                                                kL * w + ((lane >> 3) & 1) * 8)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = (e & 1) ? i1 : i0;
          const float qc = (e & 1) ? q1 : q0;
          const int j = 16 * kk + 2 * tig + ((e & 2) ? 8 : 0);
          const float2 kv = unpack2(kt[e]);
          split2(kv.x * fast_exp2(qc - cum[j * kWP + c]),
                 kv.y * fast_exp2(qc - cum[(j + 1) * kWP + c]), khi[kk][e], klo[kk][e]);
        }
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) ds[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_sw128(vs + kk * 2048, 8192);
        wgmma_rs_n64(ds, khi[kk], db);
        wgmma_rs_n64(ds, klo[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(ds);
    }
    __syncthreads();   // every warp has read S_prev

    // ---- S = diag(exp(cum_Q)) S_prev + dS, state rows i0, i1 ----
    const float d0 = fast_exp2(q0), d1 = fast_exp2(q1);
    const bool last = chunk + 1 == n_chunks;
    float* sb = p.s_out + (long long)row * p.dk * p.dv;
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const int col = 8 * t + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = half ? i1 : i0;
        const float dec = half ? d1 : d0;
        uint32_t* phi = reinterpret_cast<uint32_t*>(Shi + swz(c, col));
        uint32_t* plo = reinterpret_cast<uint32_t*>(Slo + swz(c, col));
        const float2 oh = unpack2(*phi), ol = unpack2(*plo);
        const float v0 = dec * (oh.x + ol.x) + ds[4 * t + 2 * half];
        const float v1 = dec * (oh.y + ol.y) + ds[4 * t + 2 * half + 1];
        split2(v0, v1, *phi, *plo);
        if (last && c < p.dk && col < p.dv)
          *reinterpret_cast<float2*>(sb + c * p.dv + col) = make_float2(v0, v1);
      }
    }
  }
}

}  // namespace

// r/k [BH, S, dk] bf16, v [BH, S, dv] bf16, logw [BH, S, dk] f32 (<= 0),
// u [BH, dk] f32, all contiguous and 16-byte aligned; dk, dv multiples of 8
// up to 64.  Writes y [BH, S, dv] bf16 and the final state [BH, dk, dv]
// f32.  Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* logw, const void* u, void* y,
                          void* s_out, int rows, int seq, int dk, int dv,
                          void* stream) {
  if (dk < 8 || dk > kMaxD || dk % 8 || dv < 8 || dv > kMaxD || dv % 8 || seq < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        rwkv6_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  Params p;
  p.r = static_cast<const __nv_bfloat16*>(r);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.s_out = static_cast<float*>(s_out);
  p.seq = seq; p.dk = dk; p.dv = dv;
  rwkv6_scan_kernel<<<rows, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The backward: rwkv6_scan_bwd, on the tensor cores.
//
// The TPU kernel has no backward: the reference differentiates its jnp twin
// (rwkv6_chunked_jnp) with JAX.  This kernel computes the same gradients,
// given dy and an optional gradient of the final state, chunk by chunk in
// reverse.  Per chunk (Q = 64 steps; cum the inclusive cumsum of logw, cp
// the exclusive one, i.e. cum of the step before; S0 the state at the
// chunk's start, G the gradient of the state at its end; E_ijc =
// exp(cp_ic - cum_jc) for j < i, zero elsewhere):
//
//   A_ij  = sum_c r_ic k_jc E_ijc,        dA_ij = dy_i . v_j   (j < i)
//   drs_i = sum_j E_ij k_j dA_ij + exp(cp_i) (S0 dy_i)           = S_{i-1} dy_i
//   dks_j = sum_i E_ij r_i dA_ij + exp(cum_Q - cum_j) (G v_j)    = G_j v_j
//   dr = drs + u k (v . dy),  dk = dks + u r (v . dy),  du = sum_i r_i k_i (v_i . dy_i)
//   dv_j  = sum_i A_ij dy_i + (r_j . u k_j) dy_j + G^T (k_j exp(cum_Q - cum_j))
//   G    <- exp(cum_Q) G + sum_i (r_i exp(cp_i)) dy_i^T
//
// The log-decays.  Per step, dlogw_t = w_t (S_{t-1} . G_t) summed over dv,
// with G_t the gradient of S_t.  With Phi_t = S_t . G_t (summed over dv),
// S_t = w_t S_{t-1} + k_t v_t^T and G_{t-1} = w_t G_t + r_t dy_t^T give
//
//   Phi_t = dlogw_t + k_t dks_t,   Phi_{t-1} = dlogw_t + r_t drs_t
//
// so dlogw_t = F + sum_{m>t} r_m drs_m - sum_{m>=t} k_m dks_m, F = S_final
// . dstate: a reverse running sum, per channel, of terms the walk already
// has.  No exponent enters it, and no exponent anywhere below is positive:
// where a chunk's log-decays sum below -88 the weights underflow to zero,
// as the per-step recurrence's products do, and every gradient stays
// finite (the reference twin's k exp(-cum) factor overflows there).
//
// What bounds it on an H100: bytes.  At RWKV6-7B's [256, 512, 64] it reads
// r, k, v, dy (bf16) and logw (fp32) and writes dr, dk, dv (bf16), dlogw
// and du (fp32), about 185 MB or 0.055 ms at 3.35 TB/s, against about 11
// GFLOP of products (0.011 ms at the bf16 rate); the scratch below adds
// 2 x 34 MB, mostly through L2.  Each row's chain of chunks is serial, so
// what sets the time is what a chunk step issues and waits for, at two
// warps a scheduler: its clock64 stamps on an H100 give about 47k cycles a
// reverse step (the 8-step triangles a fifth of it, the forward walk a
// seventh of the whole), some 0.26 ms at that shape.  The design, the
// forward's:
//
//   * Sub-chunk reference points, no exponential per (i, j, channel)
//     outside 8-step triangles.  The chunk is cut into four sub-chunks of
//     16 steps, one a warp.  For rows i of sub-chunk a against columns j
//     before it, E_ijc = exp(cp_ic - ref_c) exp(ref_c - cum_jc) with ref =
//     cum at the step before a, both factors <= 1: drs's part is
//     exp(cp_i - ref) (dA_(a,<a) k^), k^ = k exp(ref - cum), one mma.sync
//     product a warp.  For the columns j of sub-chunk b against the rows
//     after it, ref' = cum at b's last step: dks's part is
//     exp(ref' - cum_j) (dA^T r^), r^ = r exp(cp - ref'), and A^T's (which
//     dv takes) is k^ r^T, again one product a warp.  Inside each diagonal
//     16 x 16 block the same holds one level down around the cum of its
//     8th step (the quadrant of its later 8 rows against its first 8
//     columns).  The two 8-step triangles left on the diagonal take one
//     exp per (i, j, channel), each serving drs, dks and A^T at once: 224
//     a lane and chunk, balanced over the lanes (a lane walks the pairs
//     before its row for drs and those after it for dks).
//   * Tensor cores for the chunk-level products: dy v^T, v dy^T, v G^T,
//     A^T dy + k~ G (dv), the update of G and, in a first forward walk,
//     the state's update and z = dy S0^T are wgmma m64n64k16; the
//     sub-chunk products are mma.sync m16n8k16.  r, k, v and dy enter
//     exactly (bf16); every operand made in fp32 (dA, k^, r^, A^T, k~, G,
//     the state, (r exp(cp))^T) enters as a split pair hi + lo of bf16,
//     about 2^-17 of its value.  The CPU model of these operands
//     (ref.rwkv6_bwd_chunks(sub=16, operands=bf16)) keeps dlogw within
//     5.3e-6 and 6.5e-6 of its max against the fp32 per-step recurrence
//     at RWKV6's decays over 512 steps (tests/test_torch_scan_backward.py;
//     three parts everywhere: 2.4e-6 and 3.6e-6, no single operand ahead
//     of the others), so no operand takes three.
//   * Scratch: the forward walk writes each chunk's z = dy S0^T (fp32, in
//     the accumulators' register order) to a scratch [BH, chunks, 4096];
//     the reverse walk reads it into drs, so S0 never takes shared memory
//     there.  G lives as its hi + lo tiles in shared memory (the wgmma B
//     operand), carried from chunk to chunk as that pair (the CPU model:
//     no change to dlogw's error).
//   * One wave: one warpgroup of 128 threads a row, at most 255
//     registers, and 115,712 bytes of shared memory, so two blocks share
//     an SM and RWKV6's 256 rows run at once.  Each chunk's r, k, dy and
//     logw arrive by 16-byte cp.async into one of two buffers while the
//     chunk before computes; v, which only the chunk's first three
//     products read, has one buffer, reloaded once they are done.
//   * Compact code: a reverse chunk step is some 9k instructions (a first
//     version of 17k ran at about ten cycles an instruction), so the
//     sub-chunk loops stay rolled, a register fragment chosen at run time
//     is picked by opaque selects (sel: a ?: chain over a wgmma
//     accumulator became an indexed load, put the array on the stack and
//     serialised every wgmma), and the cumsum tile is unswizzled (rows of
//     68 floats: addresses fold into the loads' offsets).
//   * The scans over steps in parallel: the chunk's cumsum a warp's 16
//     steps a lane (two channels), then the earlier warps' totals; dlogw's
//     reverse running sum a suffix scan by warp shuffles over a warp's
//     rows, then the later warps' totals.  Every sum has a fixed order and
//     there are no float atomics: two calls give the same bits.
//   * Four block barriers a reverse chunk: after its data land, after its
//     cumsum's first half, after its cumsum, before G is rewritten.
namespace bwd {

using namespace sm90;

struct BwdParams {
  const __nv_bfloat16 *r, *k, *v, *dy;
  const float *logw, *u, *dstate;   // dstate: null = zero
  __nv_bfloat16 *dr, *dk, *dv;
  float *dlogw, *du, *scratch;      // scratch: per row, chunks x kZ
  int seq, dkd, dvd, chunks;
};

constexpr int kZ = 4096;             // floats of one chunk's z in the scratch
constexpr int kCum = kQ * kWP;       // a chunk's cumsum, rows padded to kWP floats
constexpr int kStash = kL * kDP;     // a warp's diagonal block: dA below, A^T above
// bf16: two buffers of (r, k, dy) (v, k, dy in the forward walk), v, G hi,
// G lo; fp32: two cumsums, four stashes, then totals [4][64], du partials
// [4][64], dlogw's running sum by chunk parity [2][64] and u [64].  115,712
// bytes, the most two blocks an SM can take: the dynamic shared memory
// starts 1024-aligned (at 0x400 on an H100), so no slack is kept for it
constexpr int kTiles = 9;
constexpr int kFloats = 2 * kCum + 4 * kStash + 4 * 64 + 4 * 64 + 2 * 64 + 64;
constexpr int kSmem = kTiles * kTile * 2 + kFloats * 4;

__device__ __forceinline__ int cix(int i, int c) { return i * kWP + c; }

// d += A B for split pairs A = ah + al, B = (b0h, b1h) + (b0l, b1l),
// dropping al bl
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b0h, uint32_t b1h,
                                     uint32_t b0l, uint32_t b1l) {
  mma_m16n8k16(d, ah, b0h, b1h);
  mma_m16n8k16(d, ah, b0l, b1l);
  mma_m16n8k16(d, al, b0h, b1h);
}

// c ? a : b, opaque to the compiler: a chain of these over a register
// array's elements stays selects, where plain ?: chains become an indexed
// load and push the array to the stack (and, for a wgmma accumulator, make
// ptxas serialise every wgmma)
__device__ __forceinline__ uint32_t sel(bool c, uint32_t a, uint32_t b) {
  uint32_t r;
  asm("{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\nselp.b32 %0, %1, %2, q;\n}\n"
      : "=r"(r)
      : "r"(a), "r"(b), "r"((int)c));
  return r;
}
__device__ __forceinline__ float sel(bool c, float a, float b) {
  return __uint_as_float(sel(c, __float_as_uint(a), __float_as_uint(b)));
}

// an mma.sync A fragment as a split pair from the 8 accumulator values of
// n-tiles 2 kk, 2 kk + 1 of a 64 x 64 wgmma accumulator, kk chosen at run
// time by selects, so the loop over kk need not unroll
__device__ __forceinline__ void pick_split(uint32_t (&ah)[4], uint32_t (&al)[4],
                                           const float (&d)[32], int kk) {
  float f[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    f[e] = sel(kk == 0, d[e], sel(kk == 1, d[8 + e], sel(kk == 2, d[16 + e], d[24 + e])));
#pragma unroll
  for (int q = 0; q < 4; ++q) split2(f[2 * q], f[2 * q + 1], ah[q], al[q]);
}

// inclusive suffix sum over the 8 lanes of a warp that share tig (rows gid .. 7)
__device__ __forceinline__ float suffix_gid(float x, int lane) {
#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(0xffffffffu, x, off);
    if (lane + off < 32) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads, 2) rwkv6_bwd_kernel(const BwdParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  if (smem_addr(smem_raw) & 1023u) __trap();   // wgmma's swizzled tiles need it
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* fsm = reinterpret_cast<float*>(tiles + kTiles * kTile);
  float* stash = fsm + 2 * kCum;
  float* tot = stash + 4 * kStash;
  float* dup = tot + 4 * 64;
  float* accv = dup + 4 * 64;
  float* us = accv + 2 * 64;

  const int tid = threadIdx.x;
  const int w = tid / 32;          // sub-chunk rows 16 w .. 16 w + 15, state rows too
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int row = blockIdx.x;
  const int S = p.seq;
  const int nc = p.chunks;
  const long long base_k = (long long)row * S * p.dkd;
  const long long base_v = (long long)row * S * p.dvd;
  const int i0 = kL * w + gid;     // this thread's accumulator rows
  const int i1 = i0 + 8;
  float* st = stash + w * kStash;
  float* scratch = p.scratch + (long long)row * nc * kZ;

  auto slot = [&](int buf, int t) { return tiles + (buf * 3 + t) * kTile; };
  __nv_bfloat16* V = tiles + 6 * kTile;
  __nv_bfloat16* Ghi = tiles + 7 * kTile;
  __nv_bfloat16* Glo = tiles + 8 * kTile;
  const uint32_t vsa = smem_addr(V), gha = smem_addr(Ghi), gla = smem_addr(Glo);
  auto c2 = [&](const float* cum, int i, int c) {
    return *reinterpret_cast<const float2*>(cum + cix(i, c));
  };
  auto cp2 = [&](const float* cum, int i, int c) {   // cp_i: cum of the step before, 0 at step 0
    return i > 0 ? c2(cum, i - 1, c) : make_float2(0.f, 0.f);
  };
  auto b2 = [&](const __nv_bfloat16* t, int i, int c) {
    return unpack2(*reinterpret_cast<const uint32_t*>(t + swz(i, c)));
  };
  auto put_split = [&](int at, float v0, float v1) {   // a G (state) pair at `at`
    split2(v0, v1, *reinterpret_cast<uint32_t*>(Ghi + at), *reinterpret_cast<uint32_t*>(Glo + at));
  };

  // 64 rows of a [S, width] bf16 tensor from step t0 into a swizzled tile,
  // 16 bytes a copy, zero past S and past width
  const int cr = tid / 8, ccol = (tid % 8) * 8;   // a copy's row (+ 16 q) and column
  const int csw = swz(cr, ccol);                   // rows 16 apart share the swizzle
  auto copy_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int t0, int width) {
    const bool col_in = ccol < width;
    const __nv_bfloat16* at = src + (long long)(t0 + cr) * width + ccol;
    const uint32_t d = smem_addr(dst + csw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool in = col_in && t0 + cr + 16 * q < S;
      cp_async16(d + q * 16 * 64 * 2, in ? at + 16 * q * width : src, in ? 16 : 0);
    }
  };
  // step ks of the two walks (the forward walk's chunk ks, then the reverse
  // walk's 2 nc - 1 - ks): its r (v forward), k, dy and logw into buffer ks & 1
  auto issue = [&](int ks) {
    if (ks >= 2 * nc) return;
    const bool rev = ks >= nc;
    const int t0 = (rev ? 2 * nc - 1 - ks : ks) * kQ;
    const int buf = ks & 1;
    if (rev) copy_tile(slot(buf, 0), p.r + base_k, t0, p.dkd);
    else copy_tile(slot(buf, 0), p.v + base_v, t0, p.dvd);
    copy_tile(slot(buf, 1), p.k + base_k, t0, p.dkd);
    copy_tile(slot(buf, 2), p.dy + base_v, t0, p.dvd);
    const int lr = tid / 16, lcol = (tid % 16) * 4;
    const uint32_t d = smem_addr(fsm + buf * kCum + cix(lr, lcol));
    const float* at = p.logw + base_k + (long long)(t0 + lr) * p.dkd + lcol;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool in = lcol < p.dkd && t0 + lr + 8 * q < S;
      cp_async16(d + q * 8 * kWP * 4, in ? at + 8 * q * p.dkd : p.logw, in ? 16 : 0);
    }
    cp_async_commit();
  };
  // the reverse step ks's v into the v buffer
  auto issue_v = [&](int ks) {
    if (ks >= 2 * nc) return;
    copy_tile(V, p.v + base_v, (2 * nc - 1 - ks) * kQ, p.dvd);
    cp_async_commit();
  };
  // the chunk's log2-domain inclusive cumsum of logw, in place: warp w scans
  // its 16 steps (a lane: channels 2 lane, 2 lane + 1), then adds the
  // earlier warps' totals in order; one block barrier inside
  auto cumsum = [&](float* cum) {
    float2 a[kL];
#pragma unroll
    for (int t = 0; t < kL; ++t) a[t] = c2(cum, kL * w + t, 2 * lane);
    float2 run = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < kL; ++t) {
      run.x = fmaf(a[t].x, kLog2e, run.x);
      run.y = fmaf(a[t].y, kLog2e, run.y);
      a[t] = run;
    }
    *reinterpret_cast<float2*>(tot + w * 64 + 2 * lane) = run;
    __syncthreads();
    float2 pre = make_float2(0.f, 0.f);
    for (int q = 0; q < w; ++q) {
      const float2 t = *reinterpret_cast<const float2*>(tot + q * 64 + 2 * lane);
      pre.x += t.x;
      pre.y += t.y;
    }
#pragma unroll
    for (int t = 0; t < kL; ++t)
      *reinterpret_cast<float2*>(cum + cix(kL * w + t, 2 * lane)) =
          make_float2(a[t].x + pre.x, a[t].y + pre.y);
  };

  for (int c = tid; c < 64; c += kThreads) us[c] = c < p.dkd ? p.u[(long long)row * p.dkd + c] : 0.f;
  for (int e = tid; e < 4 * 64; e += kThreads) dup[e] = 0.f;
  for (int e = tid; e < kTile; e += kThreads)   // G hi and lo: 2 x kTile bf16
    reinterpret_cast<uint32_t*>(Ghi)[e] = 0u;
  issue(0);

  // ---- the forward walk: each chunk's z = dy S0^T into the scratch; the
  //      state S in registers (rows c = i0, i1, columns q) and as hi + lo
  //      in the G tiles ----
  float s[32];
  zero(s);
  for (int ks = 0; ks < nc; ++ks) {
    cp_async_wait<0>();
    fence_proxy_async();   // the copies and the state writes, to wgmma's reads
    __syncthreads();
    issue(ks + 1);
    if (ks + 1 == nc) issue_v(nc);
    const int buf = ks & 1;
    const uint32_t va = smem_addr(slot(buf, 0)), dya = smem_addr(slot(buf, 2));
    const __nv_bfloat16* K = slot(buf, 1);
    float* cum = fsm + buf * kCum;
    float z[32];
    zero(z);
    fence_operands(z);
    wgmma_fence();
    ss_product<false>(z, dya, gha, false);   // z = dy S^T
    ss_product<false>(z, dya, gla, true);
    wgmma_commit();
    cumsum(cum);
    wgmma_wait_all();
    fence_operands(z);
    frag_store(scratch + ks * kZ, z, tid);
    __syncthreads();   // the cumsum is in place; every warp has read the state tiles
    // S = diag(exp(cum_Q)) S + (k exp(cum_Q - cum))^T v
    const float q0 = cum[cix(kQ - 1, i0)], q1 = cum[cix(kQ - 1, i1)];
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t kt[4];
      ldmatrix_x4_trans(kt, smem_addr(K + swz(16 * kk + (lane >> 4) * 8 + (lane & 7),
                                              kL * w + ((lane >> 3) & 1) * 8)));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int j = 16 * kk + (m >> 1) * 8 + 2 * tig;
        const int c = (m & 1) ? i1 : i0;
        const float qc = (m & 1) ? q1 : q0;
        const float2 kv = unpack2(kt[m]);
        split2(kv.x * fast_exp2(qc - cum[cix(j, c)]), kv.y * fast_exp2(qc - cum[cix(j + 1, c)]),
               ah[kk][m], al[kk][m]);
      }
    }
    const float d0 = fast_exp2(q0), d1 = fast_exp2(q1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= ((i >> 1) & 1) ? d1 : d0;
    fence_operands(s);
    fence_fragments(ah);
    fence_fragments(al);
    wgmma_fence();
    rs_product(s, ah, al, va);
    wait_products(s);
    fence_fragments(ah);
    fence_fragments(al);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put_split(swz(h ? i1 : i0, 8 * n + 2 * tig), s[4 * n + 2 * h], s[4 * n + 2 * h + 1]);
  }

  // F = S_final . dstate per channel starts dlogw's running sum; G = dstate
  {
    float f[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h ? i1 : i0, q = 8 * n + 2 * tig;
        float2 d = make_float2(0.f, 0.f);
        if (p.dstate && c < p.dkd && q < p.dvd)
          d = *reinterpret_cast<const float2*>(p.dstate + ((long long)row * p.dkd + c) * p.dvd + q);
        f[h] = fmaf(s[4 * n + 2 * h], d.x, fmaf(s[4 * n + 2 * h + 1], d.y, f[h]));
        put_split(swz(c, q), d.x, d.y);
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = f[h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      if (tig == 0) accv[((nc - 1) & 1) * 64 + (h ? i1 : i0)] = v;
    }
  }

  // ---- the reverse walk ----
  for (int ks = nc; ks < 2 * nc; ++ks) {
    const int ci = 2 * nc - 1 - ks;
    const int t0 = ci * kQ;
    const int buf = ks & 1;
    const int par = ci & 1;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();   // the chunk's tiles, the G tiles and the running sum are in place
    issue(ks + 1);
    const __nv_bfloat16* R = slot(buf, 0);
    const __nv_bfloat16* K = slot(buf, 1);
    const uint32_t dya = smem_addr(slot(buf, 2));
    float* cum = fsm + buf * kCum;

    // ---- the three products that read v, while the cumsum runs ----
    float dA[32], dAt[32], vg[32];
    zero(dA);
    zero(dAt);
    zero(vg);
    fence_operands(dA);
    fence_operands(dAt);
    fence_operands(vg);
    wgmma_fence();
    ss_product<false>(dA, dya, vsa, false);    // dy v^T: rows i, columns j
    ss_product<false>(dAt, vsa, dya, false);   // v dy^T: rows j, columns i
    ss_product<false>(vg, vsa, gha, false);    // v G^T: rows j, columns c
    ss_product<false>(vg, vsa, gla, true);
    wgmma_commit();
    cumsum(cum);
    wgmma_wait_all();
    fence_operands(dA);
    fence_operands(dAt);
    fence_operands(vg);
    __syncthreads();   // the cumsum is in place; every warp is done with v
    issue_v(ks + 1);

    // dA's diagonal block (its diagonal: v_i . dy_i) into this warp's
    // stash, below and on its diagonal; the bonus r_i . u k_i of rows i0, i1
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int li = gid + 8 * (e >> 1), lj = 8 * h + 2 * tig + (e & 1);
        const int at = 4 * h + e;   // n-tile 2 w + h
        const float v = sel(w == 0, dA[at], sel(w == 1, dA[8 + at], sel(w == 2, dA[16 + at],
                                                                        dA[24 + at])));
        if (lj <= li) st[li * kDP + lj] = v;
      }
    float bon0, bon1;
    {
      const int li = lane & 15, half = lane >> 4;
      const int i = kL * w + li;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 32 * half + 8 * q;
        float rv[8], kv[8];
        unpack8(*reinterpret_cast<const uint4*>(R + swz(i, c)), rv);
        unpack8(*reinterpret_cast<const uint4*>(K + swz(i, c)), kv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(rv[e] * us[c + e], kv[e], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);
      bon0 = __shfl_sync(0xffffffffu, acc, gid);
      bon1 = __shfl_sync(0xffffffffu, acc, gid + 8);
    }
    __syncwarp();
    const float bd0 = st[gid * kDP + gid], bd1 = st[(gid + 8) * kDP + gid + 8];

    // ---- dks_j (rows j = i0, i1, channels c): G v_j's term, then the rows
    //      after this sub-chunk around ref' = cum_{16 w + 15}: both scaled
    //      by exp(ref' - cum_j) at the end ----
    float dks[8][4];
    {
      const int rf = kL * w + kL - 1;   // 63, cum_Q itself, for the last sub-chunk
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * tig;
        const float2 q = c2(cum, kQ - 1, c), ref = c2(cum, rf, c);
        const float e0 = fast_exp2(q.x - ref.x), e1 = fast_exp2(q.y - ref.y);
#pragma unroll
        for (int e = 0; e < 4; ++e) dks[n][e] = ((e & 1) ? e1 : e0) * vg[4 * n + e];
      }
#pragma unroll 1
      for (int kk = w + 1; kk < 4; ++kk) {
        uint32_t ah[4], al[4];
        pick_split(ah, al, dAt, kk);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t rb[4], bh[4], bl[4];
          ldmatrix_x4_trans(rb, smem_addr(R + swz(16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                  16 * pp + (lane >> 4) * 8)));
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int i = 16 * kk + (m & 1) * 8 + 2 * tig, c = 16 * pp + (m >> 1) * 8 + gid;
            const float ref = cum[cix(rf, c)];
            const float2 rv = unpack2(rb[m]);
            split2(rv.x * fast_exp2(cum[cix(i - 1, c)] - ref), rv.y * fast_exp2(cum[cix(i, c)] - ref),
                   bh[m], bl[m]);
          }
          mma3(dks[2 * pp], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(dks[2 * pp + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * tig;
        const float2 ref = c2(cum, rf, c), ca = c2(cum, i0, c), cb = c2(cum, i1, c);
        dks[n][0] *= fast_exp2(ref.x - ca.x);
        dks[n][1] *= fast_exp2(ref.y - ca.y);
        dks[n][2] *= fast_exp2(ref.x - cb.x);
        dks[n][3] *= fast_exp2(ref.y - cb.y);
      }
    }
    // the quadrant: rows i0 (the block's first 8) against the rows i of its
    // last 8, around m = cum_{16 w + 7}
    {
      const int mr = kL * w + 7;
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      float f[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)   // n-tile 2 w + 1, row i0
        f[e] = sel(w == 0, dAt[4 + e], sel(w == 1, dAt[12 + e], sel(w == 2, dAt[20 + e],
                                                                    dAt[28 + e])));
      split2(f[0], f[1], ah[2], al[2]);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t rb[4];
        ldmatrix_x4_trans(rb, smem_addr(R + swz(kL * w + 8 + (lane & 7), 32 * pp + (lane >> 3) * 8)));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = kL * w + 8 + 2 * tig, c = 32 * pp + 8 * m + gid;
          const float mref = cum[cix(mr, c)];
          const float2 rv = unpack2(rb[m]);
          uint32_t bh, bl;
          split2(rv.x * fast_exp2(cum[cix(i - 1, c)] - mref), rv.y * fast_exp2(cum[cix(i, c)] - mref),
                 bh, bl);
          float qd[4] = {0.f, 0.f, 0.f, 0.f};
          mma_m16n8k16(qd, ah, 0u, bh);
          mma_m16n8k16(qd, ah, 0u, bl);
          mma_m16n8k16(qd, al, 0u, bh);
          const int n = 4 * pp + m, cc = 8 * n + 2 * tig;
          const float2 mm = c2(cum, mr, cc), cj = c2(cum, i0, cc);
          dks[n][0] = fmaf(fast_exp2(mm.x - cj.x), qd[0], dks[n][0]);
          dks[n][1] = fmaf(fast_exp2(mm.y - cj.y), qd[1], dks[n][1]);
        }
      }
    }

    // ---- drs_i (rows i = i0, i1): exp(cp_i) z_i, then the columns before
    //      this sub-chunk around ref = cum_{16 w - 1}: z enters scaled by
    //      exp(ref), both by exp(cp_i - ref) at the end (ref = 0 for w = 0) ----
    float drs[8][4];
    {
      float zr[32];   // this chunk's dy S0^T
      frag_load(zr, scratch + ci * kZ, tid);
      const int rf = kL * w - 1;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 ref = cp2(cum, kL * w, 8 * n + 2 * tig);
        const float e0 = fast_exp2(ref.x), e1 = fast_exp2(ref.y);
#pragma unroll
        for (int e = 0; e < 4; ++e) drs[n][e] = ((e & 1) ? e1 : e0) * zr[4 * n + e];
      }
#pragma unroll 1
      for (int kk = 0; kk < w; ++kk) {
        uint32_t ah[4], al[4];
        pick_split(ah, al, dA, kk);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t kb[4], bh[4], bl[4];
          ldmatrix_x4_trans(kb, smem_addr(K + swz(16 * kk + ((lane >> 3) & 1) * 8 + (lane & 7),
                                                  16 * pp + (lane >> 4) * 8)));
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const int j = 16 * kk + (m & 1) * 8 + 2 * tig, c = 16 * pp + (m >> 1) * 8 + gid;
            const float ref = cum[cix(rf, c)];
            const float2 kv = unpack2(kb[m]);
            split2(kv.x * fast_exp2(ref - cum[cix(j, c)]), kv.y * fast_exp2(ref - cum[cix(j + 1, c)]),
                   bh[m], bl[m]);
          }
          mma3(drs[2 * pp], ah, al, bh[0], bh[1], bl[0], bl[1]);
          mma3(drs[2 * pp + 1], ah, al, bh[2], bh[3], bl[2], bl[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * tig;
        const float2 ref = cp2(cum, kL * w, c), pa = cp2(cum, i0, c), pb = c2(cum, i1 - 1, c);
        drs[n][0] *= fast_exp2(pa.x - ref.x);
        drs[n][1] *= fast_exp2(pa.y - ref.y);
        drs[n][2] *= fast_exp2(pb.x - ref.x);
        drs[n][3] *= fast_exp2(pb.y - ref.y);
      }
    }
    // the quadrant: rows i1 (the block's last 8) against its first 8 columns
    {
      const int mr = kL * w + 7;
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u};
      float f[2];
#pragma unroll
      for (int e = 0; e < 2; ++e)   // n-tile 2 w, row i1
        f[e] = sel(w == 0, dA[2 + e], sel(w == 1, dA[10 + e], sel(w == 2, dA[18 + e],
                                                                  dA[26 + e])));
      split2(f[0], f[1], ah[1], al[1]);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, smem_addr(K + swz(kL * w + (lane & 7), 32 * pp + (lane >> 3) * 8)));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int j = kL * w + 2 * tig, c = 32 * pp + 8 * m + gid;
          const float mref = cum[cix(mr, c)];
          const float2 kv = unpack2(kb[m]);
          uint32_t bh, bl;
          split2(kv.x * fast_exp2(mref - cum[cix(j, c)]), kv.y * fast_exp2(mref - cum[cix(j + 1, c)]),
                 bh, bl);
          float qd[4] = {0.f, 0.f, 0.f, 0.f};
          mma_m16n8k16(qd, ah, bh, 0u);
          mma_m16n8k16(qd, ah, bl, 0u);
          mma_m16n8k16(qd, al, bh, 0u);
          const int n = 4 * pp + m, cc = 8 * n + 2 * tig;
          const float2 mm = c2(cum, mr, cc), cp = c2(cum, i1 - 1, cc);
          drs[n][2] = fmaf(fast_exp2(cp.x - mm.x), qd[2], drs[n][2]);
          drs[n][3] = fmaf(fast_exp2(cp.y - mm.y), qd[3], drs[n][3]);
        }
      }
    }

    // ---- the two 8-step triangles of the diagonal block, one exp per (i,
    //      j, channel) serving drs, dks and A^T: a lane walks the gid steps
    //      before its row (drs) and the 7 - gid after it (dks, and A^T into
    //      the stash above its diagonal) ----
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int own_l = 8 * t + gid, own = kL * w + own_l;
      float cpo[16], cuo[16];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * tig;
        const float2 a = cp2(cum, own, c), b = c2(cum, own, c);
        cpo[2 * n] = a.x;
        cpo[2 * n + 1] = a.y;
        cuo[2 * n] = b.x;
        cuo[2 * n + 1] = b.y;
      }
#pragma unroll 1
      for (int vis = 0; vis < 7; ++vis) {
        const bool rs = vis < gid;
        const int o_l = rs ? own_l - 1 - vis : own_l + 1 + vis - gid;
        const int o = kL * w + o_l;
        const __nv_bfloat16* T = rs ? K : R;
        const int lrow = rs ? o : o - 1;
        const float coef = rs ? st[own_l * kDP + o_l] : st[o_l * kDP + own_l];
        float part = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int c = 8 * n + 2 * tig;
          const float2 l = c2(cum, lrow, c), ov = b2(T, o, c), ko = b2(K, own, c);
          const float e0 = fast_exp2(rs ? cpo[2 * n] - l.x : l.x - cuo[2 * n]);
          const float e1 = fast_exp2(rs ? cpo[2 * n + 1] - l.y : l.y - cuo[2 * n + 1]);
          const float y0 = coef * ov.x * e0, y1 = coef * ov.y * e1;
          if (rs) {
            drs[n][2 * t] += y0;
            drs[n][2 * t + 1] += y1;
          } else {
            dks[n][2 * t] += y0;
            dks[n][2 * t + 1] += y1;
          }
          part = fmaf(ov.x * ko.x, e0, fmaf(ov.y * ko.y, e1, part));
        }
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        if (!rs && tig == 0) st[own_l * kDP + o_l] = part;
      }
    }
    __syncwarp();

    // ---- dr, dk out; du; dlogw's terms r drs - k dks, suffix-summed over
    //      this warp's rows (loc: that sum less r drs) and its totals ----
    float loc[32];
    {
      __nv_bfloat16* drb = p.dr + base_k;
      __nv_bfloat16* dkb = p.dk + base_k;
#pragma unroll
      for (int yh = 0; yh < 2; ++yh) {
        uint32_t vr[2][4], vk[2][4];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int n = 4 * yh + t, c = 8 * n + 2 * tig;
          const float2 uu = *reinterpret_cast<const float2*>(us + c);
          const float2 ra = b2(R, i0, c), ka = b2(K, i0, c), rb = b2(R, i1, c), kb = b2(K, i1, c);
          vr[0][t] = pack_bf16x2(fmaf(uu.x * ka.x, bd0, drs[n][0]), fmaf(uu.y * ka.y, bd0, drs[n][1]));
          vr[1][t] = pack_bf16x2(fmaf(uu.x * kb.x, bd1, drs[n][2]), fmaf(uu.y * kb.y, bd1, drs[n][3]));
          vk[0][t] = pack_bf16x2(fmaf(uu.x * ra.x, bd0, dks[n][0]), fmaf(uu.y * ra.y, bd0, dks[n][1]));
          vk[1][t] = pack_bf16x2(fmaf(uu.x * rb.x, bd1, dks[n][2]), fmaf(uu.y * rb.y, bd1, dks[n][3]));
          const float rdv[4] = {ra.x * drs[n][0], ra.y * drs[n][1], rb.x * drs[n][2],
                                rb.y * drs[n][3]};
          const float kdv[4] = {ka.x * dks[n][0], ka.y * dks[n][1], kb.x * dks[n][2],
                                kb.y * dks[n][3]};
          const float rk[4] = {ra.x * ka.x, ra.y * ka.y, rb.x * kb.x, rb.y * kb.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float s1 = suffix_gid(rdv[2 + e] - kdv[2 + e], lane);
            const float t1 = __shfl_sync(0xffffffffu, s1, tig);
            const float s0 = suffix_gid(rdv[e] - kdv[e], lane) + t1;
            loc[4 * n + e] = s0 - rdv[e];
            loc[4 * n + 2 + e] = s1 - rdv[2 + e];
            float dp = fmaf(rk[e], bd0, rk[2 + e] * bd1);
            dp += __shfl_xor_sync(0xffffffffu, dp, 4);
            dp += __shfl_xor_sync(0xffffffffu, dp, 8);
            dp += __shfl_xor_sync(0xffffffffu, dp, 16);
            if (gid == 0) {
              tot[w * 64 + c + e] = s0;
              dup[w * 64 + c + e] += dp;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = h ? i1 : i0, col = 32 * yh + 8 * tig;
          transpose_quad(vr[h], tig);
          transpose_quad(vk[h], tig);
          if (t0 + i < S && col < p.dkd) {
            const long long at = (long long)(t0 + i) * p.dkd + col;
            *reinterpret_cast<uint4*>(drb + at) = make_uint4(vr[h][0], vr[h][1], vr[h][2], vr[h][3]);
            *reinterpret_cast<uint4*>(dkb + at) = make_uint4(vk[h][0], vk[h][1], vk[h][2], vk[h][3]);
          }
        }
      }
    }

    // ---- dv's A operand A^T (rows j = i0, i1, k-steps of 16 columns i):
    //      zero before this sub-chunk; on it the stash's triangles, the
    //      bonus on the diagonal and the quadrant (mma.sync around m); after
    //      it the rows after this sub-chunk around ref' = cum_{16 w + 15}
    //      (mma.sync), a k-step a pass ----
    uint32_t fh[4][4], fl[4][4];
    {
      const int mr = kL * w + 7, ih = kL * w + 8 + gid;
      float qa[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        uint32_t ah[4] = {0u, 0u, 0u, 0u}, al[4] = {0u, 0u, 0u, 0u}, bh[2], bl[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * kc + 2 * tig + 8 * h;
          const float2 mm = c2(cum, mr, c), kv = b2(K, i0, c), cj = c2(cum, i0, c);
          const float2 rv = b2(R, ih, c), cp = c2(cum, ih - 1, c);
          split2(kv.x * fast_exp2(mm.x - cj.x), kv.y * fast_exp2(mm.y - cj.y), ah[2 * h], al[2 * h]);
          split2(rv.x * fast_exp2(cp.x - mm.x), rv.y * fast_exp2(cp.y - mm.y), bh[h], bl[h]);
        }
        mma3(qa, ah, al, bh[0], bh[1], bl[0], bl[1]);
      }
      float f[8];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int li = 2 * tig + e;
        f[e] = li > gid ? st[gid * kDP + li] : li == gid ? bon0 : 0.f;
        f[2 + e] = 0.f;
        f[4 + e] = qa[e];
        f[6 + e] = li > gid ? st[(8 + gid) * kDP + 8 + li] : li == gid ? bon1 : 0.f;
      }
      uint32_t dh[4], dl[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) split2(f[2 * q], f[2 * q + 1], dh[q], dl[q]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          fh[kk][q] = kk == w ? dh[q] : 0u;
          fl[kk][q] = kk == w ? dl[q] : 0u;
        }
    }
    if (w < 3) {
      const int rf = kL * w + kL - 1;
      uint32_t kh[4][4], kl[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (e & 1) ? i1 : i0, c = 16 * kc + 2 * tig + ((e & 2) ? 8 : 0);
          const float2 kv = b2(K, j, c), ref = c2(cum, rf, c), cj = c2(cum, j, c);
          split2(kv.x * fast_exp2(ref.x - cj.x), kv.y * fast_exp2(ref.y - cj.y), kh[kc][e],
                 kl[kc][e]);
        }
#pragma unroll 1
      for (int kk = w + 1; kk < 4; ++kk) {
        float tp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int i = 16 * kk + 8 * h2 + gid;
#pragma unroll
          for (int kc = 0; kc < 4; ++kc) {
            uint32_t bh[2], bl[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int c = 16 * kc + 2 * tig + 8 * h;
              const float2 rv = b2(R, i, c), cp = c2(cum, i - 1, c), ref = c2(cum, rf, c);
              split2(rv.x * fast_exp2(cp.x - ref.x), rv.y * fast_exp2(cp.y - ref.y), bh[h], bl[h]);
            }
            mma3(tp[h2], kh[kc], kl[kc], bh[0], bh[1], bl[0], bl[1]);
          }
        }
        uint32_t nh[4], nl[4];
        split2(tp[0][0], tp[0][1], nh[0], nl[0]);
        split2(tp[0][2], tp[0][3], nh[1], nl[1]);
        split2(tp[1][0], tp[1][1], nh[2], nl[2]);
        split2(tp[1][2], tp[1][3], nh[3], nl[3]);
#pragma unroll
        for (int q = 0; q < 4; ++q)   // into k-step kk's fragments, by selects
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            fh[q][e] = sel(q == kk, nh[e], fh[q][e]);
            fl[q][e] = sel(q == kk, nl[e], fl[q][e]);
          }
      }
    }
    // k~ = k exp(cum_Q - cum), rows j, k = channel
    uint32_t th[4][4], tl[4][4];
#pragma unroll
    for (int kc = 0; kc < 4; ++kc)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = (e & 1) ? i1 : i0, c = 16 * kc + 2 * tig + ((e & 2) ? 8 : 0);
        const float2 kv = b2(K, j, c), q = c2(cum, kQ - 1, c), cj = c2(cum, j, c);
        split2(kv.x * fast_exp2(q.x - cj.x), kv.y * fast_exp2(q.y - cj.y), th[kc][e], tl[kc][e]);
      }
    // ---- dv = A^T dy + k~ G ----
    {
      float dvv[32];
      zero(dvv);
      fence_operands(dvv);
      fence_fragments(fh);
      fence_fragments(fl);
      fence_fragments(th);
      fence_fragments(tl);
      wgmma_fence();
      rs_product(dvv, fh, fl, dya);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) {
        const uint64_t dh = desc_sw128(gha + kc * 2048, 8192), dl = desc_sw128(gla + kc * 2048, 8192);
        wgmma_rs_n64(dvv, th[kc], dh);
        wgmma_rs_n64(dvv, th[kc], dl);
        wgmma_rs_n64(dvv, tl[kc], dh);
      }
      wait_products(dvv);
      fence_fragments(fh);
      fence_fragments(fl);
      fence_fragments(th);
      fence_fragments(tl);
      __nv_bfloat16* dvb = p.dv + base_v;
#pragma unroll
      for (int yh = 0; yh < 2; ++yh)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = h ? i1 : i0;
          uint32_t v[4];
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int n = 4 * yh + t;
            v[t] = pack_bf16x2(dvv[4 * n + 2 * h], dvv[4 * n + 2 * h + 1]);
          }
          transpose_quad(v, tig);
          const int col = 32 * yh + 8 * tig;
          if (t0 + j < S && col < p.dvd)
            *reinterpret_cast<uint4*>(dvb + (long long)(t0 + j) * p.dvd + col) =
                make_uint4(v[0], v[1], v[2], v[3]);
        }
    }
    // ---- G <- diag(exp(cum_Q)) G + (r exp(cp))^T dy, rows c = i0, i1; G
    //      carried as its hi + lo pair ----
    float g[32];
    {
      const float d0 = fast_exp2(cum[cix(kQ - 1, i0)]), d1 = fast_exp2(cum[cix(kQ - 1, i1)]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = swz(h ? i1 : i0, 8 * n + 2 * tig);
          const float2 gh = unpack2(*reinterpret_cast<const uint32_t*>(Ghi + at));
          const float2 gl = unpack2(*reinterpret_cast<const uint32_t*>(Glo + at));
          g[4 * n + 2 * h] = (h ? d1 : d0) * (gh.x + gl.x);
          g[4 * n + 2 * h + 1] = (h ? d1 : d0) * (gh.y + gl.y);
        }
      uint32_t uh[4][4], ul[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t rb[4];
        ldmatrix_x4_trans(rb, smem_addr(R + swz(16 * kk + (lane >> 4) * 8 + (lane & 7),
                                                kL * w + ((lane >> 3) & 1) * 8)));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int i = 16 * kk + (m >> 1) * 8 + 2 * tig;
          const int c = (m & 1) ? i1 : i0;
          const float2 rv = unpack2(rb[m]);
          const float cpi = i > 0 ? cum[cix(i - 1, c)] : 0.f;
          split2(rv.x * fast_exp2(cpi), rv.y * fast_exp2(cum[cix(i, c)]), uh[kk][m], ul[kk][m]);
        }
      }
      fence_operands(g);
      fence_fragments(uh);
      fence_fragments(ul);
      wgmma_fence();
      rs_product(g, uh, ul, dya);
      wait_products(g);
      fence_fragments(uh);
      fence_fragments(ul);
    }
    __syncthreads();   // every warp's totals are in; every read of the G tiles is done
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        put_split(swz(h ? i1 : i0, 8 * n + 2 * tig), g[4 * n + 2 * h], g[4 * n + 2 * h + 1]);
    // ---- dlogw = the running sum + the later warps' totals + loc ----
    {
      const float* acc = accv + par * 64;
      float* dl = p.dlogw + base_k;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int c = 8 * n + 2 * tig;
        float2 base = *reinterpret_cast<const float2*>(acc + c);
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          if (q <= w) continue;
          const float2 t = *reinterpret_cast<const float2*>(tot + q * 64 + c);
          base.x += t.x;
          base.y += t.y;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = h ? i1 : i0;
          if (t0 + i < S && c < p.dkd)
            *reinterpret_cast<float2*>(dl + (long long)(t0 + i) * p.dkd + c) =
                make_float2(base.x + loc[4 * n + 2 * h], base.y + loc[4 * n + 2 * h + 1]);
        }
      }
      if (tid < 64)
        accv[(par ^ 1) * 64 + tid] =
            acc[tid] + (((tot[tid] + tot[64 + tid]) + tot[128 + tid]) + tot[192 + tid]);
    }
  }
  __syncthreads();
  if (tid < p.dkd)
    p.du[(long long)row * p.dkd + tid] = ((dup[tid] + dup[64 + tid]) + dup[128 + tid]) + dup[192 + tid];
}

}  // namespace bwd

// The backward of rwkv6_scan.  Inputs as rwkv6_scan's, plus dy [BH, S, dv]
// bf16 and dstate [BH, dk, dv] f32 (null: zero).  Writes dr, dk [BH, S,
// dk] and dv [BH, S, dv] bf16, dlogw [BH, S, dk] and du [BH, dk] f32;
// scratch is f32 of BH x ceil(S / 64) x 4096.  Launches on `stream`;
// returns cudaGetLastError() after the launch.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* dy,
                              const void* dstate, void* dr, void* dk, void* dv,
                              void* dlogw, void* du, void* scratch, int rows, int seq,
                              int dkd, int dvd, void* stream) {
  if (dkd < 8 || dkd > kMaxD || dkd % 8 || dvd < 8 || dvd > kMaxD || dvd % 8 || seq < 1 ||
      rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd::rwkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd::kSmem);
    if (err == cudaSuccess)   // two blocks an SM need the largest shared carveout
      err = cudaFuncSetAttribute(bwd::rwkv6_bwd_kernel,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  bwd::BwdParams p;
  p.r = static_cast<const __nv_bfloat16*>(r);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dy = static_cast<const __nv_bfloat16*>(dy);
  p.logw = static_cast<const float*>(logw);
  p.u = static_cast<const float*>(u);
  p.dstate = static_cast<const float*>(dstate);
  p.dr = static_cast<__nv_bfloat16*>(dr);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dlogw = static_cast<float*>(dlogw);
  p.du = static_cast<float*>(du);
  p.scratch = static_cast<float*>(scratch);
  p.seq = seq; p.dkd = dkd; p.dvd = dvd;
  p.chunks = (seq + kQ - 1) / kQ;
  bwd::rwkv6_bwd_kernel<<<rows, kThreads, bwd::kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
