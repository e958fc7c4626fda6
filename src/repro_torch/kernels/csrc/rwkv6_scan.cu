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
#include "tile64.cuh"

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
// The backward: rwkv6_scan_bwd.
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
// with G_t the gradient of S_t: one state product per step, or, chunked,
// exponents of both signs.  With Phi_t = S_t . G_t (summed over dv), S_t =
// w_t S_{t-1} + k_t v_t^T and G_{t-1} = w_t G_t + r_t dy_t^T give
//
//   Phi_t = dlogw_t + k_t dks_t,   Phi_{t-1} = dlogw_t + r_t drs_t
//
// so dlogw_t = F + sum_{m>t} r_m drs_m - sum_{m>=t} k_m dks_m, F = S_final
// . dstate: a reverse running sum, per channel, of terms the walk already
// has (the route of GLA-style scans).  No exponent enters it; the E above
// and the tails exp(cum_Q - cum_j), exp(cp_i), exp(cum_Q) are all <= 1.
// Where a chunk's log-decays sum below -88 they underflow to zero, as the
// per-step recurrence's products do, and every gradient stays finite (the
// reference twin's k exp(-cum) factor overflows there).
//
// States: a first forward walk writes each chunk's starting state and the
// final one into an fp32 scratch [BH, nc + 1, dk, dv] (33.6 MB at
// RWKV6-7B's [256, 512, 64]); recomputed rather than saved by the forward
// so that training holds nothing from a layer's forward to its backward.
//
// What bounds it on an H100: bytes, at RWKV6-7B's shape about 185 MB read
// and written (0.055 ms at 3.35 TB/s; the scratch adds 2 x 34 MB through
// L2) against about 6 GFLOP and 0.4 G exponentials.  This first version is
// plain fp32 FMA: one block of 256 threads a row, every operand in shared
// memory as 64 x 64 fp32 tiles (tile64.cuh), each thread a 4 x 4 register
// tile of each product, E computed where it is used (three uses, one exp
// each: it would take 1 MB a chunk to keep).  Making it fast is later work.
namespace bwd {

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
  const __nv_bfloat16 *r, *k, *v, *dy;
  const float *logw, *u, *dstate;   // dstate: null = zero
  __nv_bfloat16 *dr, *dk, *dv;
  float *dlogw, *du, *states;
  int seq, dkd, dvd, chunks;
};

constexpr int kTiles = 9;
constexpr int kVecs = 5;
constexpr int kSmem = (kTiles * kTile + kVecs * kQ) * 4;

__global__ void __launch_bounds__(kThreads, 1) rwkv6_bwd_kernel(const BwdParams p) {
  extern __shared__ float sm[];
  float *R = sm, *K = R + kTile, *V = K + kTile, *DY = V + kTile, *CUM = DY + kTile;
  float *S0 = CUM + kTile, *G = S0 + kTile, *A = G + kTile, *DA = A + kTile;
  float *uv = DA + kTile, *acc_c = uv + kQ, *du_c = acc_c + kQ, *bdot = du_c + kQ;
  float *bonus = bdot + kQ;

  const int row = blockIdx.x, tid = threadIdx.x;
  const int ti = row0(), tj = col0();
  const long long base_row = (long long)row * p.seq;
  const long long state_elems = (long long)p.dkd * p.dvd;
  float* states = p.states + (long long)row * (p.chunks + 1) * state_elems;
  if (tid < kQ) {
    uv[tid] = tid < p.dkd ? p.u[(long long)row * p.dkd + tid] : 0.f;
    du_c[tid] = 0.f;
  }

  // the chunk's log-decays as their inclusive cumsum per channel (thread c
  // walks channel c in order); steps past S load as logw = 0
  auto chunk_cumsum = [&](int base, int steps) {
    load(CUM, p.logw + (base_row + base) * p.dkd, steps, p.dkd);
    __syncthreads();
    if (tid < kQ) {
      float run = 0.f;
      for (int i = 0; i < kQ; ++i) {
        run += CUM[i * kLd + tid];
        CUM[i * kLd + tid] = run;
      }
    }
    __syncthreads();
  };
  auto cp = [&](int i, int c) { return i > 0 ? CUM[(i - 1) * kLd + c] : 0.f; };

  // --- the forward walk: each chunk's starting state, then the final one
  for (int e = tid; e < kTile; e += kThreads) G[e] = 0.f;
  for (int ci = 0; ci < p.chunks; ++ci) {
    const int base = ci * kQ, steps = min(kQ, p.seq - base);
    __syncthreads();
    store(states + ci * state_elems, G, p.dkd, p.dvd);
    load(K, p.k + (base_row + base) * p.dkd, steps, p.dkd);
    load(V, p.v + (base_row + base) * p.dvd, steps, p.dvd);
    chunk_cumsum(base, steps);
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = ti + 16 * m;
        acc[m][n] = __expf(CUM[(kQ - 1) * kLd + c]) * G[c * kLd + tj + 16 * n];
      }
    product(acc,
            [&](int c, int j) {
              return K[j * kLd + c] * __expf(CUM[(kQ - 1) * kLd + c] - CUM[j * kLd + c]);
            },
            [&](int q, int j) { return V[j * kLd + q]; });
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) G[(ti + 16 * m) * kLd + tj + 16 * n] = acc[m][n];
  }
  __syncthreads();
  store(states + p.chunks * state_elems, G, p.dkd, p.dvd);
  __syncthreads();

  // F = S_final . dstate per channel starts the running sum of dlogw; G is
  // now the gradient of the state
  if (p.dstate) {
    const float* dst = p.dstate + (long long)row * state_elems;
    if (tid < kQ) {
      float f = 0.f;
      for (int q = 0; q < p.dvd && tid < p.dkd; ++q)
        f = fmaf(G[tid * kLd + q], dst[tid * p.dvd + q], f);
      acc_c[tid] = f;
    }
    __syncthreads();
    load(G, dst, p.dkd, p.dvd);
  } else {
    if (tid < kQ) acc_c[tid] = 0.f;
    for (int e = tid; e < kTile; e += kThreads) G[e] = 0.f;
  }
  for (int ci = p.chunks - 1; ci >= 0; --ci) {
    const int base = ci * kQ, steps = min(kQ, p.seq - base);
    __syncthreads();
    load(R, p.r + (base_row + base) * p.dkd, steps, p.dkd);
    load(K, p.k + (base_row + base) * p.dkd, steps, p.dkd);
    load(V, p.v + (base_row + base) * p.dvd, steps, p.dvd);
    load(DY, p.dy + (base_row + base) * p.dvd, steps, p.dvd);
    load(S0, states + ci * state_elems, p.dkd, p.dvd);
    chunk_cumsum(base, steps);
    if (tid < kQ) {                      // v_i . dy_i and r_i . u k_i
      float s1 = 0.f, s2 = 0.f;
      for (int q = 0; q < kQ; ++q) s1 = fmaf(V[tid * kLd + q], DY[tid * kLd + q], s1);
      for (int c = 0; c < kQ; ++c) s2 = fmaf(R[tid * kLd + c] * uv[c], K[tid * kLd + c], s2);
      bdot[tid] = s1;
      bonus[tid] = s2;
    }
    // A and dA, strictly below the diagonal
    float acc[4][4];
    zero(acc);
#pragma unroll 2
    for (int c = 0; c < kQ; ++c) {
      float rv[4], cpv[4], kv[4], cv[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        rv[m] = R[(ti + 16 * m) * kLd + c];
        cpv[m] = cp(ti + 16 * m, c);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        kv[n] = K[(tj + 16 * n) * kLd + c];
        cv[n] = CUM[(tj + 16 * n) * kLd + c];
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const bool low = tj + 16 * n < ti + 16 * m;
          const float e = low ? __expf(cpv[m] - cv[n]) : 0.f;
          acc[m][n] = fmaf(rv[m] * kv[n], e, acc[m][n]);
        }
    }
    float dav[4][4];
    zero(dav);
    product(dav, [&](int i, int q) { return DY[i * kLd + q]; },
            [&](int j, int q) { return V[j * kLd + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = ti + 16 * m, j = tj + 16 * n;
        A[i * kLd + j] = acc[m][n];
        DA[i * kLd + j] = j < i ? dav[m][n] : 0.f;
      }
    __syncthreads();
    // drs (rows i, channels c) and dks (rows j, channels c)
    float drs[4][4], dks[4][4];
    zero(drs);
    zero(dks);
    {
      float cpi[4][4], cj[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          cpi[m][n] = cp(ti + 16 * m, tj + 16 * n);
          cj[m][n] = CUM[(ti + 16 * m) * kLd + tj + 16 * n];
        }
#pragma unroll 2
      for (int t = 0; t < kQ; ++t) {
        // drs: t is j (< i); dks: t is i (> j)
        float da_it[4], da_ti[4], kt[4], rt[4], ct[4], cpt[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          da_it[m] = DA[(ti + 16 * m) * kLd + t];
          da_ti[m] = DA[t * kLd + ti + 16 * m];
        }
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = tj + 16 * n;
          kt[n] = K[t * kLd + c];
          rt[n] = R[t * kLd + c];
          ct[n] = CUM[t * kLd + c];
          cpt[n] = cp(t, c);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int i = ti + 16 * m;
            const float e1 = t < i ? __expf(cpi[m][n] - ct[n]) : 0.f;
            const float e2 = t > i ? __expf(cpt[n] - cj[m][n]) : 0.f;
            drs[m][n] = fmaf(e1 * kt[n], da_it[m], drs[m][n]);
            dks[m][n] = fmaf(e2 * rt[n], da_ti[m], dks[m][n]);
          }
      }
      float s0dy[4][4], gv[4][4];
      zero(s0dy);
      zero(gv);
      product(s0dy, [&](int i, int q) { return DY[i * kLd + q]; },
              [&](int c, int q) { return S0[c * kLd + q]; });
      product(gv, [&](int j, int q) { return V[j * kLd + q]; },
              [&](int c, int q) { return G[c * kLd + q]; });
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int c = tj + 16 * n;
          drs[m][n] = fmaf(__expf(cpi[m][n]), s0dy[m][n], drs[m][n]);
          dks[m][n] = fmaf(__expf(CUM[(kQ - 1) * kLd + c] - cj[m][n]), gv[m][n], dks[m][n]);
        }
    }
    __syncthreads();                     // S0 and DA are free
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int i = ti + 16 * m, c = tj + 16 * n;
        const float rr = R[i * kLd + c], kk = K[i * kLd + c];
        S0[i * kLd + c] = rr * drs[m][n];
        DA[i * kLd + c] = kk * dks[m][n];
        if (i < steps && c < p.dkd) {
          const long long at = (base_row + base + i) * p.dkd + c;
          p.dr[at] = __float2bfloat16(fmaf(uv[c] * kk, bdot[i], drs[m][n]));
          p.dk[at] = __float2bfloat16(fmaf(uv[c] * rr, bdot[i], dks[m][n]));
        }
      }
    __syncthreads();
    if (tid < kQ) {                      // dlogw and du of channel tid, in order
      const int c = tid;
      float run = acc_c[c], dus = 0.f;
      for (int i = kQ - 1; i >= 0; --i) {
        run -= DA[i * kLd + c];
        if (i < steps && c < p.dkd) p.dlogw[(base_row + base + i) * p.dkd + c] = run;
        run += S0[i * kLd + c];
        dus = fmaf(R[i * kLd + c] * K[i * kLd + c], bdot[i], dus);
      }
      acc_c[c] = run;
      du_c[c] += dus;
    }
    // dv_j = sum_i A_ij dy_i + bonus_j dy_j + G^T (k_j exp(cum_Q - cum_j))
    zero(acc);
    product(acc, [&](int j, int i) { return A[i * kLd + j]; },
            [&](int q, int i) { return DY[i * kLd + q]; });
    product(acc,
            [&](int j, int c) {
              return K[j * kLd + c] * __expf(CUM[(kQ - 1) * kLd + c] - CUM[j * kLd + c]);
            },
            [&](int q, int c) { return G[c * kLd + q]; });
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int j = ti + 16 * m, q = tj + 16 * n;
        if (j < steps && q < p.dvd)
          p.dv[(base_row + base + j) * p.dvd + q] =
              __float2bfloat16(fmaf(bonus[j], DY[j * kLd + q], acc[m][n]));
      }
    __syncthreads();                     // every read of G is done
    // G <- exp(cum_Q) G + sum_i (r_i exp(cp_i)) dy_i^T
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int c = ti + 16 * m;
        acc[m][n] = __expf(CUM[(kQ - 1) * kLd + c]) * G[c * kLd + tj + 16 * n];
      }
    product(acc, [&](int c, int i) { return R[i * kLd + c] * __expf(cp(i, c)); },
            [&](int q, int i) { return DY[i * kLd + q]; });
    __syncthreads();
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) G[(ti + 16 * m) * kLd + tj + 16 * n] = acc[m][n];
  }
  __syncthreads();
  if (tid < p.dkd) p.du[(long long)row * p.dkd + tid] = du_c[tid];
}

}  // namespace bwd

// The backward of rwkv6_scan.  Inputs as rwkv6_scan's, plus dy [BH, S, dv]
// bf16 and dstate [BH, dk, dv] f32 (null: zero).  Writes dr, dk [BH, S,
// dk] and dv [BH, S, dv] bf16, dlogw [BH, S, dk] and du [BH, dk] f32;
// states is f32 scratch of BH x (ceil(S / 64) + 1) x dk x dv.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                              const void* logw, const void* u, const void* dy,
                              const void* dstate, void* dr, void* dk, void* dv,
                              void* dlogw, void* du, void* states, int rows, int seq,
                              int dkd, int dvd, void* stream) {
  if (dkd < 8 || dkd > kMaxD || dkd % 8 || dvd < 8 || dvd > kMaxD || dvd % 8 || seq < 1 ||
      rows < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        bwd::rwkv6_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bwd::kSmem);
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
  p.states = static_cast<float*>(states);
  p.seq = seq; p.dkd = dkd; p.dvd = dvd;
  p.chunks = (seq + bwd::kQ - 1) / bwd::kQ;
  bwd::rwkv6_bwd_kernel<<<rows, bwd::kThreads, bwd::kSmem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
