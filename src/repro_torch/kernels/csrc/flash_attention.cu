// FlashAttention for Hopper (sm_90a) on wgmma and TMA: bf16 in and out,
// fp32 softmax state and accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _attn_kernel).  Same mask set: causal, sliding window
// ((q - k) < window), logit softcap c * tanh(s / c), keys past kv_len never
// attend, q length != kv length.  Rows that no key may attend give zeros.
//
// On the TPU the kv axis is the innermost, sequential grid axis and the
// running (max, sum, acc) state sits in VMEM scratch between grid steps.
// Here one block owns one (batch, head, 128-row q tile) and loops over
// 128-row kv tiles itself, with the running state in registers.
//
// What bounds it on an H100: at the DBRX prefill shape (q [4,48,512,128],
// kv [4,8,512,128]) the bytes of q, k, v and o (about 59 MB, 17.5 us at
// 3.35 TB/s) and the causal half of the two products (12.9 GFLOP, 13 us at
// 989 TFLOP/s) are close, so the loads must overlap the products and the
// products must run at the wgmma rate.  The design:
//
//   * Warp specialisation.  Warps 0-7 are two consumer warpgroups of 64 q
//     rows each; warps 8-11 are the producer warpgroup, of which one thread
//     issues every load.  setmaxnreg acts on whole warpgroups and moves
//     registers within the block: from 168 a thread at launch (ptxas, 12
//     warps), the producer drops to 24 and the consumers rise to 240
//     (4 x 24 + 8 x 240 = 12 x 168).
//   * Loads.  The producer thread brings Q once and K, V tiles into a
//     two-stage ring with TMA (cp.async.bulk.tensor), each tile in 64-column
//     boxes of 128-byte-swizzled shared memory, completing on mbarriers
//     (full: bytes arrived; empty: all 256 consumer threads are done).  The
//     next tile is in flight while the consumers compute on this one.
//   * S = Q K^T: wgmma m64n128k16 with both operands read from shared memory
//     through descriptors (K-major, 128-byte swizzle).
//   * Online softmax in fp32 registers, in the log2 domain: the score
//     scale folds into one fma with the running max, 2^x is one
//     ex2.approx, and masking compares each key against two per-row
//     bounds on the tiles that straddle an edge.  The softmax, not the
//     products, was the larger share of the time.
//   * O += P V: P goes to bf16 in registers, laid out as wgmma's register A
//     operand; V is the shared-memory B operand, N-major through the
//     descriptor's transpose bit.
//   * Each warpgroup skips tiles that its 64 rows cannot attend (above the
//     causal diagonal, outside the window) and masks only the tiles that
//     straddle an edge.
//   * The grid runs the heaviest causal q tiles first: the q tile is the
//     slowest grid axis, in descending order.
//   * Epilogue: O goes through the warpgroup's own Q rows in shared memory
//     and out with a TMA store, which writes only the rows and columns
//     inside the tensor (ragged q tails, head_dim 112).
//
// q, k, v and o are described to TMA as 4-D tensors (head dim, seq, head,
// batch) with their own strides, so [B, S, H, D] buffers are read and
// written without a transposing copy.  Head dim 112 loads two 64-column
// boxes; TMA zero-fills columns 112-127, which the products never read.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // q rows per block: 64 per consumer warpgroup
constexpr int kBlockN = 128;   // kv rows per tile
constexpr int kStages = 2;     // kv ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int HD>
struct Layout {
  static constexpr int kSub = (HD + 63) / 64;          // 64-column boxes
  static constexpr int kQSub = kBlockM * 128;          // bytes of one box
  static constexpr int kKVSub = kBlockN * 128;
  static constexpr int kQBytes = kSub * kQSub;
  static constexpr int kKVBytes = kSub * kKVSub;       // one K or V tile
  static constexpr int kK = kQBytes;                   // offsets from the base
  static constexpr int kV = kK + kStages * kKVBytes;
  static constexpr int kBars = kV + kStages * kKVBytes;
  static constexpr int kSmem = kBars + 128 + 1024;   // + barriers, alignment slack
};

struct Params {
  int heads, kv_heads, q_len, kv_len, q_tiles;
  float scale_log2;  // scale * log2(e), no softcap
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
  float* lse;            // [B, H, q_len] fp32, or null: not wanted
};

template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 112) wgmma_rs_n112(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, const Params p) {
  using L = Layout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kBars;
  const uint32_t k_full = q_full + 8;                 // [kStages]
  const uint32_t v_full = k_full + 8 * kStages;       // [kStages]
  const uint32_t kv_empty = v_full + 8 * kStages;     // [kStages]

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int qt = p.causal ? p.q_tiles - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * kBlockM;
  const int g = h / (p.heads / p.kv_heads);

  int kv_begin = 0;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBlockM, p.q_len));
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1);
  kv_begin = (kv_begin / kBlockN) * kBlockN;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kBlockN - 1) / kBlockN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kSub; ++c)
        tma_load_4d(base + c * L::kQSub, &q_map, q_full, 64 * c, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int use = it / kStages;
        if (use > 0) mbar_wait(kv_empty + 8 * st, (use - 1) & 1);
        const int k0 = kv_begin + it * kBlockN;
        const uint32_t kd = base + L::kK + st * L::kKVBytes;
        const uint32_t vd = base + L::kV + st * L::kKVBytes;
        mbar_expect_tx(k_full + 8 * st, L::kKVBytes);
        for (int c = 0; c < L::kSub; ++c)
          tma_load_4d(kd + c * L::kKVSub, &k_map, k_full + 8 * st, 64 * c, k0, g, b);
        mbar_expect_tx(v_full + 8 * st, L::kKVBytes);
        for (int c = 0; c < L::kSub; ++c)
          tma_load_4d(vd + c * L::kKVSub, &v_map, v_full + 8 * st, 64 * c, k0, g, b);
      }
    }
  } else {
    // ---------------- consumer warpgroups ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int tw = threadIdx.x % 128;
    const int warp = tw / 32;
    const int lane = tw % 32;
    const int gid = lane / 4;   // accumulator row within the 8-row group
    const int tig = lane % 4;   // accumulator column pair
    const int wrow0 = q0 + 64 * wg;           // this warpgroup's first q row
    const int row0 = wrow0 + 16 * warp + gid;  // this thread's two q rows
    const int row1 = row0 + 8;
    const uint32_t q_base = base + wg * 64 * 128;

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    // keys row r may attend: lo[r] <= c < hi[r]
    int hi[2], lo[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      hi[r] = p.causal ? min(p.kv_len, row + 1) : p.kv_len;
      lo[r] = p.window > 0 ? row - p.window + 1 : 0;
    }
    // scores are kept in their own units (after the softcap); exp2 takes
    // them times `factor`, folded into one fma with the running max
    const float factor = p.softcap > 0.f ? kLog2e : p.scale_log2;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.f, 0.f};   // this thread's columns only; reduced at the end

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint32_t par = (it / kStages) & 1;
      const int k0 = kv_begin + it * kBlockN;
      // waited even for a skipped tile: the k_full phases order this
      // warpgroup's empty arrivals behind the other's
      mbar_wait(k_full + 8 * st, par);
      const bool dead = (p.causal && k0 > wrow0 + 63) ||
                        (p.window > 0 && wrow0 - (k0 + kBlockN - 1) >= p.window);
      if (!dead) {
        const uint32_t kd = base + L::kK + st * L::kKVBytes;
        const uint32_t vd = base + L::kV + st * L::kKVBytes;
        // ---- S = Q K^T ----
        float s[kBlockN / 2];
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) s[i] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          // k-step kk: 64-column box kk / 4, 32 bytes per step inside it
          const uint32_t off = (kk % 4) * 32;
          wgmma_ss_n128(s, desc_sw128(q_base + (kk / 4) * L::kQSub + off, 16),
                        desc_sw128(kd + (kk / 4) * L::kKVSub + off, 16), kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(s);

        // ---- softcap, mask; running max over the 4 threads of a row ----
        if (p.softcap > 0.f) {
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i)
            s[i] = p.softcap * tanhf(s[i] * p.scale / p.softcap);
        }
        if ((k0 + kBlockN > p.kv_len) || (p.causal && k0 + kBlockN - 1 > wrow0) ||
            (p.window > 0 && wrow0 + 63 - k0 >= p.window)) {
#pragma unroll
          for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int c = k0 + n * 8 + tig * 2 + (e & 1);
              const int r = e >> 1;
              s[4 * n + e] = (c >= lo[r] && c < hi[r]) ? s[4 * n + e] : -INFINITY;
            }
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[4 * n + 0], s[4 * n + 1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[4 * n + 2], s[4 * n + 3]));
        }
        float m_use[2], corr[2], neg[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float m_new = fmaxf(m_run[r], mx[r]);
          m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;  // nothing attended yet
          corr[r] = fast_exp2((m_run[r] - m_use[r]) * factor);
          neg[r] = -m_use[r] * factor;
          m_run[r] = m_new;
          l_run[r] *= corr[r];
        }
        uint32_t pa[kBlockN / 16][4];
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
          const float p0 = fast_exp2(fmaf(s[4 * n + 0], factor, neg[0]));
          const float p1 = fast_exp2(fmaf(s[4 * n + 1], factor, neg[0]));
          const float p2 = fast_exp2(fmaf(s[4 * n + 2], factor, neg[1]));
          const float p3 = fast_exp2(fmaf(s[4 * n + 3], factor, neg[1]));
          l_run[0] += p0 + p1;
          l_run[1] += p2 + p3;
          // n-tiles (2j, 2j+1) of S are the register A operand of k-step j
          pa[n / 2][(n % 2) * 2 + 0] = pack_bf16x2(p0, p1);
          pa[n / 2][(n % 2) * 2 + 1] = pack_bf16x2(p2, p3);
        }
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[4 * n + 0] *= corr[0];
          o[4 * n + 1] *= corr[0];
          o[4 * n + 2] *= corr[1];
          o[4 * n + 3] *= corr[1];
        }

        // ---- O += P V ----
        mbar_wait(v_full + 8 * st, par);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBlockN / 16; ++j)
          pv_product<HD>(o, pa[j], desc_sw128(vd + j * 16 * 128, L::kKVSub));
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(o);
      }
      mbar_arrive(kv_empty + 8 * st);
    }

    // ---- epilogue: normalise, stage through this warpgroup's Q rows, TMA store ----
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[r] = l > 0.f ? 1.f / l : 0.f;
      // the row's log-sum-exp of its scores (natural log, after scale and
      // softcap), which the backward recomputes P from; +inf where no key
      // may attend, so that P is 0 there
      const int row = r ? row1 : row0;
      if (p.lse != nullptr && tig == 0 && row < p.q_len)
        p.lse[((long long)b * p.heads + h) * p.q_len + row] =
            l > 0.f ? m_run[r] * factor * kLn2 + logf(l) : INFINITY;
    }
    const int rl = 16 * warp + gid;   // local row; rl % 8 == gid
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      unsigned char* sub = smem + (n / 8) * L::kQSub + wg * 64 * 128;
      const int chunk = ((n % 8) ^ gid) * 16 + tig * 4;
      *reinterpret_cast<uint32_t*>(sub + rl * 128 + chunk) =
          pack_bf16x2(o[4 * n + 0] * inv[0], o[4 * n + 1] * inv[0]);
      *reinterpret_cast<uint32_t*>(sub + (rl + 8) * 128 + chunk) =
          pack_bf16x2(o[4 * n + 2] * inv[1], o[4 * n + 3] * inv[1]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tw == 0 && wrow0 < p.q_len) {
      for (int c = 0; c < L::kSub; ++c)
        tma_store_4d(&o_map, q_base + c * L::kQSub, 64 * c, wrow0, h, b);
      tma_store_commit_and_wait();
    }
  }
}

// cuTensorMapEncodeTiled (libcuda), looked up once through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &status);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &status);
#endif
    if (err == cudaSuccess && status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A [B, H, S, D] bf16 view given by element strides (batch, head, seq) as a
// 4-D tensor map (D, S, H, B) with boxes of 64 columns x `rows` rows.
bool make_map(CUtensorMap* map, const void* ptr, int batch, int heads, int seq, int hd,
              long long sb, long long sh, long long ss, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                   const CUtensorMap& om, const Params& p, int batch,
                   cudaStream_t stream) {
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           Layout<HD>::kSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid(p.heads, batch, p.q_tiles);
  flash_attention_kernel<HD><<<grid, kThreads, Layout<HD>::kSmem, stream>>>(qm, km, vm,
                                                                             om, p);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Sq, D], k/v [B, G, Sk, D], o [B, H, Sq, D], bf16, each given by
// element strides (batch, head, seq) with a contiguous head dimension D in
// {64, 112, 128}; every stride a multiple of 8 elements and every base
// 16-byte aligned.  window <= 0 and softcap <= 0 mean none.  lse, when not
// null, receives each row's log-sum-exp [B, H, Sq] fp32 (for the backward).
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int head_dim,
    float scale, float softcap, int causal, int window, void* lse, void* stream) {
  if (head_dim != 64 && head_dim != 112 && head_dim != 128)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, batch, heads, q_len, head_dim, q_sb, q_sh, q_ss, kBlockM) ||
      !make_map(&km, k, batch, kv_heads, kv_len, head_dim, k_sb, k_sh, k_ss, kBlockN) ||
      !make_map(&vm, v, batch, kv_heads, kv_len, head_dim, v_sb, v_sh, v_ss, kBlockN) ||
      !make_map(&om, o, batch, heads, q_len, head_dim, o_sb, o_sh, o_ss, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.heads = heads; p.kv_heads = kv_heads; p.q_len = q_len; p.kv_len = kv_len;
  p.q_tiles = (q_len + kBlockM - 1) / kBlockM;
  p.scale = scale; p.scale_log2 = scale * kLog2e; p.softcap = softcap;
  p.causal = causal; p.window = window;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128) err = launch<128>(qm, km, vm, om, p, batch, s);
  else if (head_dim == 112) err = launch<112>(qm, km, vm, om, p, batch, s);
  else err = launch<64>(qm, km, vm, om, p, batch, s);
  return static_cast<int>(err);
}

// ===========================================================================
// The backward (FlashAttention-2's), for training.
//
// Replaces the gradient that JAX takes through the reference's attention
// (src/repro/kernels/flash_attention.py:112 and its jnp twin); the TPU
// kernel has no backward of its own.  From q, k, v, the forward's output o
// and its per-row log-sum-exp, and the output gradient do:
//
//   P  = exp(s - lse)       s = scale * q k^T (then softcap * tanh(s / softcap))
//   dV = P^T do             dP = do v^T,  delta = rowsum(do * o)
//   dS = P * (dP - delta) * ds/d(qk^T)   (the chain rule through the softcap)
//   dQ = dS k               dK = dS^T q
//
// Three launches: delta (one warp a row), then dK and dV with one block per
// (batch, kv head, 64-row kv tile), which loops over 32-row q steps and the
// rep = H / G q heads of its kv head and keeps dK and dV in fp32 registers:
// summing over the q heads inside the block is what keeps GQA free of
// atomics; then dQ with one block per (batch, q head, 64-row q tile), which
// loops over 32-row kv steps.  P and dS are recomputed in each pass, so
// nothing [S, T]-sized is written.  Every sum runs in one fixed order: the
// result is the same bits from run to run.
//
// The products run on the tensor cores as mma.sync m16n8k16 (bf16 in, fp32
// accumulate), fragments loaded with ldmatrix from bf16 tiles in shared
// memory whose rows are padded by 16 bytes (8 rows of one ldmatrix fall on
// distinct banks).  Each of a block's 4 warps owns 16 rows: in the dK/dV
// pass 16 kv rows, computing S^T = K Q^T and dP^T = V dO^T for them against
// 32 q rows a step, then P^T and dS^T in registers, which are repacked as
// the A operands of dV += P^T dO and dK += dS^T Q (bf16, as
// FlashAttention-2 rounds them); in the dQ pass 16 q rows against 32 kv
// rows a step.  What bounds it: the products (about 2.5 times the
// forward's), on mma.sync rather than wgmma, with no overlap of a step's
// loads and its products; wgmma and TMA are later work.
// ===========================================================================

namespace {

using namespace sm90;

constexpr int kBwdThreads = 128;   // 4 warps, 16 rows each
constexpr int kKvTile = 64;        // kv rows of a dK/dV block
constexpr int kQStep = 32;         // q rows of one of its steps
constexpr int kQTile = 64;         // q rows of a dQ block
constexpr int kKvStep = 32;        // kv rows of one of its steps

struct BwdParams {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  __nv_bfloat16 *dq, *dk, *dv;
  long long qs[3], ks[3], vs[3], dos[3], dqs[3], dks[3], dvs[3];  // batch, head, seq
  int heads, kv_heads, q_len, kv_len;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
};

template <int HD>
struct BwdLayout {
  static constexpr int kLd = HD + 8;      // bf16 row stride: 16-byte rows
  static constexpr int kDkdvBytes = (2 * kKvTile + 2 * kQStep) * kLd * 2 + 2 * kQStep * 4;
  static constexpr int kDqBytes = (2 * kQTile + 2 * kKvStep) * kLd * 2 + 2 * kQTile * 4;
};

// rows [row0, row0 + rows) of a [len, HD] bf16 matrix with row stride `ld`
// (a multiple of 8 elements, 16-byte aligned) into a padded bf16 tile, 16
// bytes a load; rows past `len` are zeros
template <int HD>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int row0, int rows, int len) {
  constexpr int kVecs = HD / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += kBwdThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < len)
      v = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * ld + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + 8) + c) = v;
  }
}

__device__ __forceinline__ void load_row_stats(const BwdParams& p, float* lse, float* delta,
                                               int b, int hq, int q0, int rows) {
  if (threadIdx.x < rows) {
    const int r = q0 + threadIdx.x;
    const long long at = ((long long)b * p.heads + hq) * p.q_len + r;
    lse[threadIdx.x] = r < p.q_len ? p.lse[at] : INFINITY;
    delta[threadIdx.x] = r < p.q_len ? p.delta[at] : 0.f;
  }
}

// byte offsets, within a padded tile, of this lane's ldmatrix row address:
// an A operand (16 rows x 16 k from a [row][k] tile at row r0, k k0), the B
// operands of two n-tiles from an [n][k] tile (non-transposed: r[0], r[1]
// the first n-tile's k halves, r[2], r[3] the second's), and from a [k][n]
// tile (transposed, the same order)
template <int HD>
__device__ __forceinline__ uint32_t a_off(int lane, int r0, int k0) {
  return ((r0 + (lane & 15)) * (HD + 8) + k0 + (lane >> 4) * 8) * 2;
}
template <int HD>
__device__ __forceinline__ uint32_t b_off(int lane, int n0, int k0) {
  return ((n0 + (lane & 7) + ((lane >> 4) << 3)) * (HD + 8) + k0 + ((lane >> 3) & 1) * 8) * 2;
}
template <int HD>
__device__ __forceinline__ uint32_t bt_off(int lane, int k0, int n0) {
  return ((k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * (HD + 8) + n0 + ((lane >> 4) << 3)) * 2;
}

// P and dS of one score from its raw product s = q.k and dp = do.v; q row
// rg, key cg (absolute), the row's log-sum-exp and delta
__device__ __forceinline__ void grad_score(const BwdParams& p, float s, float dp, float lse,
                                           float delta, int rg, int cg, float& pr, float& ds) {
  const bool ok = rg < p.q_len && cg < p.kv_len && (!p.causal || cg <= rg) &&
                  (p.window <= 0 || rg - cg < p.window);
  float x = s * p.scale;
  float dx = p.scale;   // d(score) / d(q.k)
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = p.softcap * t;
    dx = p.scale * (1.f - t * t);
  }
  pr = ok ? expf(x - lse) : 0.f;
  ds = pr * (dp - delta) * dx;
}

// the A operand of k-step j from the C fragments of n-tiles 2j and 2j + 1
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16x2(c0[0], c0[1]);
  a[1] = pack_bf16x2(c0[2], c0[3]);
  a[2] = pack_bf16x2(c1[0], c1[1]);
  a[3] = pack_bf16x2(c1[2], c1[3]);
}

__global__ void __launch_bounds__(256)
attn_bwd_delta_kernel(const __nv_bfloat16* __restrict__ o,
                      const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                      long long osb, long long osh, long long oss, long long dsb,
                      long long dsh, long long dss, int heads, int q_len, int hd,
                      long long rows) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = (int)(row % q_len);
  const long long bh = row / q_len;
  const int h = (int)(bh % heads);
  const int b = (int)(bh / heads);
  const __nv_bfloat16* orow = o + b * osb + h * osh + s * oss;
  const __nv_bfloat16* drow = dout + b * dsb + h * dsh + s * dss;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(__bfloat162float(orow[d]), __bfloat162float(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads) attn_bwd_dkdv_kernel(const BwdParams p) {
  constexpr int kLd = BwdLayout<HD>::kLd;
  constexpr int KT = HD / 16;   // k-steps over the head dim
  constexpr int NT = HD / 8;    // n-tiles over the head dim
  constexpr int QN = kQStep / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kKvTile * kLd;
  __nv_bfloat16* qs = vs + kKvTile * kLd;
  __nv_bfloat16* dos = qs + kQStep * kLd;
  float* lse = reinterpret_cast<float*>(dos + kQStep * kLd);
  float* delta = lse + kQStep;

  const int k0 = blockIdx.x * kKvTile;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rep = p.heads / p.kv_heads;
  load_rows<HD>(ks, p.k + b * p.ks[0] + g * p.ks[1], p.ks[2], k0, kKvTile, p.kv_len);
  load_rows<HD>(vs, p.v + b * p.vs[0] + g * p.vs[1], p.vs[2], k0, kKvTile, p.kv_len);
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs);
  const uint32_t qs_a = smem_addr(qs), dos_a = smem_addr(dos);

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the q rows that may attend a key of this tile
  const int q_begin = p.causal ? k0 : 0;
  const int q_end = p.window > 0 ? min(p.q_len, k0 + kKvTile - 1 + p.window) : p.q_len;
  const int t_begin = q_begin / kQStep;
  const int t_end = q_end > q_begin ? (q_end + kQStep - 1) / kQStep : t_begin;
  for (int hq = g * rep; hq < (g + 1) * rep; ++hq) {
    for (int t = t_begin; t < t_end; ++t) {
      const int q0 = t * kQStep;
      __syncthreads();   // the last step's readers are done with qs, dos and the stats
      load_rows<HD>(qs, p.q + b * p.qs[0] + hq * p.qs[1], p.qs[2], q0, kQStep, p.q_len);
      load_rows<HD>(dos, p.dout + b * p.dos[0] + hq * p.dos[1], p.dos[2], q0, kQStep, p.q_len);
      load_row_stats(p, lse, delta, b, hq, q0, kQStep);
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T for this warp's 16 kv rows
      float s[QN][4], dp[QN][4];
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4], av[4];
        ldmatrix_x4(a, ks_a + a_off<HD>(lane, 16 * warp, 16 * kk));
        ldmatrix_x4(av, vs_a + a_off<HD>(lane, 16 * warp, 16 * kk));
#pragma unroll
        for (int np = 0; np < QN / 2; ++np) {
          uint32_t bq[4], bd[4];
          ldmatrix_x4(bq, qs_a + b_off<HD>(lane, 16 * np, 16 * kk));
          ldmatrix_x4(bd, dos_a + b_off<HD>(lane, 16 * np, 16 * kk));
          mma_m16n8k16(s[2 * np], a, bq[0], bq[1]);
          mma_m16n8k16(s[2 * np + 1], a, bq[2], bq[3]);
          mma_m16n8k16(dp[2 * np], av, bd[0], bd[1]);
          mma_m16n8k16(dp[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // P^T into s, dS^T into dp: element e of n-tile n is kv row
      // k0 + 16 warp + gid (+ 8), q row q0 + 8 n + 2 tig (+ 1)
#pragma unroll
      for (int n = 0; n < QN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = 8 * n + 2 * tig + (e & 1);
          grad_score(p, s[n][e], dp[n][e], lse[qi], delta[qi], q0 + qi,
                     k0 + 16 * warp + gid + 8 * (e >> 1), s[n][e], dp[n][e]);
        }
      // dV += P^T dO, dK += dS^T Q over the step's q rows
#pragma unroll
      for (int kq = 0; kq < kQStep / 16; ++kq) {
        uint32_t pa[4], sa[4];
        c_to_a(pa, s[2 * kq], s[2 * kq + 1]);
        c_to_a(sa, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
        for (int nd = 0; nd < NT / 2; ++nd) {
          uint32_t bo[4], bq[4];
          ldmatrix_x4_trans(bo, dos_a + bt_off<HD>(lane, 16 * kq, 16 * nd));
          ldmatrix_x4_trans(bq, qs_a + bt_off<HD>(lane, 16 * kq, 16 * nd));
          mma_m16n8k16(dv[2 * nd], pa, bo[0], bo[1]);
          mma_m16n8k16(dv[2 * nd + 1], pa, bo[2], bo[3]);
          mma_m16n8k16(dk[2 * nd], sa, bq[0], bq[1]);
          mma_m16n8k16(dk[2 * nd + 1], sa, bq[2], bq[3]);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = k0 + 16 * warp + gid + 8 * h;
    if (row >= p.kv_len) continue;
    __nv_bfloat16* dkr = p.dk + b * p.dks[0] + g * p.dks[1] + row * p.dks[2];
    __nv_bfloat16* dvr = p.dv + b * p.dvs[0] + g * p.dvs[1] + row * p.dvs[2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      *reinterpret_cast<uint32_t*>(dkr + 8 * n + 2 * tig) =
          pack_bf16x2(dk[n][2 * h], dk[n][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dvr + 8 * n + 2 * tig) =
          pack_bf16x2(dv[n][2 * h], dv[n][2 * h + 1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads) attn_bwd_dq_kernel(const BwdParams p) {
  constexpr int kLd = BwdLayout<HD>::kLd;
  constexpr int KT = HD / 16;
  constexpr int NT = HD / 8;
  constexpr int KN = kKvStep / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* dos = qs + kQTile * kLd;
  __nv_bfloat16* ks = dos + kQTile * kLd;
  __nv_bfloat16* vs = ks + kKvStep * kLd;
  float* lse = reinterpret_cast<float*>(vs + kKvStep * kLd);
  float* delta = lse + kQTile;

  const int q0 = blockIdx.x * kQTile;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int g = hq / (p.heads / p.kv_heads);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  load_rows<HD>(qs, p.q + b * p.qs[0] + hq * p.qs[1], p.qs[2], q0, kQTile, p.q_len);
  load_rows<HD>(dos, p.dout + b * p.dos[0] + hq * p.dos[1], p.dos[2], q0, kQTile, p.q_len);
  load_row_stats(p, lse, delta, b, hq, q0, kQTile);
  const uint32_t ks_a = smem_addr(ks), vs_a = smem_addr(vs);
  const uint32_t qs_a = smem_addr(qs), dos_a = smem_addr(dos);

  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  // the keys this tile's rows may attend
  const int kv_end = p.causal ? min(p.kv_len, q0 + kQTile) : p.kv_len;
  const int kv_begin = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int t_begin = kv_begin / kKvStep;
  const int t_end = kv_end > kv_begin ? (kv_end + kKvStep - 1) / kKvStep : t_begin;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kKvStep;
    __syncthreads();   // the last step's readers are done with ks and vs
    load_rows<HD>(ks, p.k + b * p.ks[0] + g * p.ks[1], p.ks[2], k0, kKvStep, p.kv_len);
    load_rows<HD>(vs, p.v + b * p.vs[0] + g * p.vs[1], p.vs[2], k0, kKvStep, p.kv_len);
    __syncthreads();
    // S = Q K^T and dP = dO V^T for this warp's 16 q rows
    float s[KN][4], dp[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t a[4], ad[4];
      ldmatrix_x4(a, qs_a + a_off<HD>(lane, 16 * warp, 16 * kk));
      ldmatrix_x4(ad, dos_a + a_off<HD>(lane, 16 * warp, 16 * kk));
#pragma unroll
      for (int np = 0; np < KN / 2; ++np) {
        uint32_t bk[4], bv[4];
        ldmatrix_x4(bk, ks_a + b_off<HD>(lane, 16 * np, 16 * kk));
        ldmatrix_x4(bv, vs_a + b_off<HD>(lane, 16 * np, 16 * kk));
        mma_m16n8k16(s[2 * np], a, bk[0], bk[1]);
        mma_m16n8k16(s[2 * np + 1], a, bk[2], bk[3]);
        mma_m16n8k16(dp[2 * np], ad, bv[0], bv[1]);
        mma_m16n8k16(dp[2 * np + 1], ad, bv[2], bv[3]);
      }
    }
    // dS into dp: element e of n-tile n is q row q0 + 16 warp + gid (+ 8),
    // key k0 + 8 n + 2 tig (+ 1)
#pragma unroll
    for (int n = 0; n < KN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = 16 * warp + gid + 8 * (e >> 1);
        float pr;   // P itself is not needed here
        grad_score(p, s[n][e], dp[n][e], lse[qi], delta[qi], q0 + qi,
                   k0 + 8 * n + 2 * tig + (e & 1), pr, dp[n][e]);
      }
    // dQ += dS K over the step's keys
#pragma unroll
    for (int kq = 0; kq < kKvStep / 16; ++kq) {
      uint32_t sa[4];
      c_to_a(sa, dp[2 * kq], dp[2 * kq + 1]);
#pragma unroll
      for (int nd = 0; nd < NT / 2; ++nd) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, ks_a + bt_off<HD>(lane, 16 * kq, 16 * nd));
        mma_m16n8k16(dq[2 * nd], sa, bk[0], bk[1]);
        mma_m16n8k16(dq[2 * nd + 1], sa, bk[2], bk[3]);
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + 16 * warp + gid + 8 * h;
    if (row >= p.q_len) continue;
    __nv_bfloat16* dqr = p.dq + b * p.dqs[0] + hq * p.dqs[1] + row * p.dqs[2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(dqr + 8 * n + 2 * tig) =
          pack_bf16x2(dq[n][2 * h], dq[n][2 * h + 1]);
  }
}

template <int HD>
cudaError_t launch_bwd(const BwdParams& p, int batch, cudaStream_t stream) {
  using L = BwdLayout<HD>;
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::kDkdvBytes);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dq_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::kDqBytes);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 kv_grid((p.kv_len + kKvTile - 1) / kKvTile, p.kv_heads, batch);
  attn_bwd_dkdv_kernel<HD><<<kv_grid, kBwdThreads, L::kDkdvBytes, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((p.q_len + kQTile - 1) / kQTile, p.heads, batch);
  attn_bwd_dq_kernel<HD><<<q_grid, kBwdThreads, L::kDqBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// The backward of flash_attention.  q, dq [B, H, Sq, D]; k, v, dk, dv
// [B, G, Sk, D]; o, dout [B, H, Sq, D]; all bf16 with a contiguous head
// dimension, given by element strides (batch, head, seq): strides[24] holds
// those of q, k, v, o, dout, dq, dk, dv in that order.  lse [B, H, Sq] fp32
// from the forward; delta [B, H, Sq] fp32 scratch.  D in {64, 112, 128}.
// Three launches on `stream`; returns cudaGetLastError() after the last.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, const long long* strides,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int head_dim, float scale,
    float softcap, int causal, int window, void* stream) {
  if ((head_dim != 64 && head_dim != 112 && head_dim != 128) || batch < 1 || q_len < 1 ||
      kv_len < 1 || kv_heads < 1 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long rows = (long long)batch * heads * q_len;
  attn_bwd_delta_kernel<<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<float*>(delta), strides[9], strides[10], strides[11], strides[12],
      strides[13], strides[14], heads, q_len, head_dim, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  long long* dsts[7] = {p.qs, p.ks, p.vs, p.dos, p.dqs, p.dks, p.dvs};
  const int srcs[7] = {0, 1, 2, 4, 5, 6, 7};   // skip o's (3): delta read it
  for (int t = 0; t < 7; ++t)
    for (int i = 0; i < 3; ++i) dsts[t][i] = strides[3 * srcs[t] + i];
  p.heads = heads; p.kv_heads = kv_heads; p.q_len = q_len; p.kv_len = kv_len;
  p.scale = scale; p.softcap = softcap; p.causal = causal; p.window = window;
  if (head_dim == 128) err = launch_bwd<128>(p, batch, st);
  else if (head_dim == 112) err = launch_bwd<112>(p, batch, st);
  else err = launch_bwd<64>(p, batch, st);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
