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
// 16-byte aligned.  window <= 0 and softcap <= 0 mean none.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int head_dim,
    float scale, float softcap, int causal, int window, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128) err = launch<128>(qm, km, vm, om, p, batch, s);
  else if (head_dim == 112) err = launch<112>(qm, km, vm, om, p, batch, s);
  else err = launch<64>(qm, km, vm, om, p, batch, s);
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
