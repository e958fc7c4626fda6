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
//
// Head dim 256 (Gemma2, compute-bound at its 8,192 tokens: the products
// outweigh the bytes about 9 to 1) keeps this design with 64-row kv tiles
// (kv_rows): Q's 64 KB and two stages of K and V at 32 KB each make 192
// KB of shared memory, and a thread's 128 fp32 accumulators, 32 scores and
// 16 P fragments fit its 240 registers.  S = Q K^T is m64n64k16 over 16
// k-steps, O += P V one m64n256k16 (register A) a 16-row k-step.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBlockM = 128;   // q rows per block: 64 per consumer warpgroup
constexpr int kStages = 2;     // kv ring depth
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// kv rows per tile: 128, or 64 at head_dim 256, where 128-row K and V
// tiles in two stages (256 KB) and Q (64 KB) would not fit the 227 KB a
// block may have, and a 64 x 128 score tile beside the 128 fp32
// accumulators a thread would not fit 240 registers
constexpr int kv_rows(int hd) { return hd > 128 ? 64 : 128; }

template <int HD>
struct Layout {
  static constexpr int kBlockN = kv_rows(HD);
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
  float cap_log2;    // 2 * log2(e) * scale / softcap: tanh's exp2 argument
  int causal, window;    // window <= 0: none
  float* lse;            // [B, H, q_len] fp32, or null: not wanted
};

// O += P V for one 16-row k-step of V at shared address `vd` (its
// 64-column boxes kKVSub bytes apart, read N-major through the transpose bit)
template <int HD>
__device__ __forceinline__ void pv_product(float (&o)[HD / 2], const uint32_t (&a)[4],
                                           uint32_t vd) {
  const uint64_t db = desc_sw128(vd, Layout<HD>::kKVSub);
  if constexpr (HD == 64) wgmma_rs_n64(o, a, db);
  else if constexpr (HD == 112) wgmma_rs_n112(o, a, db);
  else if constexpr (HD == 128) wgmma_rs_n128(o, a, db);
  else wgmma_rs_n256(o, a, db);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap o_map, const Params p) {
  using L = Layout<HD>;
  constexpr int kBlockN = L::kBlockN;
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
          const uint64_t da = desc_sw128(q_base + (kk / 4) * L::kQSub + off, 16);
          const uint64_t dk = desc_sw128(kd + (kk / 4) * L::kKVSub + off, 16);
          if constexpr (kBlockN == 128) wgmma_ss_n128(s, da, dk, kk > 0);
          else wgmma_ss_n64(s, da, dk, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_operands(s);

        // ---- softcap, mask; running max over the 4 threads of a row ----
        // c tanh(x / c) = c - 2c / (e^(2x/c) + 1): one ex2 and one
        // approximate reciprocal an element, absolute error about 1e-5 of
        // the score (libm's tanhf and a division an element made the
        // softmax, not the products, the bound at head_dim 256)
        if (p.softcap > 0.f) {
          const float two_cap = 2.f * p.softcap;
#pragma unroll
          for (int i = 0; i < kBlockN / 2; ++i)
            s[i] = p.softcap - __fdividef(two_cap, fast_exp2(s[i] * p.cap_log2) + 1.f);
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
          pv_product<HD>(o, pa[j], vd + j * 16 * 128);
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

// The tensors' device made current on the calling thread for the life of
// an entry's call, and the thread's device before it put back afterwards:
// the tensor maps' encoder needs the device's context, and a thread of
// PyTorch's autograd engine (a backward, or a forward recomputed under a
// checkpoint) may hold none before its first kernel.
class DeviceBind {
 public:
  explicit DeviceBind(int device) {
    if (cudaGetDevice(&before_) != cudaSuccess) before_ = -1;
    status_ = cudaSetDevice(device);
    restore_ = before_ >= 0 && before_ != device;
  }
  ~DeviceBind() {
    if (restore_) cudaSetDevice(before_);
  }
  cudaError_t status() const { return status_; }

 private:
  int before_ = -1;
  bool restore_ = false;
  cudaError_t status_;
};

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
// {64, 112, 128, 256}; every stride a multiple of 8 elements and every base
// 16-byte aligned.  window <= 0 and softcap <= 0 mean none.  lse, when not
// null, receives each row's log-sum-exp [B, H, Sq] fp32 (for the backward).
// `device`: the CUDA device of the tensors, current for the call (DeviceBind).
// Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int head_dim,
    float scale, float softcap, int causal, int window, void* lse, int device,
    void* stream) {
  if (head_dim != 64 && head_dim != 112 && head_dim != 128 && head_dim != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceBind bind(device);
  if (bind.status() != cudaSuccess) return static_cast<int>(bind.status());
  const int kv_tile = kv_rows(head_dim);
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, batch, heads, q_len, head_dim, q_sb, q_sh, q_ss, kBlockM) ||
      !make_map(&km, k, batch, kv_heads, kv_len, head_dim, k_sb, k_sh, k_ss, kv_tile) ||
      !make_map(&vm, v, batch, kv_heads, kv_len, head_dim, v_sb, v_sh, v_ss, kv_tile) ||
      !make_map(&om, o, batch, heads, q_len, head_dim, o_sb, o_sh, o_ss, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.heads = heads; p.kv_heads = kv_heads; p.q_len = q_len; p.kv_len = kv_len;
  p.q_tiles = (q_len + kBlockM - 1) / kBlockM;
  p.scale = scale; p.scale_log2 = scale * kLog2e; p.softcap = softcap;
  p.cap_log2 = softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f;
  p.causal = causal; p.window = window;
  p.lse = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 256) err = launch<256>(qm, km, vm, om, p, batch, s);
  else if (head_dim == 128) err = launch<128>(qm, km, vm, om, p, batch, s);
  else if (head_dim == 112) err = launch<112>(qm, km, vm, om, p, batch, s);
  else err = launch<64>(qm, km, vm, om, p, batch, s);
  return static_cast<int>(err);
}

// ===========================================================================
// The backward, for training: FlashAttention's, in two passes on wgmma and
// TMA, each shaped like the forward above.
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
// What bounds it on an H100: at DBRX's shape (q [4, 48, 512, 128], kv
// [4, 8, 512, 128], causal) the five products of the causal pairs are 32.3
// GFLOP, 0.033 ms at 989 TFLOP/s, and q, o, do, dq, k, v, dk, dv and lse
// are 117.8 MB, 0.035 ms at 3.35 TB/s: both bounds are close, so the
// products must run at the wgmma rate with the loads behind them.  The
// design, against each thing that held the first (mma.sync) version back:
//
//   * wgmma, not mma.sync.  Every product is a warpgroup's m64 wgmma: the
//     score-shaped ones (S = Q K^T, dP = dO V^T and their transposes) with
//     both operands K-major in shared memory, the others (dQ += dS K,
//     dV += P^T dO, dK += dS^T Q) with the bf16 probabilities or score
//     gradients repacked from the C fragments as the register A operand and
//     the B operand N-major through the descriptor's transpose bit, as the
//     forward's O += P V.
//   * Loads behind the products.  In each pass a producer warpgroup (one
//     thread a ring) keeps TMA loads of the next 64-row tiles in flight in
//     two-stage rings of 128-byte-swizzled tiles on mbarriers, while two
//     consumer warpgroups compute; setmaxnreg gives the producer 40
//     registers a thread and the consumers 232.  The dQ pass is persistent,
//     one block an SM: Q and dO come into two slots, so the next work
//     item's load runs under this one's products, and a warpgroup issues a
//     tile's dQ product and goes on to the next tile's S and dP without
//     waiting.  (The dK/dV pass waits: dK, dV, S^T and dP^T take 192
//     registers a thread, and keeping the A operands alive as well made
//     ptxas serialise its wgmmas.)
//   * An even causal schedule.  dK/dV blocks are (batch, kv head, pair of
//     64-row kv tiles): under a causal mask tile i is walked with tile
//     n - 1 - i, so every block has n + 1 q steps a q head.  The block's
//     two consumer warpgroups split each tile's list of (q head, q step)
//     in halves and sum their fp32 partials of dK and dV in shared memory,
//     always the second into the first: at DBRX's shape 128 blocks of two
//     warpgroups, each (8 + 1) x 6 / 2 = 27 q steps (the first version's
//     heaviest block: 96).  flash_attention_bwd_record has each warpgroup
//     write the q steps it walked and the cycles it took, so that the
//     balance is read from the blocks that ran.
//   * Seven products.  Each pass computes the two score-shaped products
//     and the one or two it writes: the dQ pass S, dP and dQ, the dK/dV
//     pass S^T, dP^T, dV and dK, 45.2 GFLOP at DBRX's shape against the
//     bound's 32.3.  A single pass summing dQ in a fixed order would need
//     five; that is later work.
//   * Score math in the log2 domain, specialised.  P = 2^(s scale log2(e)
//     - lse log2(e)) is one fma and one ex2.approx.  The softcap and the
//     mask test are template arguments of the step's score math, chosen
//     by one branch a step: the mask is tested only on steps that straddle
//     an edge, and tanh runs only under a softcap.  (Tested per score in
//     the unrolled loop, as the first version did, the softcap test is
//     if-converted and every score pays for tanhf.)
//   * No separate delta launch.  The dQ pass's prologue computes each of
//     its rows' delta from dO in shared memory (already loaded for dP) and
//     o, and writes lse log2(e) and delta, padded to 64-row steps, into
//     the stats scratch that the dK/dV pass loads with one bulk copy each a
//     step.
//
// Two launches, the dQ pass first (its prologue writes the stats).  Every
// sum runs in one fixed order and no atomics are used: the result is the
// same bits from run to run.  dQ leaves through shared memory and a TMA
// store (only rows inside the tensor); dK and dV, summed in registers, are
// written by their warpgroup directly.
// ===========================================================================

namespace {

using namespace sm90;

constexpr int kBwdRows = 64;     // rows of every backward tile and step
constexpr int kBox = 64 * 128;   // bytes of one 64-row x 64-column box
constexpr int kQStages = 2;      // dQ pass: kv ring depth
constexpr int kKVStages = 2;     // dK/dV pass: q ring depth, per warpgroup
constexpr int kMaxDevices = 64;

struct BwdParams {
  int batch, heads, kv_heads, q_len, kv_len, q_tiles, kv_tiles, q_pad;
  int dq_items;                      // batch x heads x q_tiles
  int kv_pairs;                      // dK/dV blocks a (batch, kv head)
  float scale, scale_log2, softcap;  // softcap <= 0: none
  int causal, window;                // window <= 0: none
  const float* lse;                  // [B, H, q_len]
  float* stats;   // [2, B, H, q_pad]: lse log2(e) (+inf past q_len), delta
  long long stats_half;              // B H q_pad: where delta starts
  const __nv_bfloat16* o;
  __nv_bfloat16 *dk, *dv;
  long long os[3], dks[3], dvs[3];   // element strides (batch, head, seq)
  // when not null: per dK/dV block and consumer warpgroup, the q steps it
  // walked and the SM clock cycles it took, [blocks][2][2]
  long long* record;
};

template <int HD>
struct BwdLayout {
  static constexpr int kSub = (HD + 63) / 64;
  static constexpr int kTile = kSub * kBox;          // one 64-row tile
  // dQ pass: two slots of Q and dO (both warpgroups' rows), then the K and
  // V rings
  static constexpr int kQSlot = 4 * kTile;
  static constexpr int kQK = 2 * kQSlot;
  static constexpr int kQV = kQK + kQStages * kTile;
  static constexpr int kQBars = kQV + kQStages * kTile;
  static constexpr int kQDelta = kQBars + 128;       // fp32 [128]
  static constexpr int kQSmem = kQDelta + 512 + 1024;
  // dK/dV pass: K, V, each warpgroup's ring of (Q, dO), the exchange of
  // fp32 partials, each stage's lse log2(e) and delta, the barriers
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = 2 * kTile;
  static constexpr int kX = kRing + 2 * kKVStages * kStage;
  static constexpr int kXBytes = 128 * (HD / 2) * 4;
  static constexpr int kStats = kX + kXBytes;        // [2][kKVStages][2][64] fp32
  static constexpr int kKVBars = kStats + 2 * kKVStages * 512;
  static constexpr int kKVSmem = kKVBars + 128 + 1024;
};

template <int HD>
__device__ __forceinline__ void rs_product(float (&d)[HD / 2], const uint32_t (&a)[4],
                                           uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (HD == 112) wgmma_rs_n112(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// d[32] (+)= A B^T over the head dim, A and B 64-row tiles of kSub boxes
// (K-major, 128-byte swizzle) at shared addresses a and b
template <int HD>
__device__ __forceinline__ void score_product(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n64(d, desc_sw128(a + off, 16), desc_sw128(b + off, 16), kk > 0);
  }
}

// d[HD / 2] += A B over 64 rows of k, A from registers (four k-steps of
// 16), B a 64-row tile of kSub boxes at shared address b, N-major
template <int HD>
__device__ __forceinline__ void value_product(float (&d)[HD / 2], const uint32_t (&a)[4][4],
                                              uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j) rs_product<HD>(d, a[j], desc_sw128(b + j * 16 * 128, kBox));
}

// P and its gradient dS for one score: raw product x = q.k, dp = do.v, the
// row's lse log2(e) and delta; ok = inside the mask.  The softcap is a
// template argument: a runtime test here would be if-converted, and every
// score would pay for tanhf.
template <bool kSoftcap>
__device__ __forceinline__ void grad_score(const BwdParams& p, float x, float dp, float lse2,
                                           float delta, bool ok, float& pr, float& ds) {
  if constexpr (kSoftcap) {
    // as the forward: softcap * tanh(x scale / softcap)
    const float t = tanhf(x * p.scale / p.softcap);
    pr = ok ? fast_exp2(p.softcap * t * kLog2e - lse2) : 0.f;
    ds = pr * (dp - delta) * (p.scale * (1.f - t * t));
  } else {
    pr = ok ? fast_exp2(fmaf(x, p.scale_log2, -lse2)) : 0.f;
    ds = pr * (dp - delta) * p.scale;
  }
}

// dS of one dQ-pass step in this thread's C fragments (element e of n-tile
// n: q row rows[e >> 1], key k0 + 8 n + 2 tig + (e & 1)), packed as the
// register A operand of dQ += dS K; kEdge: the step straddles a mask edge
template <bool kSoftcap, bool kEdge>
__device__ __forceinline__ void dq_scores(const BwdParams& p, const float (&s)[32],
                                          const float (&dp)[32], const float (&lse2)[2],
                                          const float (&dlt)[2], const int (&lo)[2],
                                          const int (&hi)[2], int k0, int tig,
                                          uint32_t (&sa)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int c = k0 + n * 8 + tig * 2 + (e & 1);
      float pr;
      grad_score<kSoftcap>(p, s[4 * n + e], dp[4 * n + e], lse2[r], dlt[r],
                           !kEdge || (c >= lo[r] && c < hi[r]), pr, ds[e]);
    }
    sa[n / 2][(n % 2) * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
    sa[n / 2][(n % 2) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
  }
}

// P^T and dS^T of one dK/dV-pass step in this thread's C fragments
// (element e of n-tile n: kv row c0 + 8 (e >> 1), q row q0 + 8 n + 2 tig +
// (e & 1)), packed as the register A operands of dV += P^T dO and
// dK += dS^T Q; the step's lse log2(e) and delta from shared memory
template <bool kSoftcap, bool kEdge>
__device__ __forceinline__ void dkdv_scores(const BwdParams& p, const float (&s)[32],
                                            const float (&dp)[32], const float* lse2,
                                            const float* delta, int q0, int c0, int tig,
                                            uint32_t (&pa)[4][4], uint32_t (&sa)[4][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * n + 2 * tig);
    const float2 dl = *reinterpret_cast<const float2*>(delta + 8 * n + 2 * tig);
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + 8 * n + 2 * tig + (e & 1);
      const int c = c0 + 8 * (e >> 1);
      const bool ok =
          !kEdge || ((!p.causal || c <= r) && (p.window <= 0 || r - c < p.window));
      grad_score<kSoftcap>(p, s[4 * n + e], dp[4 * n + e], (e & 1) ? l2.y : l2.x,
                           (e & 1) ? dl.y : dl.x, ok, pr[e], ds[e]);
    }
    pa[n / 2][(n % 2) * 2 + 0] = pack_bf16x2(pr[0], pr[1]);
    pa[n / 2][(n % 2) * 2 + 1] = pack_bf16x2(pr[2], pr[3]);
    sa[n / 2][(n % 2) * 2 + 0] = pack_bf16x2(ds[0], ds[1]);
    sa[n / 2][(n % 2) * 2 + 1] = pack_bf16x2(ds[2], ds[3]);
  }
}

__device__ __forceinline__ float dot8(const uint4& a, const uint4& b) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w};
  const uint32_t bv[4] = {b.x, b.y, b.z, b.w};
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = unpack2(av[i]), y = unpack2(bv[i]);
    acc = fmaf(x.x, y.x, fmaf(x.y, y.y, acc));
  }
  return acc;
}

// ---------------------------------------------------------------------------
// dQ pass: persistent, one block an SM.  Its work items are (q head, batch,
// 128-row q tile), the heaviest causal tiles first; block j takes items j,
// j + grid, ...  Q and dO come into two slots, so the next item's load runs
// under this item's products.  Consumer warpgroup wg owns q rows q0 + 64 wg
// .. + 63 of an item and walks the 64-row kv tiles they may attend.
// ---------------------------------------------------------------------------
struct DqItem {
  int h, b, g, q0, kv_begin, n_tiles;
};

__device__ __forceinline__ DqItem dq_item(const BwdParams& p, int item) {
  const int per_tile = p.heads * p.batch;
  const int z = item / per_tile;
  DqItem w;
  w.h = (item - z * per_tile) % p.heads;
  w.b = (item - z * per_tile) / p.heads;
  w.g = w.h / (p.heads / p.kv_heads);
  w.q0 = (p.causal ? p.q_tiles - 1 - z : z) * 2 * kBwdRows;
  int kv_end = p.kv_len;
  w.kv_begin = 0;
  if (p.causal) kv_end = min(kv_end, min(w.q0 + 2 * kBwdRows, p.q_len));
  if (p.window > 0) w.kv_begin = max(0, w.q0 - p.window + 1);
  w.kv_begin = (w.kv_begin / kBwdRows) * kBwdRows;
  w.n_tiles = kv_end > w.kv_begin ? (kv_end - w.kv_begin + kBwdRows - 1) / kBwdRows : 0;
  return w;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap do_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const __grid_constant__ CUtensorMap dq_map, const BwdParams p) {
  using L = BwdLayout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_full = base + L::kQBars;            // [2]
  const uint32_t q_empty = q_full + 16;                // [2]
  const uint32_t k_full = q_empty + 16;                // [kQStages]
  const uint32_t v_full = k_full + 8 * kQStages;       // [kQStages]
  const uint32_t kv_empty = v_full + 8 * kQStages;     // [kQStages]
  float* delta_s = reinterpret_cast<float*>(smem + L::kQDelta);

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(q_full + 8 * s, 1);
      mbar_init(q_empty + 8 * s, 2);   // one thread of each consumer warpgroup
    }
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(kv_empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------- producer warpgroup ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      int gt = 0;   // kv tiles this block has loaded, over its items
      for (int item = blockIdx.x, n = 0; item < p.dq_items; item += gridDim.x, ++n) {
        const DqItem w = dq_item(p, item);
        const int slot = n & 1;
        if (n >= 2) mbar_wait(q_empty + 8 * slot, ((n >> 1) - 1) & 1);
        const uint32_t qd = base + slot * L::kQSlot;
        mbar_expect_tx(q_full + 8 * slot, 4 * L::kTile);
        for (int wg = 0; wg < 2; ++wg)
          for (int c = 0; c < L::kSub; ++c) {
            const int row = w.q0 + kBwdRows * wg;
            tma_load_4d(qd + wg * L::kTile + c * kBox, &q_map, q_full + 8 * slot, 64 * c, row,
                        w.h, w.b);
            tma_load_4d(qd + (2 + wg) * L::kTile + c * kBox, &do_map, q_full + 8 * slot,
                        64 * c, row, w.h, w.b);
          }
        for (int it = 0; it < w.n_tiles; ++it, ++gt) {
          const int st = gt % kQStages;
          const int use = gt / kQStages;
          if (use > 0) mbar_wait(kv_empty + 8 * st, (use - 1) & 1);
          const int k0 = w.kv_begin + it * kBwdRows;
          const uint32_t kd = base + L::kQK + st * L::kTile;
          const uint32_t vd = base + L::kQV + st * L::kTile;
          mbar_expect_tx(k_full + 8 * st, L::kTile);
          for (int c = 0; c < L::kSub; ++c)
            tma_load_4d(kd + c * kBox, &k_map, k_full + 8 * st, 64 * c, k0, w.g, w.b);
          mbar_expect_tx(v_full + 8 * st, L::kTile);
          for (int c = 0; c < L::kSub; ++c)
            tma_load_4d(vd + c * kBox, &v_map, v_full + 8 * st, 64 * c, k0, w.g, w.b);
        }
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  int gt = 0;   // kv tiles this block has walked, over its items
  for (int item = blockIdx.x, n = 0; item < p.dq_items; item += gridDim.x, ++n) {
    const DqItem w = dq_item(p, item);
    const int slot = n & 1;
    const int wrow0 = w.q0 + kBwdRows * wg;
    const int row0 = wrow0 + 16 * warp + gid;
    const int row1 = row0 + 8;
    const uint32_t q_base = base + slot * L::kQSlot + wg * L::kTile;
    const uint32_t do_base = q_base + 2 * L::kTile;
    const long long bh = (long long)w.b * p.heads + w.h;

    // ---- prologue: delta = rowsum(dO o) of this warpgroup's rows, two
    // threads a row, o and lse loaded while the TMA brings dO into shared
    // memory; the stats for the dK/dV pass ----
    float lse2[2], dlt[2];
    {
      constexpr int kHalf = HD / 16;   // 16-byte chunks of a row, per thread
      const int r = tw >> 1;
      const int row = wrow0 + r;
      uint4 ov[kHalf];
      float lse_row = INFINITY;
      if (row < p.q_len) {
        const __nv_bfloat16* orow = p.o + w.b * p.os[0] + w.h * p.os[1] + row * p.os[2];
#pragma unroll
        for (int j = 0; j < kHalf; ++j)
          ov[j] = *reinterpret_cast<const uint4*>(orow + ((tw & 1) * kHalf + j) * 8);
        lse_row = p.lse[bh * p.q_len + row] * kLog2e;
      }
      lse2[0] = row0 < p.q_len ? p.lse[bh * p.q_len + row0] * kLog2e : INFINITY;
      lse2[1] = row1 < p.q_len ? p.lse[bh * p.q_len + row1] * kLog2e : INFINITY;
      mbar_wait(q_full + 8 * slot, (n >> 1) & 1);
      float acc = 0.f;
      if (row < p.q_len) {
        const unsigned char* drow = smem + (do_base - base) + r * 128;
#pragma unroll
        for (int j = 0; j < kHalf; ++j) {
          const int cc = (tw & 1) * kHalf + j;
          acc += dot8(ov[j], *reinterpret_cast<const uint4*>(
                                 drow + (cc / 8) * kBox + (((cc % 8) ^ (r % 8)) * 16)));
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if ((tw & 1) == 0) {
        delta_s[wg * kBwdRows + r] = acc;
        if (row < p.q_pad) {
          const long long at = bh * p.q_pad + row;
          p.stats[at] = lse_row;
          p.stats[p.stats_half + at] = acc;
        }
      }
      named_barrier(1 + wg, 128);
    }
    int hi[2], lo[2];   // keys row r may attend: lo[r] <= c < hi[r]
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r ? row1 : row0;
      dlt[r] = delta_s[wg * kBwdRows + row - wrow0];
      hi[r] = p.causal ? min(p.kv_len, row + 1) : p.kv_len;
      lo[r] = p.window > 0 ? row - p.window + 1 : 0;
    }

    // dQ += dS K of a tile runs while the next tile's S and dP are issued:
    // `pending` is the stage whose K that product still reads
    float dq[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;
    uint32_t sa[4][4] = {};
    int pending = -1;
    for (int it = 0; it < w.n_tiles; ++it, ++gt) {
      const int st = gt % kQStages;
      const uint32_t par = (gt / kQStages) & 1;
      const int k0 = w.kv_begin + it * kBwdRows;
      // waited even for a skipped tile: the k_full phases order this
      // warpgroup's empty arrivals behind the other's
      mbar_wait(k_full + 8 * st, par);
      const bool dead = wrow0 >= p.q_len || (p.causal && k0 > wrow0 + kBwdRows - 1) ||
                        (p.window > 0 && wrow0 - (k0 + kBwdRows - 1) >= p.window);
      if (dead) {
        if (pending >= 0) {
          wgmma_wait_all();
          fence_operands(dq);
          mbar_arrive(kv_empty + 8 * pending);
          pending = -1;
        }
        mbar_arrive(kv_empty + 8 * st);
        continue;
      }
      const uint32_t kd = base + L::kQK + st * L::kTile;
      const uint32_t vd = base + L::kQV + st * L::kTile;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      score_product<HD>(s, q_base, kd);     // S = Q K^T
      wgmma_commit();
      mbar_wait(v_full + 8 * st, par);
      score_product<HD>(dp, do_base, vd);   // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();                     // and the last tile's dQ product
      fence_operands(s);
      fence_operands(dp);
      fence_operands(dq);
      fence_fragments(sa);
      if (pending >= 0) mbar_arrive(kv_empty + 8 * pending);
      pending = st;

      const bool edge = (k0 + kBwdRows > p.kv_len) ||
                        (p.causal && k0 + kBwdRows - 1 > wrow0) ||
                        (p.window > 0 && wrow0 + kBwdRows - 1 - k0 >= p.window);
      if (p.softcap > 0.f) {
        if (edge) dq_scores<true, true>(p, s, dp, lse2, dlt, lo, hi, k0, tig, sa);
        else dq_scores<true, false>(p, s, dp, lse2, dlt, lo, hi, k0, tig, sa);
      } else {
        if (edge) dq_scores<false, true>(p, s, dp, lse2, dlt, lo, hi, k0, tig, sa);
        else dq_scores<false, false>(p, s, dp, lse2, dlt, lo, hi, k0, tig, sa);
      }
      // ---- dQ += dS K, waited for at the next tile ----
      wgmma_fence();
      value_product<HD>(dq, sa, kd);
      wgmma_commit();
    }
    wgmma_wait_all();
    fence_operands(dq);
    fence_fragments(sa);
    if (pending >= 0) mbar_arrive(kv_empty + 8 * pending);

    // ---- epilogue: stage through this warpgroup's Q rows, TMA store; the
    // slot is free once the store has read them ----
    const int rl = 16 * warp + gid;   // local row; rl % 8 == gid
#pragma unroll
    for (int n8 = 0; n8 < HD / 8; ++n8) {
      unsigned char* sub = smem + (q_base - base) + (n8 / 8) * kBox;
      const int chunk = ((n8 % 8) ^ gid) * 16 + tig * 4;
      *reinterpret_cast<uint32_t*>(sub + rl * 128 + chunk) =
          pack_bf16x2(dq[4 * n8], dq[4 * n8 + 1]);
      *reinterpret_cast<uint32_t*>(sub + (rl + 8) * 128 + chunk) =
          pack_bf16x2(dq[4 * n8 + 2], dq[4 * n8 + 3]);
    }
    fence_proxy_async();
    named_barrier(1 + wg, 128);
    if (tw == 0) {
      if (wrow0 < p.q_len) {
        for (int c = 0; c < L::kSub; ++c)
          tma_store_4d(&dq_map, q_base + c * kBox, 64 * c, wrow0, w.h, w.b);
        tma_store_commit_and_wait();
      }
      mbar_arrive(q_empty + 8 * slot);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV pass: one block per (pair of 64-row kv tiles, kv head, batch).
// ---------------------------------------------------------------------------

// the q steps that may attend kv tile k0: [first, first + count)
__device__ __forceinline__ void q_steps(const BwdParams& p, int k0, int& first, int& count) {
  const int q_begin = p.causal ? k0 : 0;
  const int q_end = p.window > 0 ? min(p.q_len, k0 + kBwdRows - 1 + p.window) : p.q_len;
  first = q_begin / kBwdRows;
  count = q_end > q_begin ? (q_end + kBwdRows - 1) / kBwdRows - first : 0;
}

// the kv tile walked ti-th by block `pair`, and how many it walks: under a
// causal mask tiles pair and kv_tiles - 1 - pair (one tile where they meet)
__device__ __forceinline__ int block_tile(const BwdParams& p, int pair, int ti) {
  return ti == 0 ? pair : p.kv_tiles - 1 - pair;
}
__device__ __forceinline__ int block_tiles(const BwdParams& p, int pair) {
  return p.causal && p.kv_tiles - 1 - pair != pair ? 2 : 1;
}

// the units (q head, q step) of one tile that warpgroup w takes: of the
// tile's rep x count units in (q head, step) order, the first half (rounded
// up) goes to warpgroup 0, the rest to warpgroup 1
__device__ __forceinline__ void wg_units(int units, int w, int& first, int& end) {
  const int half = (units + 1) / 2;
  first = w ? half : 0;
  end = w ? units : half;
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const BwdParams p) {
  using L = BwdLayout<HD>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + L::kKVBars;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full0 = kv_empty + 8;                  // [2][kKVStages]
  const uint32_t empty0 = full0 + 8 * 2 * kKVStages;    // [2][kKVStages]

  const int pair = blockIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = p.heads / p.kv_heads;
  const int n_tb = block_tiles(p, pair);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers);
    for (int s = 0; s < 2 * kKVStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------- producer warpgroup: warp 0 feeds consumer warpgroup
    // 0 and K, V; warp 2 feeds consumer warpgroup 1 ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    const int pt = threadIdx.x - kConsumers;
    if (pt != 0 && pt != 64) return;
    const int w = pt / 64;
    const uint32_t full = full0 + 8 * kKVStages * w;
    const uint32_t empty = empty0 + 8 * kKVStages * w;
    const uint32_t ring = base + L::kRing + w * kKVStages * L::kStage;
    const uint32_t stats = base + L::kStats + w * kKVStages * 512;
    int it = 0;
    for (int ti = 0; ti < n_tb; ++ti) {
      const int k0 = block_tile(p, pair, ti) * kBwdRows;
      if (w == 0) {
        if (ti > 0) mbar_wait(kv_empty, (ti - 1) & 1);
        mbar_expect_tx(kv_full, 2 * L::kTile);
        for (int c = 0; c < L::kSub; ++c) {
          tma_load_4d(base + c * kBox, &k_map, kv_full, 64 * c, k0, g, b);
          tma_load_4d(base + L::kTile + c * kBox, &v_map, kv_full, 64 * c, k0, g, b);
        }
      }
      int first, count, u, u_end;
      q_steps(p, k0, first, count);
      wg_units(rep * count, w, u, u_end);
      for (; u < u_end; ++u, ++it) {
        const int hq = g * rep + u / count;
        const int q0 = (first + u % count) * kBwdRows;
        const int st = it % kKVStages;
        const int use = it / kKVStages;
        if (use > 0) mbar_wait(empty + 8 * st, (use - 1) & 1);
        const uint32_t qd = ring + st * L::kStage;
        mbar_expect_tx(full + 8 * st, L::kStage + 512);
        for (int c = 0; c < L::kSub; ++c) {
          tma_load_4d(qd + c * kBox, &q_map, full + 8 * st, 64 * c, q0, hq, b);
          tma_load_4d(qd + L::kTile + c * kBox, &do_map, full + 8 * st, 64 * c, q0, hq, b);
        }
        const float* lse2 = p.stats + ((long long)b * p.heads + hq) * p.q_pad + q0;
        bulk_load(stats + st * 512, lse2, 256, full + 8 * st);
        bulk_load(stats + st * 512 + 256, lse2 + p.stats_half, 256, full + 8 * st);
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const long long t0 = clock64();
  const int wg = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32;
  const int lane = tw % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const uint32_t full = full0 + 8 * kKVStages * wg;
  const uint32_t empty = empty0 + 8 * kKVStages * wg;
  const uint32_t ring = base + L::kRing + wg * kKVStages * L::kStage;
  const float* stats = reinterpret_cast<const float*>(smem + L::kStats + wg * kKVStages * 512);
  float4* xbuf = reinterpret_cast<float4*>(smem + L::kX);
  int it = 0;
  for (int ti = 0; ti < n_tb; ++ti) {
    const int k0 = block_tile(p, pair, ti) * kBwdRows;
    const int c0 = k0 + 16 * warp + gid;   // this thread's kv rows: c0, c0 + 8
    float dk[HD / 2], dv[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, ti & 1);
    int first, count, u, u_end;
    q_steps(p, k0, first, count);
    wg_units(rep * count, wg, u, u_end);
    for (; u < u_end; ++u, ++it) {
      const int q0 = (first + u % count) * kBwdRows;
      const int st = it % kKVStages;
      mbar_wait(full + 8 * st, (it / kKVStages) & 1);
      const uint32_t qd = ring + st * L::kStage;
      const uint32_t dod = qd + L::kTile;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      score_product<HD>(s, base, qd);              // S^T = K Q^T
      score_product<HD>(dp, base + L::kTile, dod);  // dP^T = V dO^T
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(s);
      fence_operands(dp);

      const bool edge = (p.causal && q0 < k0 + kBwdRows - 1) ||
                        (p.window > 0 && q0 + kBwdRows - 1 - k0 >= p.window);
      const float* lse2 = stats + st * 128;
      const float* delta = lse2 + 64;
      uint32_t pa[4][4], sa[4][4];
      if (p.softcap > 0.f) {
        if (edge) dkdv_scores<true, true>(p, s, dp, lse2, delta, q0, c0, tig, pa, sa);
        else dkdv_scores<true, false>(p, s, dp, lse2, delta, q0, c0, tig, pa, sa);
      } else {
        if (edge) dkdv_scores<false, true>(p, s, dp, lse2, delta, q0, c0, tig, pa, sa);
        else dkdv_scores<false, false>(p, s, dp, lse2, delta, q0, c0, tig, pa, sa);
      }
      // ---- dV += P^T dO, dK += dS^T Q, waited for at the next step ----
      wgmma_fence();
      value_product<HD>(dv, pa, dod);
      value_product<HD>(dk, sa, qd);
      wgmma_commit();
      wgmma_wait_all();
      fence_operands(dv);
      fence_operands(dk);
      mbar_arrive(empty + 8 * st);
    }
    mbar_arrive(kv_empty);   // this warpgroup's products on K and V are done

    // ---- warpgroup 1's partial sums into warpgroup 0's, dV then dK,
    // through the exchange buffer; named barrier 1: written, 2: read ----
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        xbuf[j * 128 + tw] = make_float4(dv[4 * j], dv[4 * j + 1], dv[4 * j + 2], dv[4 * j + 3]);
      named_barrier_arrive(1, kConsumers);
      named_barrier(2, kConsumers);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        xbuf[j * 128 + tw] = make_float4(dk[4 * j], dk[4 * j + 1], dk[4 * j + 2], dk[4 * j + 3]);
      named_barrier_arrive(1, kConsumers);
      named_barrier(2, kConsumers);
      continue;
    }
    named_barrier(1, kConsumers);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float4 x = xbuf[j * 128 + tw];
      dv[4 * j] += x.x; dv[4 * j + 1] += x.y; dv[4 * j + 2] += x.z; dv[4 * j + 3] += x.w;
    }
    named_barrier_arrive(2, kConsumers);
    named_barrier(1, kConsumers);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const float4 x = xbuf[j * 128 + tw];
      dk[4 * j] += x.x; dk[4 * j + 1] += x.y; dk[4 * j + 2] += x.z; dk[4 * j + 3] += x.w;
    }
    named_barrier_arrive(2, kConsumers);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = c0 + 8 * r;
      if (row >= p.kv_len) continue;
      __nv_bfloat16* dkr = p.dk + b * p.dks[0] + g * p.dks[1] + row * p.dks[2];
      __nv_bfloat16* dvr = p.dv + b * p.dvs[0] + g * p.dvs[1] + row * p.dvs[2];
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        *reinterpret_cast<uint32_t*>(dkr + 8 * n + 2 * tig) =
            pack_bf16x2(dk[4 * n + 2 * r], dk[4 * n + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvr + 8 * n + 2 * tig) =
            pack_bf16x2(dv[4 * n + 2 * r], dv[4 * n + 2 * r + 1]);
      }
    }
  }
  if (p.record && tw == 0) {
    long long* rec = p.record + 4 * (((long long)b * p.kv_heads + g) * gridDim.x + pair) + 2 * wg;
    rec[0] = it;
    rec[1] = clock64() - t0;
  }
}

template <int HD>
cudaError_t launch_bwd(const CUtensorMap& qm, const CUtensorMap& dom, const CUtensorMap& km,
                       const CUtensorMap& vm, const CUtensorMap& dqm, const BwdParams& p,
                       int batch, cudaStream_t stream) {
  using L = BwdLayout<HD>;
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_kernel<HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::kQSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(attn_bwd_dkdv_kernel<HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::kKVSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  static int sms_of[kMaxDevices] = {};   // once a device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  int& sms = sms_of[device];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  attn_bwd_dq_kernel<HD><<<min(sms, p.dq_items), kThreads, L::kQSmem, stream>>>(
      qm, dom, km, vm, dqm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 kv_grid(p.kv_pairs, p.kv_heads, batch);
  attn_bwd_dkdv_kernel<HD><<<kv_grid, kThreads, L::kKVSmem, stream>>>(qm, dom, km, vm, p);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// The backward at head_dim 256 (Gemma2), on wgmma and TMA.
//
// The two passes above do not fit at 256 columns: the dQ pass's Q and dO
// slots and K/V rings would take 256 KB of shared memory and the dK/dV
// pass's over 320 KB, against the 227 KB a block may have; and a consumer
// warpgroup holding all of dK and dV of a 64-row kv tile would need 2 x 64
// x 256 fp32 over 128 threads, 256 registers a thread, one more than
// exist.  So at 256 the two consumer warpgroups of a block split the head
// dim, and the score tile between them by columns:
//
//   * Two passes, as above: dQ, a block per (64-row q tile, head, batch),
//     the heaviest causal tiles first; then dK/dV, a block per (64-row kv
//     tile, kv head, batch), which walks the q heads of its kv head and
//     their q steps in order.  No atomics; every sum runs in one fixed
//     order, so two calls give the same bits.  A first kernel (prep)
//     writes each q row's lse log2(e) and delta = rowsum(dO * O) into the
//     padded fp32 stats scratch.
//   * The accumulators by head-dim halves.  Consumer warpgroup w owns the
//     128 columns 128 w .. of the gradients: dQ, 64 fp32 registers a
//     thread; dK and dV, 128.
//   * The scores by columns.  Warpgroup w computes S and dP for its own 32
//     columns of the 64 x 64 step over all 256 columns of the head
//     (wgmma m64n32k16, both operands K-major in shared memory), applies
//     the softcap and the mask and forms P and dS in registers, and writes
//     its halves of them as bf16 into shared memory (64 x 64 tiles, two
//     buffers).  After one named barrier a step, both warpgroups read the
//     whole P and dS as the shared-memory A operand of the updates
//     (m64n128k16, its head-dim half as N, B through the transpose bit):
//     dQ += dS K; dV += P^T dO and dK += dS^T Q.  The updates run while
//     the next step's S and dP are issued; the two buffers keep a step's
//     writes off the tiles the other warpgroup's last updates still read.
//   * Loads.  One producer thread issues TMA loads (64-column boxes,
//     128-byte swizzle): the block's own 64-row tiles once (Q and dO, or
//     K and V, 64 KB), the streamed pair (K and V, or Q, dO and their rows'
//     stats) through a two-stage ring of 2 x 64 KB on mbarriers.
//     setmaxnreg gives the producer warpgroup 40 registers a thread and
//     the consumers 232.  Shared memory: 209 KB (dQ), 226 KB (dK/dV).
//   * Score math as the forward's: the softcap's tanh by one ex2 and one
//     approximate reciprocal, P by one fma and one ex2 in the log2 domain;
//     the softcap and the mask test are template arguments, the mask
//     tested only on steps that straddle an edge.
//
// What bounds it: operations.  At Gemma2's [2, 16, 8160, 256] over 8 kv
// heads the five products of the causal pairs are 2.7 TFLOP, 2.76 ms at
// 989 TFLOP/s (the global mask); the two passes compute seven (S and dP
// twice), so this design reaches at most 5/7 of the rate.  The steps of a
// block are serial: its warpgroups wait for the scores before the softcap
// math, which the tensor cores do not overlap.
namespace bwd256 {

using namespace sm90;

constexpr int kRows = 64;                 // rows of a block's tile, of a step
constexpr int kTile = 4 * kBox;           // a 64 x 256 bf16 tile: four boxes
constexpr int kStages = 2;                // the streamed pair's ring
// dQ pass: Q, dO; the K and V rings; two dS tiles; barriers
constexpr int kDqSmem = 2 * kTile + 2 * kStages * kTile + 2 * kBox + 128 + 1024;
// dK/dV pass: K, V; the ring of (Q, dO); two P^T and two dS^T tiles; each
// stage's lse log2(e) and delta; barriers
constexpr int kKVSmem =
    2 * kTile + 2 * kStages * kTile + 4 * kBox + kStages * 512 + 128 + 1024;

struct Args {
  const __nv_bfloat16 *o, *dout;           // for prep
  const float* lse;                        // [B, H, q_len]
  float* stats;   // [2, B, H, q_pad]: lse log2(e) (+inf past q_len), delta
  long long stats_half;                    // B H q_pad: where delta starts
  __nv_bfloat16 *dq, *dk, *dv;
  long long os[3], dos[3], dqs[3], dks[3], dvs[3];   // (batch, head, seq)
  int batch, heads, kv_heads, q_len, kv_len, q_pad, q_tiles, kv_tiles;
  float scale, scale_log2, softcap, cap_log2, inv_cap;   // softcap <= 0: none
  int causal, window;                      // window <= 0: none
};

// d[16] = A B^T over the 256 columns: A a 64-row tile at shared address
// a, B the 32 rows of a tile at shared address b (both K-major, four boxes)
__device__ __forceinline__ void half_scores(float (&d)[16], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const uint32_t off = (kk / 4) * kBox + (kk % 4) * 32;
    wgmma_ss_n32(d, desc_sw128(a + off, 16), desc_sw128(b + off, 16), kk > 0);
  }
}

// d[64] += A B: A a 64 x 64 bf16 tile at shared address a (K-major), B 64
// rows of 128 columns, two boxes from shared address b (N-major)
__device__ __forceinline__ void half_update(float (&d)[64], uint32_t a, uint32_t b) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wgmma_ss_n128_bt(d, desc_sw128(a + j * 32, 16), desc_sw128(b + j * 16 * 128, kBox), 1);
}

// P and dS of one score: raw product x = q.k, dp = do.v, the q row's lse
// log2(e) and delta; ok = inside the mask.  Under a softcap c the score is
// c tanh(x scale / c) = c - 2c / (2^(x cap_log2) + 1), as the forward
// computes it.
template <bool kSoftcap>
__device__ __forceinline__ void grad_score(const Args& p, float x, float dp, float lse2,
                                           float delta, bool ok, float& pr, float& ds) {
  if constexpr (kSoftcap) {
    const float sc = p.softcap - __fdividef(2.f * p.softcap, fast_exp2(x * p.cap_log2) + 1.f);
    const float t = sc * p.inv_cap;
    pr = ok ? fast_exp2(fmaf(sc, kLog2e, -lse2)) : 0.f;
    ds = pr * (dp - delta) * (p.scale * (1.f - t * t));
  } else {
    pr = ok ? fast_exp2(fmaf(x, p.scale_log2, -lse2)) : 0.f;
    ds = pr * (dp - delta) * p.scale;
  }
}

// a bf16 pair into a 64 x 64 tile with 128-byte rows, 128-byte swizzle:
// row r, columns 8 c8 + 2 tig, +1
__device__ __forceinline__ void put2(unsigned char* tile, int r, int c8, int tig, float a,
                                     float b) {
  *reinterpret_cast<uint32_t*>(tile + r * 128 + ((c8 ^ (r & 7)) * 16) + tig * 4) =
      pack_bf16x2(a, b);
}

// each q row's lse log2(e) (+inf past q_len) and delta = rowsum(dO * O),
// one warp a row
__global__ void prep_kernel(const Args p) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  const int rows = p.batch * p.heads * p.q_pad;
  if (warp >= rows) return;
  const int r = warp % p.q_pad, bh = warp / p.q_pad;
  const int b = bh / p.heads, h = bh % p.heads;
  float acc = 0.f;
  if (r < p.q_len) {
    const uint4 dv = *reinterpret_cast<const uint4*>(p.dout + b * p.dos[0] + h * p.dos[1] +
                                                     (long long)r * p.dos[2] + lane * 8);
    const uint4 ov = *reinterpret_cast<const uint4*>(p.o + b * p.os[0] + h * p.os[1] +
                                                     (long long)r * p.os[2] + lane * 8);
    acc = dot8(dv, ov);
  }
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (lane == 0) {
    const long long at = (long long)bh * p.q_pad + r;
    p.stats[at] = r < p.q_len ? p.lse[(long long)bh * p.q_len + r] * kLog2e : INFINITY;
    p.stats[p.stats_half + at] = acc;
  }
}

// dS of one dQ step from this warpgroup's S and dP (element e of n-tile n:
// q row rl[e >> 1] of the tile, key k0 + 32 wg + 8 n + 2 tig + (e & 1))
// into the dS tile; kEdge: the step straddles a mask edge
template <bool kSoftcap, bool kEdge>
__device__ __forceinline__ void dq_step(const Args& p, const float (&s)[16],
                                        const float (&dp)[16], const float (&lse2)[2],
                                        const float (&dlt)[2], const int (&lo)[2],
                                        const int (&hi)[2], int k0, int wg, int rl, int tig,
                                        unsigned char* tile) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int c = k0 + 32 * wg + 8 * n + 2 * tig + (e & 1);
      float pr;
      grad_score<kSoftcap>(p, s[4 * n + e], dp[4 * n + e], lse2[r], dlt[r],
                           !kEdge || (c >= lo[r] && c < hi[r]), pr, ds[e]);
    }
    put2(tile, rl, 4 * wg + n, tig, ds[0], ds[1]);
    put2(tile, rl + 8, 4 * wg + n, tig, ds[2], ds[3]);
  }
}

// P^T and dS^T of one dK/dV step (element e of n-tile n: kv row c0 + 8 (e
// >> 1), q row q0 + 32 wg + 8 n + 2 tig + (e & 1)) into their tiles; the
// step's lse log2(e) and delta from shared memory
template <bool kSoftcap, bool kEdge>
__device__ __forceinline__ void dkdv_step(const Args& p, const float (&s)[16],
                                          const float (&dp)[16], const float* lse2,
                                          const float* delta, int q0, int c0, int wg, int rl,
                                          int tig, unsigned char* pt, unsigned char* dst) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int ql = 32 * wg + 8 * n + 2 * tig;
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + ql);
    const float2 dl = *reinterpret_cast<const float2*>(delta + ql);
    float pr[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = q0 + ql + (e & 1);
      const int c = c0 + 8 * (e >> 1);
      const bool ok =
          !kEdge || ((!p.causal || c <= r) && (p.window <= 0 || r - c < p.window));
      grad_score<kSoftcap>(p, s[4 * n + e], dp[4 * n + e], (e & 1) ? l2.y : l2.x,
                           (e & 1) ? dl.y : dl.x, ok, pr[e], ds[e]);
    }
    put2(pt, rl, 4 * wg + n, tig, pr[0], pr[1]);
    put2(pt, rl + 8, 4 * wg + n, tig, pr[2], pr[3]);
    put2(dst, rl, 4 * wg + n, tig, ds[0], ds[1]);
    put2(dst, rl + 8, 4 * wg + n, tig, ds[2], ds[3]);
  }
}

// 64 fp32 gradients of this thread (rows rl, rl + 8 of the tile from row0,
// columns 128 wg + 8 n + 2 tig, +1) as bf16 into a [B, heads, len, 256]
// tensor, rows past len not written
__device__ __forceinline__ void store_half(__nv_bfloat16* out, const long long (&st)[3], int b,
                                           int h, int row0, int len, const float (&d)[64],
                                           int wg, int rl, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + rl + 8 * r;
    if (row >= len) continue;
    __nv_bfloat16* dst = out + b * st[0] + h * st[1] + (long long)row * st[2] + 128 * wg;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n + 2 * tig) =
          pack_bf16x2(d[4 * n + 2 * r], d[4 * n + 2 * r + 1]);
  }
}

// the q steps that may attend kv tile k0: [first, first + count)
__device__ __forceinline__ void q_steps(const Args& p, int k0, int& first, int& count) {
  const int q_begin = p.causal ? k0 : 0;
  const int q_end = p.window > 0 ? min(p.q_len, k0 + kRows - 1 + p.window) : p.q_len;
  first = q_begin / kRows;
  count = q_end > q_begin ? (q_end + kRows - 1) / kRows - first : 0;
}

// dQ: a block per (64-row q tile, head, batch), the q tile the slowest
// index, heaviest causal tiles first
template <bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap do_map,
          const __grid_constant__ CUtensorMap k_map, const __grid_constant__ CUtensorMap v_map,
          const Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t q_s = base, do_s = base + kTile;
  const uint32_t k_s = base + 2 * kTile, v_s = k_s + kStages * kTile;
  const uint32_t ds_s = v_s + kStages * kTile;        // [2] 64 x 64 bf16
  const uint32_t q_full = ds_s + 2 * kBox;
  const uint32_t k_full = q_full + 8;                 // [kStages]
  const uint32_t v_full = k_full + 8 * kStages;       // [kStages]
  const uint32_t kv_empty = v_full + 8 * kStages;     // [kStages]

  const int per = p.heads * p.batch;
  const int z = blockIdx.x / per;
  const int h = (blockIdx.x % per) % p.heads, b = (blockIdx.x % per) / p.heads;
  const int q0 = (p.causal ? p.q_tiles - 1 - z : z) * kRows;
  const int g = h / (p.heads / p.kv_heads);
  int kv_begin = 0, kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, min(q0 + kRows, p.q_len));
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1) / kRows * kRows;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + kRows - 1) / kRows : 0;

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
    // ---------------- producer warpgroup: one thread issues ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, 2 * kTile);
      for (int c = 0; c < 4; ++c) {
        tma_load_4d(q_s + c * kBox, &q_map, q_full, 64 * c, q0, h, b);
        tma_load_4d(do_s + c * kBox, &do_map, q_full, 64 * c, q0, h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        const int use = it / kStages;
        if (use > 0) mbar_wait(kv_empty + 8 * st, (use - 1) & 1);
        const int k0 = kv_begin + it * kRows;
        const uint32_t kd = k_s + st * kTile, vd = v_s + st * kTile;
        mbar_expect_tx(k_full + 8 * st, kTile);
        for (int c = 0; c < 4; ++c)
          tma_load_4d(kd + c * kBox, &k_map, k_full + 8 * st, 64 * c, k0, g, b);
        mbar_expect_tx(v_full + 8 * st, kTile);
        for (int c = 0; c < 4; ++c)
          tma_load_4d(vd + c * kBox, &v_map, v_full + 8 * st, 64 * c, k0, g, b);
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int lane = tw % 32;
  const int rl = 16 * (tw / 32) + lane / 4;   // this thread's tile rows rl, rl + 8
  const int tig = lane % 4;
  const long long bh = (long long)b * p.heads + h;
  float lse2[2], dlt[2];
  int hi[2], lo[2];   // keys row r may attend: lo[r] <= c < hi[r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rl + 8 * r;
    lse2[r] = p.stats[bh * p.q_pad + row];
    dlt[r] = p.stats[p.stats_half + bh * p.q_pad + row];
    hi[r] = p.causal ? min(p.kv_len, row + 1) : p.kv_len;
    lo[r] = p.window > 0 ? row - p.window + 1 : 0;
  }
  float dq[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);
  // the dQ update of a step runs while the next step's S and dP are
  // issued: `pending` is the stage whose K that update still reads
  int pending = -1;
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int k0 = kv_begin + it * kRows;
    const uint32_t kd = k_s + st * kTile, vd = v_s + st * kTile;
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(k_full + 8 * st, par);
    wgmma_fence();
    half_scores(s, q_s, kd + 32 * wg * 128);      // S = Q K^T, 32 columns
    wgmma_commit();
    mbar_wait(v_full + 8 * st, par);
    half_scores(dp, do_s, vd + 32 * wg * 128);    // dP = dO V^T
    wgmma_commit();
    wgmma_wait_all();                             // and the last step's update
    fence_operands(s);
    fence_operands(dp);
    fence_operands(dq);
    if (pending >= 0) mbar_arrive(kv_empty + 8 * pending);
    pending = st;

    unsigned char* tile = smem + (ds_s - base) + (it & 1) * kBox;
    const bool edge = (k0 + kRows > p.kv_len) || (p.causal && k0 + kRows - 1 > q0) ||
                      (p.window > 0 && q0 + kRows - 1 - k0 >= p.window);
    if (edge) dq_step<kSoftcap, true>(p, s, dp, lse2, dlt, lo, hi, k0, wg, rl, tig, tile);
    else dq_step<kSoftcap, false>(p, s, dp, lse2, dlt, lo, hi, k0, wg, rl, tig, tile);
    fence_proxy_async();
    named_barrier(1, kConsumers);                 // both halves of dS written
    // ---- dQ[:, 128 wg ..] += dS K[:, 128 wg ..], waited for at the next step ----
    wgmma_fence();
    half_update(dq, ds_s + (it & 1) * kBox, kd + 2 * wg * kBox);
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_operands(dq);
  if (pending >= 0) mbar_arrive(kv_empty + 8 * pending);
  store_half(p.dq, p.dqs, b, h, q0, p.q_len, dq, wg, rl, tig);
}

// dK and dV: a block per (64-row kv tile, kv head, batch), the kv tile the
// slowest index (tile 0 has the most causal q steps), over the q heads of
// its kv head and their q steps in order
template <bool kSoftcap>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
            const __grid_constant__ CUtensorMap do_map,
            const __grid_constant__ CUtensorMap k_map,
            const __grid_constant__ CUtensorMap v_map, const Args p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t k_s = base, v_s = base + kTile;
  const uint32_t ring = base + 2 * kTile;             // [kStages] (Q, dO)
  const uint32_t pt_s = ring + kStages * 2 * kTile;   // [2] P^T, 64 x 64 bf16
  const uint32_t dst_s = pt_s + 2 * kBox;             // [2] dS^T
  const uint32_t stats_s = dst_s + 2 * kBox;          // [kStages] lse2[64], delta[64]
  const uint32_t kv_full = stats_s + kStages * 512;
  const uint32_t full = kv_full + 8;                  // [kStages]
  const uint32_t empty = full + 8 * kStages;          // [kStages]

  const int per = p.kv_heads * p.batch;
  const int k0 = (blockIdx.x / per) * kRows;
  const int g = (blockIdx.x % per) % p.kv_heads, b = (blockIdx.x % per) / p.kv_heads;
  const int rep = p.heads / p.kv_heads;
  int first, count;
  q_steps(p, k0, first, count);
  const int units = rep * count;   // (q head, q step), q head the slower

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---------------- producer warpgroup: one thread issues ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(kv_full, 2 * kTile);
      for (int c = 0; c < 4; ++c) {
        tma_load_4d(k_s + c * kBox, &k_map, kv_full, 64 * c, k0, g, b);
        tma_load_4d(v_s + c * kBox, &v_map, kv_full, 64 * c, k0, g, b);
      }
      for (int u = 0; u < units; ++u) {
        const int hq = g * rep + u / count;
        const int q0 = (first + u % count) * kRows;
        const int st = u % kStages;
        const int use = u / kStages;
        if (use > 0) mbar_wait(empty + 8 * st, (use - 1) & 1);
        const uint32_t qd = ring + st * 2 * kTile;
        mbar_expect_tx(full + 8 * st, 2 * kTile + 512);
        for (int c = 0; c < 4; ++c) {
          tma_load_4d(qd + c * kBox, &q_map, full + 8 * st, 64 * c, q0, hq, b);
          tma_load_4d(qd + kTile + c * kBox, &do_map, full + 8 * st, 64 * c, q0, hq, b);
        }
        const float* lse2 = p.stats + ((long long)b * p.heads + hq) * p.q_pad + q0;
        bulk_load(stats_s + st * 512, lse2, 256, full + 8 * st);
        bulk_load(stats_s + st * 512 + 256, lse2 + p.stats_half, 256, full + 8 * st);
      }
    }
    return;
  }
  // ---------------- consumer warpgroups ----------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = threadIdx.x / 128;
  const int tw = threadIdx.x % 128;
  const int lane = tw % 32;
  const int rl = 16 * (tw / 32) + lane / 4;   // this thread's kv rows k0 + rl, + 8
  const int tig = lane % 4;
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(kv_full, 0);
  // the updates of a step run while the next step's S^T and dP^T are
  // issued: `pending` is the stage whose Q and dO they still read
  int pending = -1;
  for (int u = 0; u < units; ++u) {
    const int q0 = (first + u % count) * kRows;
    const int st = u % kStages;
    const uint32_t qd = ring + st * 2 * kTile, dod = qd + kTile;
    float s[16], dp[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
    mbar_wait(full + 8 * st, (u / kStages) & 1);
    wgmma_fence();
    half_scores(s, k_s, qd + 32 * wg * 128);      // S^T = K Q^T, 32 q columns
    half_scores(dp, v_s, dod + 32 * wg * 128);    // dP^T = V dO^T
    wgmma_commit();
    wgmma_wait_all();                             // and the last step's updates
    fence_operands(s);
    fence_operands(dp);
    fence_operands(dk);
    fence_operands(dv);
    if (pending >= 0) mbar_arrive(empty + 8 * pending);
    pending = st;

    const float* lse2 = reinterpret_cast<const float*>(smem + (stats_s - base) + st * 512);
    unsigned char* pt = smem + (pt_s - base) + (u & 1) * kBox;
    unsigned char* dst = smem + (dst_s - base) + (u & 1) * kBox;
    const bool edge = (p.causal && q0 < k0 + kRows - 1) ||
                      (p.window > 0 && q0 + kRows - 1 - k0 >= p.window);
    if (edge)
      dkdv_step<kSoftcap, true>(p, s, dp, lse2, lse2 + 64, q0, k0 + rl, wg, rl, tig, pt, dst);
    else
      dkdv_step<kSoftcap, false>(p, s, dp, lse2, lse2 + 64, q0, k0 + rl, wg, rl, tig, pt, dst);
    fence_proxy_async();
    named_barrier(1, kConsumers);                 // both halves of P^T and dS^T written
    // ---- dV += P^T dO, dK += dS^T Q on this warpgroup's 128 columns ----
    wgmma_fence();
    half_update(dv, pt_s + (u & 1) * kBox, dod + 2 * wg * kBox);
    half_update(dk, dst_s + (u & 1) * kBox, qd + 2 * wg * kBox);
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_operands(dk);
  fence_operands(dv);
  if (pending >= 0) mbar_arrive(empty + 8 * pending);
  store_half(p.dk, p.dks, b, g, k0, p.kv_len, dk, wg, rl, tig);
  store_half(p.dv, p.dvs, b, g, k0, p.kv_len, dv, wg, rl, tig);
}

template <bool kSoftcap>
cudaError_t launch(const CUtensorMap& qm, const CUtensorMap& dom, const CUtensorMap& km,
                   const CUtensorMap& vm, const Args& p, cudaStream_t stream) {
  static bool configured = false;   // once per process
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(dq_kernel<kSoftcap>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kDqSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(dkdv_kernel<kSoftcap>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kKVSmem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const int rows = p.batch * p.heads * p.q_pad;
  prep_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dq_kernel<kSoftcap><<<p.q_tiles * p.heads * p.batch, kThreads, kDqSmem, stream>>>(
      qm, dom, km, vm, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<kSoftcap><<<p.kv_tiles * p.kv_heads * p.batch, kThreads, kKVSmem, stream>>>(
      qm, dom, km, vm, p);
  return cudaGetLastError();
}

}  // namespace bwd256

namespace {

int backward(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* stats, void* dq, void* dk, void* dv,
             const long long* strides, int batch, int heads, int kv_heads, int q_len,
             int kv_len, int head_dim, float scale, float softcap, int causal, int window,
             int device, void* stream, long long* record, long long record_blocks) {
  if ((head_dim != 64 && head_dim != 112 && head_dim != 128 && head_dim != 256) ||
      batch < 1 || q_len < 1 || kv_len < 1 || kv_heads < 1 || heads % kv_heads)
    return static_cast<int>(cudaErrorInvalidValue);
  const DeviceBind bind(device);
  if (bind.status() != cudaSuccess) return static_cast<int>(bind.status());
  const long long* s = strides;
  CUtensorMap qm, dom, km, vm, dqm;
  if (!make_map(&qm, q, batch, heads, q_len, head_dim, s[0], s[1], s[2], kBwdRows) ||
      !make_map(&km, k, batch, kv_heads, kv_len, head_dim, s[3], s[4], s[5], kBwdRows) ||
      !make_map(&vm, v, batch, kv_heads, kv_len, head_dim, s[6], s[7], s[8], kBwdRows) ||
      !make_map(&dom, dout, batch, heads, q_len, head_dim, s[12], s[13], s[14], kBwdRows) ||
      !make_map(&dqm, dq, batch, heads, q_len, head_dim, s[15], s[16], s[17], kBwdRows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 256) {        // the split-head-dim passes; no per-block record
    if (record) return static_cast<int>(cudaErrorInvalidValue);
    bwd256::Args a;
    a.o = static_cast<const __nv_bfloat16*>(o);
    a.dout = static_cast<const __nv_bfloat16*>(dout);
    a.lse = static_cast<const float*>(lse);
    a.stats = static_cast<float*>(stats);
    a.dq = static_cast<__nv_bfloat16*>(dq);
    a.dk = static_cast<__nv_bfloat16*>(dk);
    a.dv = static_cast<__nv_bfloat16*>(dv);
    long long* dst[5] = {a.os, a.dos, a.dqs, a.dks, a.dvs};
    const int src[5] = {3, 4, 5, 6, 7};   // o, dout, dq, dk, dv in strides[]
    for (int t = 0; t < 5; ++t)
      for (int i = 0; i < 3; ++i) dst[t][i] = s[3 * src[t] + i];
    a.batch = batch; a.heads = heads; a.kv_heads = kv_heads; a.q_len = q_len;
    a.kv_len = kv_len; a.q_pad = (q_len + kBwdRows - 1) / kBwdRows * kBwdRows;
    a.q_tiles = a.q_pad / kBwdRows;
    a.kv_tiles = (kv_len + kBwdRows - 1) / kBwdRows;
    a.stats_half = (long long)batch * heads * a.q_pad;
    a.scale = scale; a.scale_log2 = scale * kLog2e; a.softcap = softcap;
    a.cap_log2 = softcap > 0.f ? 2.f * kLog2e * scale / softcap : 0.f;
    a.inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
    a.causal = causal; a.window = window;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return static_cast<int>(softcap > 0.f ? bwd256::launch<true>(qm, dom, km, vm, a, st)
                                          : bwd256::launch<false>(qm, dom, km, vm, a, st));
  }
  BwdParams p;
  p.batch = batch; p.heads = heads; p.kv_heads = kv_heads; p.q_len = q_len;
  p.kv_len = kv_len;
  p.q_tiles = (q_len + 2 * kBwdRows - 1) / (2 * kBwdRows);
  p.dq_items = batch * heads * p.q_tiles;
  p.kv_tiles = (kv_len + kBwdRows - 1) / kBwdRows;
  p.kv_pairs = causal ? (p.kv_tiles + 1) / 2 : p.kv_tiles;
  p.q_pad = (q_len + kBwdRows - 1) / kBwdRows * kBwdRows;
  p.scale = scale; p.scale_log2 = scale * kLog2e; p.softcap = softcap;
  p.causal = causal; p.window = window;
  p.lse = static_cast<const float*>(lse);
  p.stats = static_cast<float*>(stats);
  p.stats_half = (long long)batch * heads * p.q_pad;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  for (int i = 0; i < 3; ++i) {
    p.os[i] = s[9 + i];
    p.dks[i] = s[18 + i];
    p.dvs[i] = s[21 + i];
  }
  if (record && record_blocks < (long long)batch * kv_heads * p.kv_pairs)
    return static_cast<int>(cudaErrorInvalidValue);
  p.record = record;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128) err = launch_bwd<128>(qm, dom, km, vm, dqm, p, batch, st);
  else if (head_dim == 112) err = launch_bwd<112>(qm, dom, km, vm, dqm, p, batch, st);
  else err = launch_bwd<64>(qm, dom, km, vm, dqm, p, batch, st);
  return static_cast<int>(err);
}

}  // namespace

// The backward of flash_attention.  q, dq [B, H, Sq, D]; k, v, dk, dv
// [B, G, Sk, D]; o, dout [B, H, Sq, D]; all bf16 with a contiguous head
// dimension, given by element strides (batch, head, seq): strides[24] holds
// those of q, k, v, o, dout, dq, dk, dv in that order, each a multiple of 8
// elements and every base 16-byte aligned.  lse [B, H, Sq] fp32 from the
// forward; stats fp32 scratch of 2 x B x H x Sq' elements (Sq' = Sq rounded
// up to a multiple of 64), 16-byte aligned.  D in {64, 112, 128, 256}.
// `device`: the CUDA device of the tensors, current for the call.  Two
// launches on `stream` (three at 256: the scratch's rows first); returns
// cudaGetLastError() after the last.
extern "C" int flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* stats, void* dq, void* dk, void* dv, const long long* strides,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int head_dim, float scale,
    float softcap, int causal, int window, int device, void* stream) {
  return backward(q, k, v, o, dout, lse, stats, dq, dk, dv, strides, batch, heads, kv_heads,
                  q_len, kv_len, head_dim, scale, softcap, causal, window, device, stream,
                  nullptr, 0);
}

// flash_attention_bwd, which also writes into `record` (int64, `blocks`
// rows of 4) each dK/dV block's two consumer warpgroups' q steps walked and
// SM clock cycles taken.  Blocks are numbered (batch, kv head, pair) in
// row-major order, B x G x P of them, P = ceil(Sk / 64) / 2 rounded up under
// a causal mask, else ceil(Sk / 64); fewer rows is an invalid value, and
// so is head_dim 256, whose passes keep no record.
extern "C" int flash_attention_bwd_record(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* stats, void* dq, void* dk, void* dv, const long long* strides,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int head_dim, float scale,
    float softcap, int causal, int window, int device, void* stream, void* record,
    long long blocks) {
  return backward(q, k, v, o, dout, lse, stats, dq, dk, dv, strides, batch, heads, kv_heads,
                  q_len, kv_len, head_dim, scale, softcap, causal, window, device, stream,
                  static_cast<long long*>(record), blocks);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
