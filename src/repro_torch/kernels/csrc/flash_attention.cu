// FlashAttention-2 style prefill attention for Hopper (sm_90a), bf16 in and
// out, fp32 softmax state and accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _attn_kernel).  Same mask set: causal, sliding window
// ((q - k) < window), logit softcap c * tanh(s / c), keys past kv_len never
// attend, q length != kv length.  Rows that no key may attend give zeros.
//
// On the TPU the kv axis is the innermost, sequential grid axis and the
// running (max, sum, acc) state sits in VMEM scratch between grid steps.
// Here one block of 4 warps owns one (batch, head, 64-row q tile) and loops
// over the 64-row kv tiles itself; the running state lives in registers.
// Each warp owns 16 q rows.  Both products run on the tensor cores through
// mma.sync m16n8k16 (bf16 x bf16 -> fp32): S = Q K^T with Q held in
// registers for the whole loop, then P V with P re-packed from the S
// accumulators to bf16 A fragments without a trip through shared memory,
// and V read as B fragments with ldmatrix.trans.  Grouped-query attention
// reads kv head h / (heads / kv_heads) directly, so the kv heads are never
// repeated in memory.  Tiles entirely above the causal diagonal or
// entirely outside the window are skipped.
//
// What bounds it on an H100: at the DBRX prefill shape (q [4,48,512,128],
// kv [4,8,512,128]) the bytes of q, k, v and o (about 59 MB, 17.5 us at
// 3.35 TB/s) and the causal half of the two products (12.9 GFLOP, 13 us at
// 989 TFLOP/s) are close, so both matter.  This first version loads the kv
// tiles with plain 16-byte loads and no pipelining; wgmma and TMA come later.
//
// q, k, v and o are addressed through element strides (batch, head, seq)
// with a contiguous head dimension, so [B, S, H, D] buffers are read and
// written without a transposing copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // q rows per block (16 per warp)
constexpr int kBlockN = 64;   // kv rows per tile
constexpr int kThreads = 128;
// bf16 padding per shared row.  Row pitches of 72, 120 and 136 bf16 (36, 60
// and 68 words) put the 8 rows of every fragment load and ldmatrix in
// distinct banks, and keep each row 16-byte aligned.  Head dims are
// multiples of 16 (the m16n8k16 k-step): 112 = 7 x 16 for Zamba2.
constexpr int kPad = 8;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int heads, kv_heads, q_len, kv_len;
  float scale, softcap;  // softcap <= 0: none
  int causal, window;    // window <= 0: none
};

__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const Params p) {
  constexpr int LD = HD + kPad;
  constexpr int kChunks = HD / 8;  // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockM * LD;
  __nv_bfloat16* Vs = Ks + kBlockN * LD;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (p.heads / p.kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // fragment row within the 8-row group
  const int tig = lane & 3;   // thread in group: fragment column pair

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + g * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + g * p.v_sh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int c = tid; c < kBlockM * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    uint4 val = zero;
    if (q0 + r < p.q_len)
      val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.q_ss + col);
    *reinterpret_cast<uint4*>(Qs + r * LD + col) = val;
  }
  __syncthreads();

  const int wr = warp * 16;
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const __nv_bfloat16* base = Qs + (wr + gid) * LD + kk * 16 + tig * 2;
    qf[kk][0] = lds32(base);
    qf[kk][1] = lds32(base + 8 * LD);
    qf[kk][2] = lds32(base + 8);
    qf[kk][3] = lds32(base + 8 * LD + 8);
  }

  const int row0 = q0 + wr + gid;  // this thread's two q rows
  const int row1 = row0 + 8;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's columns only; reduced at the end
  float acc[HD / 8][4];
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  int kv_begin = 0;
  int kv_end = p.kv_len;
  if (p.causal) kv_end = min(kv_end, min(q0 + kBlockM, p.q_len));
  if (p.window > 0) kv_begin = max(0, q0 - p.window + 1);
  kv_begin = (kv_begin / kBlockN) * kBlockN;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the previous tile
    for (int c = tid; c < kBlockN * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      uint4 kval = zero, vval = zero;
      if (k0 + r < p.kv_len) {
        kval = *reinterpret_cast<const uint4*>(kb + (k0 + r) * p.k_ss + col);
        vval = *reinterpret_cast<const uint4*>(vb + (k0 + r) * p.v_ss + col);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + col) = kval;
      *reinterpret_cast<uint4*>(Vs + r * LD + col) = vval;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
        const __nv_bfloat16* kbase = Ks + (n * 8 + gid) * LD + kk * 16 + tig * 2;
        mma_bf16_16816(s[n], qf[kk], lds32(kbase), lds32(kbase + 8));
      }
    }

    // scale, softcap, mask; row maxima over the 4 threads of each row group
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (e < 2) ? row0 : row1;
        const int c = k0 + n * 8 + tig * 2 + (e & 1);
        float x = s[n][e] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool ok = c < p.kv_len;
        if (p.causal) ok = ok && (r >= c);
        if (p.window > 0) ok = ok && (r - c < p.window);
        x = ok ? x : -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;  // nothing attended yet
      corr[r] = __expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = __expf(s[n][e] - m_use[e >> 1]);
        s[n][e] = pe;
        l_run[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int dn = 0; dn < HD / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P V: the S accumulators of n-tiles (2j, 2j+1) are the A fragment
    // of k-step j; V comes in as B fragments through ldmatrix.trans.
#pragma unroll
    for (int j = 0; j < kBlockN / 16; ++j) {
      uint32_t pa[4];
      pa[0] = pack_bf16x2(s[2 * j][0], s[2 * j][1]);
      pa[1] = pack_bf16x2(s[2 * j][2], s[2 * j][3]);
      pa[2] = pack_bf16x2(s[2 * j + 1][0], s[2 * j + 1][1]);
      pa[3] = pack_bf16x2(s[2 * j + 1][2], s[2 * j + 1][3]);
      const __nv_bfloat16* vrow = Vs + (j * 16 + (lane & 15)) * LD;
#pragma unroll
      for (int dn = 0; dn < HD / 8; ++dn) {
        const uint32_t addr =
            static_cast<uint32_t>(__cvta_generic_to_shared(vrow + dn * 8));
        uint32_t b0, b1;
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
            : "=r"(b0), "=r"(b1)
            : "r"(addr));
        mma_bf16_16816(acc[dn], pa, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[r] = l > 0.f ? 1.f / l : 0.f;
  }
  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int dn = 0; dn < HD / 8; ++dn) {
    const int col = dn * 8 + tig * 2;
    if (row0 < p.q_len)
      *reinterpret_cast<uint32_t*>(ob + row0 * p.o_ss + col) =
          pack_bf16x2(acc[dn][0] * inv[0], acc[dn][1] * inv[0]);
    if (row1 < p.q_len)
      *reinterpret_cast<uint32_t*>(ob + row1 * p.o_ss + col) =
          pack_bf16x2(acc[dn][2] * inv[1], acc[dn][3] * inv[1]);
  }
}

template <int HD>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = (kBlockM + 2 * kBlockN) * (HD + kPad) * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.q_len + kBlockM - 1) / kBlockM, p.heads, batch);
  flash_attention_kernel<HD><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, Sq, D], k/v [B, G, Sk, D], o [B, H, Sq, D], bf16, each given by
// element strides (batch, head, seq) with a contiguous head dimension D in
// {64, 112, 128}.  window <= 0 and softcap <= 0 mean none.  Launches on
// `stream`; returns cudaGetLastError() after the launch.
extern "C" int flash_attention(
    const void* q, const void* k, const void* v, void* o,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int batch, int heads, int kv_heads, int q_len, int kv_len, int head_dim,
    float scale, float softcap, int causal, int window, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.heads = heads; p.kv_heads = kv_heads; p.q_len = q_len; p.kv_len = kv_len;
  p.scale = scale; p.softcap = softcap; p.causal = causal; p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (head_dim == 128) {
    err = launch<128>(p, batch, s);
  } else if (head_dim == 112) {
    err = launch<112>(p, batch, s);
  } else if (head_dim == 64) {
    err = launch<64>(p, batch, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
