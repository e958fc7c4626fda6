// Bitmap-driven dispatch packing for Hopper (sm_90a), one launch per call.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dispatch_pack.py
// (dispatch_pack / _pack_kernel).  Row i of tokens [N, H] goes to every
// destination d whose bit is set in bitmap[i], if valid[i]; slots are taken
// in token order, C per destination, overflow is dropped, and empty slots
// hold zeros in out [D, C, H] and -1 in src_idx [D, C].
//
// The TPU kernel walks its grid in order and carries a running slot counter
// in SMEM from one row block to the next.  Blocks on Hopper run in no order,
// so each block finds its own rows: the grid is (slot tile x destination),
// 1 to 16 slots a tile, and a block ranks the rows wanted by its destination in
// token order, 2,048 rows a step (a warp __ballot_sync of 32 rows and
// __popc for the ranks inside a warp, the 8 warp totals in shared memory
// across warps), stopping as soon as the ranks pass its last slot.  It
// writes its part of src_idx, then copies its slots' rows, or zero-fills
// the empty ones.  The bitmap and valid flags are 5 bytes a row,
// read from L2 by every block of a destination; no second pass and no
// second launch.  At decode (N = 4 to 6 rows) a call is one small launch.
//
// The work is data movement: it is bounded by the bytes of the rows read
// and the packed buffer written.  A block's slots lie back to back in out,
// so its 256 threads copy them as one flat run of 16-byte words, eight
// independent loads in flight a thread: a decode slot of 12 KB takes one
// round, not the 24 of one warp walking its row.  The copy is of raw
// bytes, so the result is bit-exact for any 2- or 4-byte element type.
// The tile is the largest that still gives 8 blocks an SM: 2 slots for the
// D = 1 stages of DBRX prefill (C = 2,560 and 3,200: 1,280 and 1,600
// blocks), 8 for its D = 16 stage (1,280), one slot at decode, where a call
// is one block a slot.  The packed buffer is written with streaming stores,
// so that L2 keeps the token rows that several destinations read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSlots = 16;              // slots a block, at most
constexpr int kBlocksPerSm = 8;           // blocks an SM that fill the card
constexpr int kBallots = 8;                // ballots of 32 rows a warp per step
constexpr int kRankTile = kBallots * kThreads;   // rows ranked a step
constexpr int kInFlight = 8;               // 16-byte loads in flight a thread

__global__ void __launch_bounds__(kThreads)
dispatch_pack_kernel(const uint8_t* __restrict__ tokens,
                     const int32_t* __restrict__ bitmap,
                     const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ out, int32_t* __restrict__ src_idx,
                     int n, long long row_bytes, int num_dests, int capacity, int slots,
                     int vec16) {
  __shared__ int warp_sums[kWarps];
  __shared__ int slot_src[kMaxSlots];
  // destinations vary fastest, so the blocks in flight together copy slots
  // of about the same rank for every destination: the same token rows,
  // read once from device memory and again from L2
  const int d = blockIdx.x % num_dests;
  const int s0 = blockIdx.x / num_dests * slots;
  const int s_end = min(s0 + slots, capacity);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < kMaxSlots) slot_src[tid] = -1;
  __syncthreads();

  // ---- rank the rows wanted by d in token order, up to slot s_end ----
  const unsigned lower_lanes = (1u << lane) - 1u;
  int base = 0;   // rows wanted before this step (the same in every thread)
  for (int start = 0; start < n && base < s_end; start += kRankTile) {
    const int wrow = start + 32 * kBallots * warp;
    unsigned ballot[kBallots];
    int wtotal = 0;
#pragma unroll
    for (int q = 0; q < kBallots; ++q) {
      const int i = wrow + 32 * q + lane;
      const bool want = i < n && valid[i] != 0 && ((bitmap[i] >> d) & 1);
      ballot[q] = __ballot_sync(0xffffffffu, want);
      wtotal += __popc(ballot[q]);
    }
    if (lane == 0) warp_sums[warp] = wtotal;
    __syncthreads();
    int before = base, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int ws = warp_sums[w];
      before += w < warp ? ws : 0;
      total += ws;
    }
    if (before < s_end && before + wtotal > s0) {   // warp-uniform
#pragma unroll
      for (int q = 0; q < kBallots; ++q) {
        const int rank = before + __popc(ballot[q] & lower_lanes);
        if (((ballot[q] >> lane) & 1) && rank >= s0 && rank < s_end)
          slot_src[rank - s0] = wrow + 32 * q + lane;
        before += __popc(ballot[q]);
      }
    }
    base += total;
    __syncthreads();   // warp_sums is rewritten next step; slot_src is final
  }

  // ---- the slot map, then the block's slots, which lie back to back in
  //      out: every thread copies every kThreads-th unit of them, kInFlight
  //      loads at a time ----
  const int ns = s_end - s0;
  if (tid < ns) src_idx[(int64_t)d * capacity + s0 + tid] = slot_src[tid];
  uint8_t* dst = out + ((int64_t)d * capacity + s0) * row_bytes;
  if (vec16) {
    const int words = (int)(row_bytes >> 4);
    const int total = ns * words;
    const uint4* t4 = reinterpret_cast<const uint4*>(tokens);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int f0 = tid; f0 < total; f0 += kInFlight * kThreads) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f0 + u * kThreads;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (f < total) {
          const int s = f / words;
          const int src = slot_src[s];
          if (src >= 0) v[u] = __ldg(t4 + (int64_t)src * words + (f - s * words));
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f0 + u * kThreads;
        if (f < total) __stcs(d4 + f, v[u]);   // streamed: keep L2 for the rows
      }
    }
  } else {  // rows not a multiple of 16 bytes: copy 2-byte units
    const int halves = (int)(row_bytes >> 1);
    const int total = ns * halves;
    const uint16_t* t2 = reinterpret_cast<const uint16_t*>(tokens);
    uint16_t* d2 = reinterpret_cast<uint16_t*>(dst);
    for (int f = tid; f < total; f += kThreads) {
      const int s = f / halves;
      const int src = slot_src[s];
      d2[f] = src >= 0 ? t2[(int64_t)src * halves + (f - s * halves)] : 0;
    }
  }
}

// ---- the backward: grad_tokens[n] = sum over (d, c) with src_idx[d, c] = n
//      of grad_out[d, c], in ascending d, in fp32, rounded once ----
//
// Replaces the gradient that JAX takes through the reference's
// pack_by_bitmap (a gather, so a scatter-add back).  A row fills at most one
// slot per destination, so the sum has at most D <= 31 terms.  No atomics:
// the slot map is inverted first (slot_of [D, N], -1 where a row holds no
// slot of d; every (d, n) is written at most once), then one block a source
// row reads its D slot numbers into shared memory and adds its slots' rows in
// ascending d, 16-byte words at a time.  So the sums come out in one fixed
// order, bit-identical from run to run and to the plain version.  Bounded by
// bytes, as the forward: the packed gradient read once, the rows written
// once.

__global__ void invert_slots_kernel(const int32_t* __restrict__ src_idx,
                                    int32_t* __restrict__ slot_of, int n,
                                    int capacity, long long slots) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= slots) return;
  const int src = src_idx[e];
  if (src < 0 || src >= n) return;
  const int d = (int)(e / capacity);
  slot_of[(long long)d * n + src] = (int)(e - (long long)d * capacity);
}

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// grid: one block per source row; row elements in units of kVec values
template <typename T>
__global__ void __launch_bounds__(kThreads)
dispatch_pack_bwd_kernel(const T* __restrict__ grad_out,
                         const int32_t* __restrict__ slot_of,
                         T* __restrict__ grad_tokens, int n, int h,
                         int num_dests, int capacity, int vec16) {
  __shared__ int slot[32];
  const int row = blockIdx.x;
  if (threadIdx.x < num_dests)
    slot[threadIdx.x] = slot_of[(long long)threadIdx.x * n + row];
  __syncthreads();
  T* dst = grad_tokens + (long long)row * h;
  if (vec16) {
    constexpr int kVec = 16 / sizeof(T);
    const int units = h / kVec;
    for (int u = threadIdx.x; u < units; u += kThreads) {
      float acc[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
      for (int d = 0; d < num_dests; ++d) {
        const int s = slot[d];
        if (s < 0) continue;
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(
            grad_out + ((long long)d * capacity + s) * h) + u);
        const T* x = reinterpret_cast<const T*>(&w);
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[i] += to_f32<T>(x[i]);
      }
      uint4 w;
      T* y = reinterpret_cast<T*>(&w);
#pragma unroll
      for (int i = 0; i < kVec; ++i) y[i] = from_f32<T>(acc[i]);
      reinterpret_cast<uint4*>(dst)[u] = w;
    }
  } else {
    for (int e = threadIdx.x; e < h; e += kThreads) {
      float acc = 0.f;
      for (int d = 0; d < num_dests; ++d) {
        const int s = slot[d];
        if (s >= 0) acc += to_f32<T>(grad_out[((long long)d * capacity + s) * h + e]);
      }
      dst[e] = from_f32<T>(acc);
    }
  }
}

}  // namespace

// tokens [n, row_bytes] (raw bytes), bitmap [n] int32, valid [n] bool,
// out [num_dests * capacity, row_bytes], src_idx [num_dests * capacity] int32.
// vec16 != 0 when row_bytes and both row pointers are 16-byte aligned;
// num_sms is the card's count of SMs.  Launches on `stream`; returns cudaGetLastError() after the launch.
extern "C" int dispatch_pack(const void* tokens, const void* bitmap,
                             const void* valid, void* out, void* src_idx,
                             int n, long long row_bytes, int num_dests,
                             int capacity, int vec16, int num_sms,
                             void* stream) {
  // a block's slots are counted in 32-bit units: 16 rows of up to 128 MB
  if (num_dests < 1 || num_dests > 31 || capacity < 1 || n < 0 || row_bytes < 2 ||
      row_bytes > (1LL << 27) || num_sms < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the largest tile (up to 16 slots) that still gives kBlocksPerSm
  // blocks an SM: small tiles spread the copy evenly over the SMs, large
  // ones rank the bitmap fewer times
  const long long wanted = (long long)kBlocksPerSm * num_sms;
  int slots = kMaxSlots;
  while (slots > 1 && (long long)num_dests * ((capacity + slots - 1) / slots) < wanted)
    slots /= 2;
  const long long blocks = (long long)num_dests * ((capacity + slots - 1) / slots);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dispatch_pack_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tokens), static_cast<const int32_t*>(bitmap),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(src_idx), n, row_bytes, num_dests, capacity, slots, vec16);
  return static_cast<int>(cudaGetLastError());
}

// grad_out [num_dests, capacity, h] (fp32 when fp32 != 0, else bf16),
// src_idx [num_dests, capacity] int32, slot_of [num_dests, n] int32 scratch,
// grad_tokens [n, h] in grad_out's type.  Three operations on `stream`: the
// scratch set to -1, the slot map inverted, the rows summed.  Returns
// cudaGetLastError() after the last launch.
extern "C" int dispatch_pack_bwd(const void* grad_out, const void* src_idx,
                                 void* slot_of, void* grad_tokens, int n, int h,
                                 int num_dests, int capacity, int fp32,
                                 void* stream) {
  if (num_dests < 1 || num_dests > 31 || capacity < 1 || n < 1 || h < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(slot_of, 0xff,
                                    (size_t)num_dests * n * sizeof(int32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long slots = (long long)num_dests * capacity;
  invert_slots_kernel<<<(unsigned)((slots + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      static_cast<const int32_t*>(src_idx), static_cast<int32_t*>(slot_of), n, capacity,
      slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int esize = fp32 ? 4 : 2;
  const uintptr_t align = reinterpret_cast<uintptr_t>(grad_out) |
                          reinterpret_cast<uintptr_t>(grad_tokens);
  const int vec16 = ((long long)h * esize) % 16 == 0 && align % 16 == 0;
  if (fp32)
    dispatch_pack_bwd_kernel<float><<<n, kThreads, 0, st>>>(
        static_cast<const float*>(grad_out), static_cast<const int32_t*>(slot_of),
        static_cast<float*>(grad_tokens), n, h, num_dests, capacity, vec16);
  else
    dispatch_pack_bwd_kernel<__nv_bfloat16><<<n, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(grad_out), static_cast<const int32_t*>(slot_of),
        static_cast<__nv_bfloat16*>(grad_tokens), n, h, num_dests, capacity, vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
