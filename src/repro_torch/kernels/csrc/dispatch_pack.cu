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

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
