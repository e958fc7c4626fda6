// Bitmap-driven dispatch packing for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/dispatch_pack.py
// (dispatch_pack / _pack_kernel).  Row i of tokens [N, H] goes to every
// destination d whose bit is set in bitmap[i], if valid[i]; slots are taken
// in token order, C per destination, overflow is dropped, and empty slots
// hold zeros in out [D, C, H] and -1 in src_idx [D, C].
//
// The TPU kernel walks its grid in order and carries a running slot counter
// in SMEM from one row block to the next.  Blocks on Hopper run in no order,
// so the slot of every row is computed first, then the rows are copied:
//
//   pass 1  one block per destination: a block-wide exclusive scan over the
//           N rows, tile by tile, writes src_idx[d, slot] for kept rows and
//           -1 into the slots left empty;
//   pass 2  one warp per (d, c) slot copies its source row with 16-byte
//           loads and stores (or writes zeros).
//
// The work is pure data movement: it is bounded by the bytes of the rows read
// and the packed buffer written.  Pass 2 keeps neighbouring lanes on
// neighbouring 16-byte words so each warp moves whole 512-byte lines.
// The copy is of raw bytes, so the result is bit-exact for any 2- or 4-byte
// element type.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kScanThreads = 1024;
constexpr int kCopyThreads = 256;

__global__ void __launch_bounds__(kScanThreads)
pack_slots_kernel(const int32_t* __restrict__ bitmap,
                  const uint8_t* __restrict__ valid,
                  int32_t* __restrict__ src_idx, int n, int capacity) {
  __shared__ int warp_sums[kScanThreads / 32];
  __shared__ int tile_total;
  const int d = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int32_t* slots = src_idx + (int64_t)d * capacity;

  int base = 0;  // rows kept so far for destination d (same in every thread)
  for (int start = 0; start < n && base < capacity; start += kScanThreads) {
    const int i = start + tid;
    const int flag = (i < n && valid[i] != 0 && ((bitmap[i] >> d) & 1)) ? 1 : 0;
    int x = flag;  // inclusive scan inside the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int w = warp_sums[lane];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
      if (lane == 31) tile_total = w;
    }
    __syncthreads();
    const int pos = base + x - flag + (warp > 0 ? warp_sums[warp - 1] : 0);
    if (flag && pos < capacity) slots[pos] = i;
    base += tile_total;
    __syncthreads();  // warp_sums and tile_total are rewritten next tile
  }
  for (int c = min(base, capacity) + tid; c < capacity; c += kScanThreads) {
    slots[c] = -1;
  }
}

__global__ void __launch_bounds__(kCopyThreads)
pack_rows_kernel(const uint8_t* __restrict__ tokens,
                 const int32_t* __restrict__ src_idx,
                 uint8_t* __restrict__ out, int64_t num_slots,
                 int64_t row_bytes, int vec16) {
  const int64_t slot =
      (int64_t)blockIdx.x * (kCopyThreads / 32) + (threadIdx.x >> 5);
  if (slot >= num_slots) return;
  const int lane = threadIdx.x & 31;
  const int src = src_idx[slot];
  uint8_t* dst = out + slot * row_bytes;
  if (vec16) {
    const int64_t words = row_bytes >> 4;
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    if (src >= 0) {
      const uint4* s4 =
          reinterpret_cast<const uint4*>(tokens + (int64_t)src * row_bytes);
      for (int64_t w = lane; w < words; w += 32) d4[w] = __ldg(s4 + w);
    } else {
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int64_t w = lane; w < words; w += 32) d4[w] = zero;
    }
  } else {  // rows not a multiple of 16 bytes: copy 2-byte units
    const int64_t halves = row_bytes >> 1;
    uint16_t* d2 = reinterpret_cast<uint16_t*>(dst);
    if (src >= 0) {
      const uint16_t* s2 =
          reinterpret_cast<const uint16_t*>(tokens + (int64_t)src * row_bytes);
      for (int64_t w = lane; w < halves; w += 32) d2[w] = s2[w];
    } else {
      for (int64_t w = lane; w < halves; w += 32) d2[w] = 0;
    }
  }
}

}  // namespace

// tokens [n, row_bytes] (raw bytes), bitmap [n] int32, valid [n] bool,
// out [num_dests * capacity, row_bytes], src_idx [num_dests * capacity] int32.
// vec16 != 0 when row_bytes and both row pointers are 16-byte aligned.
// Launches on `stream`; returns cudaGetLastError() after the launches.
extern "C" int dispatch_pack(const void* tokens, const void* bitmap,
                             const void* valid, void* out, void* src_idx,
                             int n, long long row_bytes, int num_dests,
                             int capacity, int vec16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pack_slots_kernel<<<num_dests, kScanThreads, 0, s>>>(
      static_cast<const int32_t*>(bitmap), static_cast<const uint8_t*>(valid),
      static_cast<int32_t*>(src_idx), n, capacity);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long num_slots = (long long)num_dests * capacity;
  const long long per_block = kCopyThreads / 32;
  const unsigned blocks = (unsigned)((num_slots + per_block - 1) / per_block);
  pack_rows_kernel<<<blocks, kCopyThreads, 0, s>>>(
      static_cast<const uint8_t*>(tokens), static_cast<const int32_t*>(src_idx),
      static_cast<uint8_t*>(out), num_slots, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
