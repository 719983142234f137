// Shared pieces of the LZ4 and Snappy encode and decode kernels.
//
// All four kernels run one warp per chunk (several chunks per CTA): the
// warp's 32 lanes hold the same parse state, step through the chunk's
// sequences or elements together, and share the byte work of each
// (comparisons by ballot, copies and LSIC runs one byte per lane).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpucomp_lz4 {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = 32 * kWarpsPerBlock;
constexpr int kMinMatch = 4;

// The chunk this warp works on, or -1 past the batch (uniform per warp).
__device__ __forceinline__ long long warp_chunk(long long batch) {
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  return b < batch ? b : -1;
}

// out[o + k] = out[o - off + k mod off] for k < len (1 <= off <= o; len
// is at most the output capacity, below 2**31).  Reads only bytes before
// o, so a self-overlapping match needs no ordering among the lanes.
__device__ __forceinline__ void copy_match(uint8_t* out, long long o, long long off, long long len,
                                           int lane) {
  const uint8_t* src = out + o - off;
  if (off >= len) {
    for (long long k = lane; k < len; k += 32) out[o + k] = src[k];
  } else {
    const unsigned period = (unsigned)off;
    for (long long k = lane; k < len; k += 32) out[o + k] = src[(unsigned)k % period];
  }
}

}  // namespace tpucomp_lz4
