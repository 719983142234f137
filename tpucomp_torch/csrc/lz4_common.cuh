// Shared constants of the LZ4 encode and decode kernels.
//
// Both kernels run one warp per chunk (several chunks per CTA): the
// warp's 32 lanes hold the same parse state, step through the chunk's
// sequences together, and share the byte work of each sequence
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

}  // namespace tpucomp_lz4
