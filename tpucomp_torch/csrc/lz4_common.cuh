// The launch shape of the LZ4 and Snappy encode and decode kernels, and
// zero_fill, which all four use (the rest they share is in
// lz_encode_common.cuh and lz_decode_common.cuh, which include this).
//
// All four run one warp per chunk (several chunks per CTA): the warp's 32
// lanes hold the same parse state, step through the chunk's sequences
// together, and share the byte work of each (comparisons by ballot,
// output bytes one per lane).  The LZ4 decode kernel adds a second warp to
// a chunk where one is idle, for the copies (lz4_handoff.cuh).  The
// match-table kernel (lz_match_table.cu) has its own shape: one CTA of
// 1,024 threads per job.
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

// out[from, to) = 0 (device memory only: nothing reads these bytes back).
__device__ __forceinline__ void zero_fill(uint8_t* out, int from, int to, int lane) {
  if (from >= to) return;
  const int head = min(to - from, (int)((16 - (reinterpret_cast<uintptr_t>(out + from) & 15)) & 15));
  if (lane < head) out[from + lane] = 0;
  const int i = from + head;
  const int vecs = (to - i) >> 4;
  uint4* v = reinterpret_cast<uint4*>(out + i);
  for (int k = lane; k < vecs; k += 32) v[k] = make_uint4(0, 0, 0, 0);
  const int tail = i + 16 * vecs;
  if (lane < to - tail) out[tail + lane] = 0;
}

}  // namespace tpucomp_lz4
