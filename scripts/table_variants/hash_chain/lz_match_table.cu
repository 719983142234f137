// A variant of the LZ match-table kernel for the A/B in
// scripts/torch_table_ab.py: hash chains in shared memory, the design the
// shipped kernel (tpucomp_torch/csrc/lz_match_table.cu, an exact radix
// sort of the 4-byte windows) was chosen against.  Same C interface and
// the same table: out[b, i] is the distance to the exact nearest previous
// occurrence of the 4-byte window at i, within the limits, else 0.
//
// One CTA of 1,024 threads takes a row at a time and walks it in tiles of
// 1,024 positions, in order:
//   1. each valid position (<= n - 4, stride-aligned) hashes its window
//      (13 bits, multiplicative); a stable cub::BlockRadixSort of
//      (hash, position in the tile) puts the tile's positions of one hash
//      next to each other in position order;
//   2. each position's link is the distance to the previous position of
//      its hash: its neighbour in the sorted tile, or the head table's
//      entry (the last position of the hash before the tile); the links go
//      into a ring in shared memory that holds the last 65,536 + 1,024
//      positions; the last position of each hash becomes its head;
//   3. each query position walks its links with the exact 4-byte compare
//      (the bytes read through L1 from the row) and stops at the first
//      equal window or past max_offset.
//
// Worst case: the walk depends on the data.  A row whose windows are all
// distinct and all in one bucket of the hash walks the whole window at
// every position: 65,535 / stride links, each a dependent read.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>

namespace {

constexpr int kThreads = 1024;
constexpr int kHashBits = 13;
constexpr int kNone = 1 << kHashBits;  // the sort key of a position with no window
constexpr int kRing = 65536 + kThreads;  // links of every position a tile's walks may reach
using Sort = cub::BlockRadixSort<uint16_t, kThreads, 1, uint16_t>;

struct Shared {
  typename Sort::TempStorage sort;
  int head[1 << kHashBits];  // the last position of each hash before the tile, or -1
  uint16_t link[kRing];      // position % kRing -> distance to the previous position of its hash (0: none in 65535)
  uint16_t skey[kThreads];   // the tile's hashes in sorted order
  uint16_t spos[kThreads];   // and their places in the tile
};

struct TableParams {
  const uint8_t* data;
  const int32_t* lengths;
  uint16_t* out;
  long long batch, row_bytes;
  int stride, max_offset, end_margin;
};

__device__ __forceinline__ unsigned key_at(const uint8_t* row, int i) {
  return (unsigned)__ldg(row + i) | (unsigned)__ldg(row + i + 1) << 8 | (unsigned)__ldg(row + i + 2) << 16 |
         (unsigned)__ldg(row + i + 3) << 24;
}

__device__ __forceinline__ int hash_of(unsigned key) { return (int)((key * 2654435761u) >> (32 - kHashBits)); }

__global__ void __launch_bounds__(kThreads, 1) lz_match_table_chain_kernel(TableParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  const int tid = threadIdx.x, c = (int)p.row_bytes, stride = p.stride;
  for (long long b = blockIdx.x; b < p.batch; b += gridDim.x) {
    const uint8_t* row = p.data + b * p.row_bytes;
    uint16_t* out = p.out + b * p.row_bytes;
    const int n = (int)min((long long)max(p.lengths[b], 0), p.row_bytes);
    __syncthreads();  // the previous row is done with the shared memory
    for (int k = tid; k < (1 << kHashBits); k += kThreads) sh.head[k] = -1;
    for (int t0 = 0; t0 < c; t0 += kThreads) {
      const int i = t0 + tid;
      if (t0 >= n - 3) {  // no valid position left in the row
        if (i < c) out[i] = 0;
        continue;
      }
      const bool valid = i < n - 3 && i % stride == 0;
      const unsigned key = valid ? key_at(row, i) : 0u;
      uint16_t k[1] = {(uint16_t)(valid ? hash_of(key) : kNone)};
      uint16_t v[1] = {(uint16_t)tid};
      __syncthreads();  // the head table's reset, or the last tile's heads and walks, are done
      Sort(sh.sort).Sort(k, v, 0, kHashBits + 1);
      sh.skey[tid] = k[0];
      sh.spos[tid] = v[0];
      __syncthreads();
      const bool has = k[0] != kNone;
      const bool last = has && (tid == kThreads - 1 || sh.skey[tid + 1] != k[0]);
      if (has) {
        const int pos = t0 + v[0];
        const int prev = tid > 0 && sh.skey[tid - 1] == k[0] ? t0 + sh.spos[tid - 1] : sh.head[k[0]];
        const int d = pos - prev;
        sh.link[pos % kRing] = (uint16_t)(prev >= 0 && d <= 65535 ? d : 0);
      }
      __syncthreads();  // every link of the tile is in, every head read
      if (last) sh.head[k[0]] = t0 + v[0];
      if (i < c) {
        int dist = 0;
        if (valid && i <= n - p.end_margin) {
          for (int j = i;;) {
            const int d = sh.link[j % kRing];
            if (d == 0) break;
            j -= d;
            if (i - j > p.max_offset) break;
            if (key_at(row, j) == key) {
              dist = i - j;
              break;
            }
          }
        }
        out[i] = (uint16_t)dist;
      }
    }
  }
}

}  // namespace

extern "C" int tc_lz_match_table_grid(long long batch, long long row_bytes, long long* scratch_bytes) {
  int dev, sms, per_sm;
  const int smem = (int)sizeof(Shared);
  cudaError_t err = cudaFuncSetAttribute(lz_match_table_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lz_match_table_chain_kernel, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  *scratch_bytes = 0;
  (void)row_bytes;
  return (int)(batch < (long long)sms * per_sm ? batch : (long long)sms * per_sm);
}

extern "C" int tc_lz_match_table(const void* data, const void* lengths, void* out, void* scratch, long long batch,
                                 long long row_bytes, int stride, int max_offset, int end_margin, int grid,
                                 void* stream) {
  (void)scratch;
  const int smem = (int)sizeof(Shared);
  cudaError_t err = cudaFuncSetAttribute(lz_match_table_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  TableParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                static_cast<uint16_t*>(out), batch, row_bytes, stride, max_offset, end_margin};
  lz_match_table_chain_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
