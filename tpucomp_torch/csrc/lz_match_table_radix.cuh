// The long-row path of the LZ match table (rows past 64 KB), for NVIDIA
// Hopper: an exact stable LSD radix sort of each 64K-position segment's
// 4-byte windows, with the 64K positions before it.  lz_match_table.cu
// includes it and takes it for rows of more than 65,536 bytes; the A/B
// variant scripts/table_variants/radix_lsd takes it for every row, as the
// shipped table did before rows of up to 64 KB got their own kernel.
//
// Output: as lz_match_table.cu's (out[b, i], uint16, the distance to the
// exact nearest previous occurrence of the 4-byte window at i within the
// limits, else 0; every entry written).
//
// Design: exact, with no hash.  A job is one segment of a row: the query
// positions [s, s + 64K) and, for rows past 64 KB, the 64K positions
// before s, which hold every occurrence within the window (<= 65535
// back).  One CTA of 1,024 threads takes a job at a time:
//   1. stage the job's bytes in shared memory (64 KB, or 128 KB past the
//      first segment of a long row);
//   2. sort the job's valid positions by their 4-byte window with a
//      stable LSD radix sort, 4 passes of one byte, each digit read from
//      the staged bytes; a tile of 4,096 positions (4 a thread) is ranked
//      per warp by __match_any_sync and per digit across the warps by a
//      scan, so equal windows keep their positions in order; the tile is
//      then laid out in digit order in shared memory and written with
//      consecutive threads on consecutive places of each digit's run.  The
//      position arrays ping-pong through a global scratch of two arrays per
//      resident CTA (uint16 indices for chunks up to 64 KB);
//   3. each position's predecessor in the sorted order, when its window is
//      equal, is its nearest previous occurrence; the distance is checked
//      against the limits and written.
//
// What bounds it on the H100: the four ranking passes (issue slots and 5
// __syncthreads per tile) and their scratch traffic, 4 reads and writes of
// 2 bytes per position for 64 KB chunks, then the final writes, one per
// position in sorted order, so scattered.  Two CTAs share an SM (at most
// 32 registers a thread, ~105 KB of shared memory each).  On mixed data a
// warp holds many distinct digits, and __match_any_sync then costs most:
// the ranks were 41% of a 64 KB job's cycles.  For 256 MB of mixed in
// 64 KB rows on an H100 at 700 W it took 10.7 ms (PERF.md).
//
// Worst case: no loop depends on the data.  Every job does the same four
// passes over its positions whatever the bytes are (no chain to walk, no
// bucket to overflow); the digits only move which shared-memory banks and
// counters are hit, and how many distinct digits a warp's
// __match_any_sync sees: mixed data (many) costs more than runs (few).
// A 1 MB row of all-distinct windows takes 1.2 ms alone.  Rows past 64 KB
// sort the 64K positions before each segment again, so they cost up to 2x
// a 64 KB row per byte.
//
// Covers rows up to 16 MB (positions fit int32), strides 1, 2 and 4,
// max_offset <= 65535.  It counts nothing for the tracer.
#pragma once

#include "lz4_common.cuh"

namespace tpucomp_lzt {
namespace {

using tpucomp_lz4::kFull;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 1 << 16;   // query positions per job
constexpr int kBack = 1 << 16;  // positions before a job's first query that it also sorts
constexpr int kDigits = 256;
constexpr int kItems = 4;                 // elements a thread ranks per tile
constexpr int kTile = kThreads * kItems;  // elements per tile of a scatter pass

struct TableParams {
  const uint8_t* data;
  const int32_t* lengths;
  uint16_t* out;
  void* scratch;  // 2 * max_elems indices per CTA of the grid
  long long batch, row_bytes, jobs_per_row;
  int stride, max_offset, end_margin, max_elems;
};

// Shared memory of a CTA: the counters and the tile's staging, then the
// staged bytes (dynamic).  Idx holds an element index, so also a place in
// the sorted order (uint16 for jobs of at most 65536 positions).
template <class Idx>
struct Shared {
  unsigned base[4][kDigits];      // per pass: the digit's next free place in the sorted order
  Idx off[kWarps][kDigits];       // per tile: the place of warp w's first element of digit d
  uint8_t cnt[kWarps][kDigits];   // per tile: warp w's count of digit d so far (0 after the scan)
  uint16_t start[kDigits];        // per tile: the first local place of digit d
  unsigned wsum[kDigits / 32];    // per tile: the tile's count of the digits of each 32
  Idx stage[kTile];               // per tile: its elements in digit order
  uint8_t digit[kTile];           // and their digits
};

__device__ __forceinline__ unsigned lanemask_lt(int lane) { return (1u << lane) - 1; }

// The 4-byte window at staged offset r (the bytes r .. r + 3 are staged).
__device__ __forceinline__ unsigned key_at(const uint8_t* sd, int r) {
  return (unsigned)sd[r] | (unsigned)sd[r + 1] << 8 | (unsigned)sd[r + 2] << 16 | (unsigned)sd[r + 3] << 24;
}

template <class Idx>
__global__ void __launch_bounds__(kThreads, 2) lz_match_table_kernel(TableParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  Shared<Idx>& cs = *reinterpret_cast<Shared<Idx>*>(smem);
  uint8_t* sd = smem + sizeof(Shared<Idx>);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Idx* buf0 = static_cast<Idx*>(p.scratch) + (long long)blockIdx.x * 2 * p.max_elems;
  Idx* buf1 = buf0 + p.max_elems;
  const int c = (int)p.row_bytes, stride = p.stride;

  for (long long job = blockIdx.x; job < p.batch * p.jobs_per_row; job += gridDim.x) {
    const long long b = job / p.jobs_per_row;
    const int s = (int)(job % p.jobs_per_row) * kSeg;
    const int qend = min(s + kSeg, c);
    const uint8_t* row = p.data + b * p.row_bytes;
    uint16_t* out = p.out + b * p.row_bytes;
    const int n = (int)min((long long)max(p.lengths[b], 0), p.row_bytes);
    const int pend = min(qend, n - 3);  // valid positions are < n - 3
    const int lo = max(0, s - kBack);   // a multiple of 4, so stride-aligned
    // positions with no element (past n - 4, or off the stride) have no candidate
    for (int i = s + tid; i < qend; i += kThreads)
      if (i >= pend || i % stride) out[i] = 0;
    if (pend <= s) continue;  // no valid query position: the loop above wrote them all
    const int e_count = (pend - lo + stride - 1) / stride;
    const int span = pend + 3 - lo;

    __syncthreads();  // the previous job is done with the shared memory
    for (int k = tid; k < span; k += kThreads) sd[k] = row[lo + k];
    for (int k = tid; k < 4 * kDigits; k += kThreads) (&cs.base[0][0])[k] = 0;
    for (int k = tid; k < kWarps * kDigits; k += kThreads) (&cs.cnt[0][0])[k] = 0;
    __syncthreads();

    // the four digit histograms: a shared-memory atomic a digit, or one a
    // warp when its 32 digits are equal (runs, where the atomics would
    // all hit one counter)
    for (int t0 = 0; t0 < e_count; t0 += kThreads) {
      const int k = t0 + tid;
      const bool valid = k < e_count;
#pragma unroll
      for (int pass = 0; pass < 4; ++pass) {
        const unsigned d = valid ? sd[k * stride + pass] : kDigits;
        const unsigned d0 = __shfl_sync(kFull, d, 0);
        if (__all_sync(kFull, d == d0)) {
          if (lane == 0 && d0 != kDigits) atomicAdd(&cs.base[pass][d0], 32u);
        } else if (valid) {
          atomicAdd(&cs.base[pass][d], 1u);
        }
      }
    }
    __syncthreads();
    if (tid < 4 * 32) {  // exclusive scan of each histogram: warp `pass` scans its 256 digits
      const int pass = tid >> 5;
      unsigned run = 0;
      for (int d0 = 0; d0 < kDigits; d0 += 32) {
        const unsigned v = cs.base[pass][d0 + lane];
        unsigned inc = v;
        for (int sh = 1; sh < 32; sh <<= 1) {
          const unsigned u = __shfl_up_sync(kFull, inc, sh);
          if (lane >= sh) inc += u;
        }
        cs.base[pass][d0 + lane] = run + inc - v;
        run += __shfl_sync(kFull, inc, 31);
      }
    }

    // four stable scatter passes: buf0 <- by byte 0, buf1 <- byte 1, buf0 <- byte 2, buf1 <- byte 3.
    // A tile is kTile elements, kItems a thread; warp w ranks the tile's
    // elements [w * 32 * kItems, (w + 1) * 32 * kItems) in order.
    for (int pass = 0; pass < 4; ++pass) {
      const Idx* src = (pass & 1) ? buf0 : buf1;
      Idx* dst = (pass & 1) ? buf1 : buf0;
      for (int t0 = 0; t0 < e_count; t0 += kTile) {
        __syncthreads();  // the histogram scan, or the last tile's copy-out, is done
        int ev[kItems], dv[kItems], rk[kItems];
#pragma unroll
        for (int g = 0; g < kItems; ++g) {
          const int k = t0 + (warp * kItems + g) * 32 + lane;
          const bool valid = k < e_count;
          ev[g] = !valid ? 0 : (pass == 0 ? k : (int)src[k]);
          dv[g] = valid ? sd[ev[g] * stride + pass] : kDigits;
          const unsigned peers = __match_any_sync(kFull, dv[g]);
          const int prior = valid ? cs.cnt[warp][dv[g]] : 0;
          rk[g] = prior + __popc(peers & lanemask_lt(lane));
          __syncwarp();
          if (valid && (peers & lanemask_lt(lane)) == 0) cs.cnt[warp][dv[g]] = (uint8_t)(prior + __popc(peers));
          __syncwarp();
        }
        __syncthreads();
        unsigned here = 0;  // the tile's count of digit tid
        if (tid < kDigits) {
          const unsigned before = cs.base[pass][tid];
          unsigned run = before;
#pragma unroll 8
          for (int w = 0; w < kWarps; ++w) {
            const unsigned cw = cs.cnt[w][tid];
            cs.off[w][tid] = (Idx)run;
            run += cw;
            cs.cnt[w][tid] = 0;
          }
          cs.base[pass][tid] = run;
          here = run - before;
          unsigned inc = here;  // the tile's local places: a scan over the digits
          for (int sh = 1; sh < 32; sh <<= 1) {
            const unsigned u = __shfl_up_sync(kFull, inc, sh);
            if (lane >= sh) inc += u;
          }
          if (lane == 31) cs.wsum[warp] = inc;
          here = inc - here;
        }
        __syncthreads();
        if (tid < kDigits) {
          for (int w = 0; w < warp; ++w) here += cs.wsum[w];
          cs.start[tid] = (uint16_t)here;
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < kItems; ++g) {
          if (dv[g] == kDigits) continue;
          const int d = dv[g];
          const int place = (int)cs.off[warp][d] + rk[g];
          const int local = place - (int)cs.off[0][d] + cs.start[d];
          cs.stage[local] = (Idx)ev[g];
          cs.digit[local] = (uint8_t)d;
        }
        __syncthreads();
        // consecutive threads write consecutive places of each digit's run
        const int count = min(kTile, e_count - t0);
        for (int k = tid; k < count; k += kThreads) {
          const int d = cs.digit[k];
          dst[(int)cs.off[0][d] + k - cs.start[d]] = cs.stage[k];
        }
      }
    }
    __syncthreads();

    // predecessors in the sorted order (buf1) are the nearest previous occurrences
    const int first_query = (s - lo) / stride;
    for (int k = tid; k < e_count; k += kThreads) {
      const int e = buf1[k];
      if (e < first_query) continue;  // before the segment: another job's query
      const int i = lo + e * stride;
      int dist = 0;
      if (k > 0) {
        const int f = buf1[k - 1];
        if (key_at(sd, f * stride) == key_at(sd, e * stride)) dist = (e - f) * stride;
      }
      out[i] = (uint16_t)(dist <= p.max_offset && i <= n - p.end_margin ? dist : 0);
    }
  }
}

int table_smem(long long row_bytes, int& max_elems) {
  max_elems = (int)min(row_bytes, (long long)(kSeg + kBack));
  const int shared = max_elems <= 65536 ? (int)sizeof(Shared<uint16_t>) : (int)sizeof(Shared<uint32_t>);
  return shared + ((max_elems + 3 + 15) & ~15);
}

// Per call, as the attributes are per device (and cheap to set): the
// dynamic shared memory, and all of the SM's unified memory as shared
// memory, so two CTAs of a 64 KB job fit on an SM.
template <class Idx>
cudaError_t prepare(int smem) {
  const auto kernel = lz_match_table_kernel<Idx>;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// The grid of the radix kernel for `batch` rows of `row_bytes` on the
// current device: the CTAs it holds at once, at most one a job; or minus
// a CUDA error.  Sets *scratch_bytes to the global scratch that grid
// needs (two index arrays a CTA), for the caller to allocate.
int radix_grid(long long batch, long long row_bytes, long long* scratch_bytes) {
  int max_elems, dev, sms, per_sm;
  const int smem = table_smem(row_bytes, max_elems);
  cudaError_t err = max_elems <= 65536 ? prepare<uint16_t>(smem) : prepare<uint32_t>(smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = max_elems <= 65536
              ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lz_match_table_kernel<uint16_t>, kThreads, smem)
              : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lz_match_table_kernel<uint32_t>, kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  const long long jobs = batch * ((row_bytes + kSeg - 1) / kSeg);
  const int grid = (int)min((long long)sms * max(per_sm, 1), jobs);
  *scratch_bytes = (long long)grid * 2 * max_elems * (max_elems <= 65536 ? 2 : 4);
  return grid;
}

// Launches the radix kernel on `stream` with `grid` CTAs, each taking
// jobs (row segments) in turn, with the grid and the scratch of the bytes
// that radix_grid gave for these rows.  Returns the launch's CUDA error
// (0 on success).
int radix_launch(const void* data, const void* lengths, void* out, void* scratch, long long batch,
                        long long row_bytes, int stride, int max_offset, int end_margin, int grid, void* stream) {
  int max_elems;
  const int smem = table_smem(row_bytes, max_elems);
  TableParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                static_cast<uint16_t*>(out), scratch, batch, row_bytes,
                (row_bytes + kSeg - 1) / kSeg, stride, max_offset, end_margin, max_elems};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (max_elems <= 65536) {
    if ((err = prepare<uint16_t>(smem)) != cudaSuccess) return (int)err;
    lz_match_table_kernel<uint16_t><<<grid, kThreads, smem, st>>>(p);
  } else {
    if ((err = prepare<uint32_t>(smem)) != cudaSuccess) return (int)err;
    lz_match_table_kernel<uint32_t><<<grid, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tpucomp_lzt
