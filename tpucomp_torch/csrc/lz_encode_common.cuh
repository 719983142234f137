// Shared machinery of the LZ4 and Snappy encode kernels.
//
// One warp encodes one chunk, from the chunk's bytes and its match table
// (lz_match_table.cu: table[i], uint16, the distance to the exact nearest
// previous occurrence of the 4-byte window at i, 0 where i is no
// candidate).  The parse is the pure greedy parse: from anchor a, the
// first candidate q >= a starts a match of its exact, unbounded length m
// at that distance; the next anchor is q + m.
//
//   - encode_walk: the warp reads the table 32 positions at once, a lane
//     each, and finds the next candidate by a ballot.  Each lane with a
//     candidate extends it alone first (lane_extend, up to kLaneCheck
//     bytes), all at once, so the walk hops from candidate to candidate
//     within the 32 positions by shuffles; only a match longer than a lane
//     checked takes the warp-cooperative extension (warp_extend, 128
//     bytes a step).  Lane k keeps the k-th sequence of a batch of 32.
//     After 32 positions with no candidate, the walk tests 256 table
//     entries a step (8 a lane), so a literal run costs a step per 256
//     positions, not per 32.
//   - the format's emitter writes a batch: each lane computes its
//     sequence's size, a prefix sum over the lanes gives their output
//     offsets, the lanes write their headers, and copy_flat lays the
//     batch's literal runs end to end, a byte per lane (runs past 256
//     bytes go warp-wide, one at a time).
//   - zero_fill (lz4_common.cuh) zeroes the row past the stream, so the
//     wrappers allocate the output with torch.empty.
//
// The chunk bytes and the table are read from device memory through L1
// (__ldg); nothing is staged in shared memory.  A form that staged 2 KB of
// the chunk and 1,024 table entries per warp in shared memory, as the
// decoders' Window does, took twice the time on the 256 MB batches
// (scripts/torch_encode_ab.py, PERF.md): a refill per jump past a long
// match, and a range check on every byte read.
#pragma once

#include "lz4_common.cuh"

namespace tpucomp_lze {

using tpucomp_lz4::kFull;
using tpucomp_lz4::kMinMatch;
using tpucomp_lz4::kThreads;
using tpucomp_lz4::kWarpsPerBlock;
using tpucomp_lz4::warp_chunk;
using tpucomp_lz4::zero_fill;

constexpr int kLaneCheck = 16;  // bytes of its match a lane compares alone
constexpr int kSkip = 8;        // table entries a lane tests per step across a run with no candidate

// Inclusive prefix sum over the warp's lanes.
__device__ __forceinline__ int warp_inclusive(int v, int lane) {
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(kFull, v, s);
    if (lane >= s) v += u;
  }
  return v;
}

// The match at p, distance off, compared by one lane: the first k in
// [4, min(limit, kLaneCheck)) with d[p + k] != d[p - off + k], else that
// bound; minus kLaneCheck when the bytes agree up to kLaneCheck < limit
// (the match may go on).  The first 4 bytes are equal by construction of
// the table.
__device__ __forceinline__ int lane_extend(const uint8_t* d, int p, int off, int limit) {
  const int lim = min(limit, kLaneCheck);
  uint8_t x[kLaneCheck - kMinMatch], y[kLaneCheck - kMinMatch];
#pragma unroll
  for (int k = kMinMatch; k < kLaneCheck; ++k) {  // every load before any compare
    x[k - kMinMatch] = k < lim ? __ldg(d + p + k) : 0;
    y[k - kMinMatch] = k < lim ? __ldg(d + p - off + k) : 0;
  }
#pragma unroll
  for (int k = kMinMatch; k < kLaneCheck; ++k)
    if (k < lim && x[k - kMinMatch] != y[k - kMinMatch]) return k;
  return lim < limit ? -kLaneCheck : lim;
}

// Length of the match at q, distance off, known equal for `from` bytes:
// the first k >= from with d[q + k] != d[q - off + k] or k == limit.
// Warp-collective: 128 bytes a step (4 per lane; a ballot and __ffs find
// the first difference).
__device__ __forceinline__ int warp_extend(const uint8_t* d, int q, int off, int limit, int from, int lane) {
  for (int m = from;; m += 128) {
    int first = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = m + 4 * lane + j;
      const bool stop = k >= limit || __ldg(d + q + k) != __ldg(d + q - off + k);
      if (stop && first < 0) first = 4 * lane + j;
    }
    const unsigned hit = __ballot_sync(kFull, first >= 0);
    if (hit) return m + __shfl_sync(kFull, first, __ffs(hit) - 1);
  }
}

// out[dst + k] = src[k] for k < len, for every lane's run (len 0 for none):
// runs of up to kFlatRun bytes laid end to end a byte per lane, then each
// longer run by the whole warp, 4 rounds of loads before their stores.
// Warp-collective.
__device__ __forceinline__ void copy_flat(uint8_t* out, const uint8_t* d, int src, int dst, int len, int lane) {
  constexpr int kFlatRun = 256;
  const int flat = len <= kFlatRun ? len : 0;
  const int end = warp_inclusive(flat, lane);
  const int total = __shfl_sync(kFull, end, 31);
  const int start = end - flat;
  for (int base = 0; base < total; base += 32) {
    const int q = base + lane;
    int e = 0;  // the lane holding flattened byte q: the first whose end passes q
    for (int s = 16; s; s >>= 1)
      if (__shfl_sync(kFull, end, e + s - 1) <= q) e += s;
    const int es = __shfl_sync(kFull, start, e), esrc = __shfl_sync(kFull, src, e);
    const int edst = __shfl_sync(kFull, dst, e);
    if (q < total) out[edst + q - es] = __ldg(d + esrc + q - es);
  }
  for (unsigned big = __ballot_sync(kFull, len > kFlatRun); big; big &= big - 1) {
    const int e = __ffs(big) - 1;
    const int esrc = __shfl_sync(kFull, src, e), edst = __shfl_sync(kFull, dst, e);
    const int elen = __shfl_sync(kFull, len, e);
    for (int k0 = 0; k0 < elen; k0 += 4 * 32) {
      uint8_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 32 * j + lane;
        v[j] = k < elen ? __ldg(d + esrc + k) : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + 32 * j + lane;
        if (k < elen) out[edst + k] = v[j];
      }
    }
  }
}

// out[at + k] = v for k < len, for every lane's run whose len passes
// `own` (a lane writes the shorter ones itself); the last byte of a run
// is `last` instead.  Warp-collective.
__device__ __forceinline__ void fill_runs(uint8_t* out, int at, int len, int v, int last, int own, int lane) {
  for (unsigned big = __ballot_sync(kFull, len > own); big; big &= big - 1) {
    const int e = __ffs(big) - 1;
    const int eat = __shfl_sync(kFull, at, e), elen = __shfl_sync(kFull, len, e);
    const int ev = __shfl_sync(kFull, v, e), elast = __shfl_sync(kFull, last, e);
    for (int k = lane; k < elen; k += 32) out[eat + k] = (uint8_t)(k == elen - 1 ? elast : ev);
  }
  if (len <= own)
    for (int k = 0; k < len; ++k) out[at + k] = (uint8_t)(k == len - 1 ? last : v);
}

// The greedy parse of one chunk of n bytes, batched: emit(lit, ll, off, m,
// count, final) writes `count` sequences held one per lane (lane k: the
// literals [lit, lit + ll), then a match of m bytes at distance off); the
// final batch ends with the literals-only sequence [a, n) (m = 0).
// Candidates lie at most at n - end_margin (the table holds none past it);
// a match ends at most at n - tail.  Warp-collective.
template <class Emit>
__device__ __forceinline__ void encode_walk(const uint8_t* d, const uint16_t* table, int n, int end_margin,
                                            int tail, int lane, Emit& emit) {
  const int last = n - end_margin;
  int a = 0, cnt = 0;
  int s_lit = 0, s_ll = 0, s_off = 0, s_m = 0;
  bool empty = false;  // the last 32 positions held no candidate
  for (int base = 0; base <= last;) {
    // in a run of positions with no candidate, skip 256 positions a step:
    // 8 table entries a lane, a ballot over any of them
    for (; empty && base + 32 * kSkip <= last + 1; base += 32 * kSkip) {
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < kSkip; ++j) any |= __ldg(table + base + kSkip * lane + j);
      const unsigned hit = __ballot_sync(kFull, any != 0);
      if (hit) {
        base += kSkip * (__ffs(hit) - 1);
        break;
      }
    }
    const int p = base + lane;
    const int dl = p <= last ? __ldg(table + p) : 0;
    const int ml = dl ? lane_extend(d, p, dl, n - tail - p) : 0;
    const unsigned cand = __ballot_sync(kFull, dl != 0);
    empty = cand == 0;
    for (;;) {
      const unsigned mask = cand & (a > base ? ~0u << (a - base) : ~0u);
      if (!mask) break;
      const int ql = __ffs(mask) - 1, q = base + ql;
      const int off = __shfl_sync(kFull, dl, ql);
      int m = __shfl_sync(kFull, ml, ql);
      if (m < 0) m = warp_extend(d, q, off, n - tail - q, -m, lane);
      if (lane == cnt) {
        s_lit = a;
        s_ll = q - a;
        s_off = off;
        s_m = m;
      }
      a = q + m;
      if (++cnt == 32) {
        emit(s_lit, s_ll, s_off, s_m, 32, false);
        cnt = 0;
      }
      if (a - base >= 32) break;
    }
    base = max(base + 32, a);
  }
  if (lane == cnt) {
    s_lit = a;
    s_ll = n - a;
    s_off = 0;
    s_m = 0;
  }
  emit(s_lit, s_ll, s_off, s_m, cnt + 1, true);
}

}  // namespace tpucomp_lze
