// Shared machinery of the LZ4 and Snappy decode kernels.
//
// One warp decodes one chunk (the LZ4 kernel hands a chunk's copies to a
// second warp where one is idle: lz4_handoff.cuh).  Its 32 lanes walk the
// stream together (the walk's state is uniform, in registers), and share
// the bytes:
//
//   - Window: the compressed row staged in shared memory, kWin bytes a
//     warp, refilled with 16-byte loads as the walk moves on.  `at` reads
//     a byte with the index clamped into the row, from the window when it
//     holds it and from device memory otherwise: one accessor, so no read
//     depends on where the window stands.  The refill waits for its loads
//     (no cp.async ahead of the walk): refills are 1-2% of a step's
//     cycles on the mixed corpus (scripts/torch_decode_clocks.py).
//   - the kernels' walks read 32 stream positions at once, a lane each,
//     and hop between the lanes by shuffles; lane k keeps the k-th
//     element's fields.  Then each lane checks its own element, all at
//     once, and write_batch writes the batch: all literals, and all
//     matches whose source ends before the batch's first output byte,
//     together, a byte per lane over the batch's flattened bytes; then
//     each match that reads the batch's own output, in order.  These
//     copies are 45-63% of a step's cycles.  4 consecutive bytes a
//     lane, with a word read and a word store where they lie in one
//     element, measured 32-34% slower on mixed (scripts/
//     torch_decode_ab.py): elements of 1-3 bytes, common on mixed, made
//     most rounds take a byte-by-byte pass as well.
//   - Out: the output row, and a ring of its last kRing bytes in shared
//     memory, from which recent match sources are read.
//   - copy_match: a match out[o + k] = out[o - off + k mod off] from its
//     period, with one remainder per lane per match, not per byte; a
//     period of up to 32 bytes is held in registers.
//   - zero_fill (lz4_common.cuh): the bytes past a row's output, 16 bytes a lane.
//
// Positions are 32-bit: the wrappers take rows below 2**30 bytes and
// outputs below 2**31.
#pragma once

#include "lz4_common.cuh"

namespace tpucomp_lzd {

using tpucomp_lz4::kFull;  // the launch shape of lz4_common.cuh: 4 warps a CTA, a chunk a warp
using tpucomp_lz4::kMinMatch;
using tpucomp_lz4::kThreads;
using tpucomp_lz4::kWarpsPerBlock;
using tpucomp_lz4::zero_fill;

constexpr int kWin = 2048;    // stream bytes staged per warp
constexpr int kWinPad = 16;   // slack for the unaligned 4-byte reads at the window's end
constexpr int kGroup = 2;     // bytes a lane reads before it writes them, in write_batch
constexpr int kRing = 4096;   // output bytes kept per warp (a power of 2); with the window,
                              // 6 KB a warp, so 8 CTAs (32 warps) stay resident on an SM

__device__ __forceinline__ int clamp_row(long long i, int c) {
  return i < 0 ? 0 : (i >= c ? c - 1 : (int)i);
}

// The compressed row of c >= 1 bytes, and the part of it staged in s.
struct Window {
  const uint8_t* row;
  uint8_t* s;    // kWin + kWinPad bytes of shared memory, 16-byte aligned
  int c;
  int base;      // row index of s[0]; may be below 0 (s[0] is then before the row)
  int lo, hi;    // s holds the row's bytes [lo, hi)

  // Stage the row from index `start` (in [0, c), rounded down to a
  // 16-byte address) on.  Warp-collective; reads only bytes of the row.
  __device__ void fill(int start, int lane) {
    __syncwarp();  // every lane is done reading the old window
    base = start - (int)((reinterpret_cast<uintptr_t>(row) + start) & 15);
    lo = base < 0 ? 0 : base;
    hi = c - base < kWin ? c : base + kWin;
    const int blocks = (hi - base + 15) >> 4;
    for (int j = lane; j < blocks; j += 32) {
      const int i = base + 16 * j;
      if (i >= 0 && i + 16 <= c) {
        *reinterpret_cast<uint4*>(s + 16 * j) = __ldg(reinterpret_cast<const uint4*>(row + i));
      } else {
        for (int k = 0; k < 16; ++k)
          if (i + k >= 0 && i + k < c) s[16 * j + k] = row[i + k];
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ bool holds(int i, int n) const { return i >= lo && i + n <= hi; }

  // row[clamp(i)]
  __device__ __forceinline__ int at(long long i) const {
    return (i >= lo && i < hi) ? s[(int)i - base] : row[clamp_row(i, c)];
  }

  // The 4 bytes at row index i, little-endian; holds(i, 4) must be true.
  __device__ __forceinline__ unsigned u32_in(int i) const {
    const int k = i - base;
    const unsigned* w = reinterpret_cast<const unsigned*>(s + (k & ~3));
    return __funnelshift_r(w[0], w[1], (k & 3) * 8);
  }
};

// The output row, and its last kRing bytes written in shared memory: a
// match whose source is recent reads it there instead of from device
// memory, where it was just written.
struct Out {
  uint8_t* g;  // the output row in device memory
  uint8_t* r;  // kRing bytes of shared memory: byte t of the output at r[t % kRing]

  // Writes output byte t; into the ring too when t >= fresh_from, the
  // start of the last kRing bytes of the writes in progress: the ring's
  // slots then never go back to an older byte.
  __device__ __forceinline__ void put(int t, int v, int fresh_from) {
    g[t] = (uint8_t)v;
    if (t >= fresh_from) r[t & (kRing - 1)] = (uint8_t)v;
  }
  // Output byte s (final); the ring holds it when s >= fresh_from.
  __device__ __forceinline__ int get(int s, int fresh_from) const {
    return s >= fresh_from ? r[s & (kRing - 1)] : g[s];
  }
};

// out[o + k] = out[o - off + k mod off] for k < len (1 <= off <= o), the
// source final; fresh_from is the end of the writes in progress less
// kRing, and the ring holds the source's bytes from there on.  Every byte
// it reads lies before o, so the lanes need no order among themselves.  A
// period of at most 32 bytes is read once and handed round the lanes by
// shuffles; a longer one steps its source index with a compare and
// subtract, no remainder per byte.
__device__ __forceinline__ void copy_match(Out& out, int o, int off, int len, int fresh_from, int lane) {
  const int from = o - off;
  if (off <= 32) {
    const int pat = out.get(from + (lane < off ? lane : 0), fresh_from);
    // lane % off and 32 % off by a reciprocal: (n + 1/2) / off is at least
    // 1 / 64 from an integer for n, off <= 32, far beyond float's error
    const float inv = __frcp_rn((float)off);
    unsigned r = lane - off * (int)((lane + 0.5f) * inv);
    const unsigned step = 32 - off * (int)(32.5f * inv);
    for (int base = 0; base < len; base += 32) {
      const int v = __shfl_sync(kFull, pat, r);
      if (base + lane < len) out.put(o + base + lane, v, fresh_from);
      r += step;
      if (r >= (unsigned)off) r -= off;
    }
    return;
  }
  unsigned r = (unsigned)lane;  // off > 32 > lane
  for (int k = lane; k < len; k += 32) {
    out.put(o + k, out.get(from + (int)r, fresh_from), fresh_from);
    r += 32;
    if (r >= (unsigned)off) r -= off;
  }
}

// Writes one batch of parsed elements, element k in lane k when `mine`:
// output start d_o, length d_len > 0, and a literal's source row index
// or a match's offset, d_src.  The batch's output is [o_first, o_end),
// contiguous; earlier output is final.  Literals, and matches whose
// source ends before o_first, go in one pass over the batch's bytes,
// kGroup a lane per round, all read before any is written (so the reads
// of far sources, from device memory, overlap); then each match that
// reads the batch's own output, in order.  Warp-collective.
__device__ inline void write_batch(Out& out, const Window& w, int lane, bool mine, int d_o, int d_len, int d_src,
                            bool d_lit, int o_first, int o_end) {
  const int fresh = o_end - kRing;  // sources from here on are in the ring, and stay there
  const bool indep = mine && (d_lit || d_o - o_first + d_len <= d_src);
  const int len = indep ? d_len : 0;
  int end = len;  // inclusive prefix sum over the lanes
  for (int s = 1; s < 32; s <<= 1) {
    const int v = __shfl_up_sync(kFull, end, s);
    if (lane >= s) end += v;
  }
  const int total = __shfl_sync(kFull, end, 31);
  const int start = end - len;
  for (int base = 0; base < total; base += 32 * kGroup) {
    int dst[kGroup], val[kGroup];
    for (int h = 0; h < kGroup; ++h) {  // every byte of the group read before any is written
      const int q = base + 32 * h + lane;
      int e = 0;  // the element holding flattened byte q: the first whose end passes q
      for (int s = 16; s; s >>= 1)
        if (__shfl_sync(kFull, end, e + s - 1) <= q) e += s;
      const int eo = __shfl_sync(kFull, d_o, e), es = __shfl_sync(kFull, start, e);
      const int esrc = __shfl_sync(kFull, d_src, e);
      const bool elit = __shfl_sync(kFull, d_lit, e);
      const int k = q - es;
      dst[h] = q < total ? eo + k : -1;
      val[h] = q >= total ? 0 : elit ? w.at((long long)esrc + k) : out.get(eo + k - esrc, fresh);
    }
    for (int h = 0; h < kGroup; ++h)
      if (dst[h] >= 0) out.put(dst[h], val[h], fresh);
  }
  __syncwarp();
  for (unsigned dep = __ballot_sync(kFull, mine && !indep); dep; dep &= dep - 1) {
    const int e = __ffs(dep) - 1;
    copy_match(out, __shfl_sync(kFull, d_o, e), __shfl_sync(kFull, d_src, e), __shfl_sync(kFull, d_len, e),
               fresh, lane);
    __syncwarp();
  }
}

}  // namespace tpucomp_lzd
