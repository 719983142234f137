// Match-table kernel of the LZ4 and Snappy encoders, for NVIDIA Hopper.
//
// Replaces the XLA pre-pass of the JAX package's Pallas encoders,
// tpucomp/codecs/lz77.py::nearest_prev_occurrence (a device-wide sort,
// outside any pallas_call).  Its plain PyTorch version is
// tpucomp_torch/codecs/lz77.py::match_table; the tables are equal.
//
// Output: out[b, i], uint16, the distance i - j to the exact nearest
// previous occurrence j of the 4-byte window at i (the largest j < i with
// data[j:j+4] == data[i:i+4], both valid: <= n - 4 and, with a stride,
// stride-aligned), kept where i - j <= max_offset and i <= n - end_margin;
// 0 everywhere else ("no candidate": a distance is never 0).  Every entry
// of the [B, C] table is written.
//
// Two paths, chosen by row_bytes, a shape: rows of up to 64 KB take the
// grouping kernel below, one row a job; longer rows need the 64K
// positions before each segment as well, which do not fit its layout,
// and take the radix kernel of lz_match_table_radix.cuh (a stable LSD
// sort through a global scratch).  The two share no code.
//
// The grouping kernel replaces, for rows of up to 64 KB, that full sort of
// a job's windows: four stable 8-bit passes, each ranking 4,096-position
// tiles by __match_any_sync behind five barriers and ping-ponging the
// positions through 66 MiB of global scratch (more than the L2).  A
// position only needs the nearest earlier position of its own window, so
// the job's positions need only be grouped by window, in position order
// within a group; no order among groups.  One CTA of 1,024 threads holds a
// job wholly in shared memory (225 KB of the SM's 227: the row's bytes, a
// uint16 index a position, 8,192 bucket counters, a list of the buckets)
// and does, with no global scratch:
//   1. stage the row's bytes;
//   2. bucket each valid position by a multiplicative hash of its whole
//      4-byte window (13 bits): a histogram by shared-memory atomics (one
//      a warp when its 32 buckets agree, as on runs), a scan that also
//      lists the buckets of 2 or more positions by size class, and a
//      scatter of the positions into their buckets by the same atomics.
//      No ranks and no stability: a bucket's positions come in any order;
//   3. order every bucket so that equal windows are adjacent, in position
//      order: each position's predecessor in the bucket is then its
//      nearest previous occurrence when their windows are equal.  A sort
//      compares one 32-bit value: the position alone where the bucket
//      holds one window (runs, zero pages), else bits 3 .. 18 of the
//      window's hash above the position; two windows of one bucket that
//      share those bits (they differ in the hash's lowest 3) are found
//      next to each other after the sort, and that bucket is sorted again
//      by (window, position).  The warps take tasks from a counter in
//      shared memory, largest first:
//        - a bucket of 33 to 1,024 positions: one warp, a bitonic network
//          in registers (up to 8 entries a lane, shuffles between lanes)
//          over chunks of up to 256, merged by steps in shared memory;
//        - buckets of 2 to 32: rounds of groups of 2 to 32 lanes, two
//          buckets a group, the same network within the group;
//      then a bucket above 1,024 positions, by the whole CTA: its main
//      window's positions through a bitmap over the row (set, counted and
//      read back in order, linear in its size), the others (at most
//      4,096) set aside and sorted after them, or else the whole bucket
//      by a bitonic network in shared memory, a barrier a step;
//   4. flag each position whose predecessor in the order holds the same
//      window, then write the table in two halves of 32K entries through
//      the staged bytes' room, which the keys no longer need; the halves
//      leave in coalesced stores.
//
// What bounds it on the H100: one CTA an SM (the shared memory), so 32
// warps hide the latency of shared-memory reads and shuffles; issue slots
// of the bucketing (two passes of a key, a hash and an atomic a position)
// and of the networks (a shuffle and a min or max an entry a step).  DRAM
// sees the row once and the table once (2 bytes a position).  For 256 MB
// of 64 KB rows on an H100 at 700 W (scripts/torch_table_ab.py, PERF.md):
// mixed 10.8 ms with the radix sort, 4.1 ms here; run-heavy 7.1 and 4.7.
//
// Worst case: no step walks a chain.  Every loop is bounded by the size of
// the bucket it works on: log^2 m steps of a network for m positions, once
// more where its windows clash; a row whose windows all fall in one bucket
// (the hash is public) is one sort of all of them by the CTA: 9.1 ms for
// 256 MB of such rows, against 4.8 ms for the radix sort.  The tracer's
// counters (utils/profiling.py): counters[0] adds the valid positions
// grouped, counters[1] those in buckets of more than 32 (the networks over
// chunks and the CTA's path); null: count nothing.  The radix path counts
// nothing.
//
// Covers rows up to 16 MB, strides 1, 2 and 4, max_offset <= 65535.

#include "lz4_common.cuh"
#include "lz_match_table_radix.cuh"

namespace tpucomp_lzg {
namespace {

using tpucomp_lz4::kFull;

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRow = 1 << 16;       // rows of up to this many bytes take this kernel
constexpr int kHalf = kMaxRow / 2;     // table entries a half of the write-out
constexpr int kBucketBits = 13;
constexpr int kBuckets = 1 << kBucketBits;
constexpr unsigned kHashMul = 2654435761u;
constexpr int kSmall = 32;         // buckets of at most this many positions: a part of a warp each
constexpr int kWarpMax = 1024;     // a warp sorts a bucket of up to this many; the CTA larger ones
constexpr int kFirst = 128;        // buckets above this many are the warps' first tasks
constexpr int kClasses = 7;        // kFirst + 1..kWarpMax, 33..kFirst (a warp each), then 17..32, 9..16, 5..8, 3..4, 2
constexpr int kBig = 2;            // (a group of 32 >> (c - kBig) lanes each)
constexpr int kHugeCap = kMaxRow / (kWarpMax + 1) + 1;  // buckets the CTA sorts, at most
constexpr int kSpill = 4096;       // positions outside a CTA bucket's main window that its bitmap sort sets aside
constexpr unsigned kNone = 0xFFFFFFFFu;  // past every (window, index): the sorts' padding
constexpr int kUnroll = 4;               // positions a thread takes at a time in the histogram and the scatter
constexpr int kStack = 2;                // small buckets a group of lanes sorts at once

// Shared memory, in bytes from the start of the dynamic buffer.
constexpr int kStage = kMaxRow + 16;             // the row's bytes (+ a word read past its end)
constexpr int kSlotAt = kStage;                  // uint16 slot[kMaxRow]: positions grouped by bucket
constexpr int kCountAt = kSlotAt + 2 * kMaxRow;  // unsigned, two uint16 bucket counters a word
constexpr int kListAt = kCountAt + 2 * kBuckets; // uint16 list[kBuckets]: the buckets of 2+ positions by class;
                                                 // then a CTA bucket's bitmap and spill; then a flag a slot
constexpr int kHugeAt = kListAt + 2 * kBuckets;  // uint16 huge[kHugeCap]
constexpr int kCtlAt = kHugeAt + 2 * kHugeCap;   // unsigned ctl[kCtl]
enum { kNext, kNHuge, kNSpill, kClassAt, kCtl = kClassAt + kClasses + kWarps };  // + the scans' warp sums
constexpr int kSmem = kCtlAt + 4 * kCtl;
static_assert(kCountAt % 16 == 0 && 2 * kBuckets >= kMaxRow / 8 + 2 * kSpill, "the list's room");

struct GroupParams {
  const uint8_t* data;
  const int32_t* lengths;
  uint16_t* out;
  unsigned long long* counters;  // positions, large-bucket positions; null: count nothing
  long long batch, row_bytes;
  int stride, max_offset, end_margin;
};

// The 4-byte window at staged byte i (bytes i .. i + 3; the word after
// them is inside the staged room).
__device__ __forceinline__ unsigned key_at(const unsigned* sw, int i) {
  return __funnelshift_r(sw[i >> 2], sw[(i >> 2) + 1], (i & 3) << 3);
}

__device__ __forceinline__ unsigned bucket_of(unsigned key) { return (key * kHashMul) >> (32 - kBucketBits); }

// Bucket b's counter: two to a word.  After the scatter it holds the
// bucket's end, which is also the next bucket's start.
__device__ __forceinline__ int end_of(const unsigned* cnt, int b) {
  return (int)(cnt[b >> 1] >> ((b & 1) << 4)) & 0xFFFF;
}
__device__ __forceinline__ int start_of(const unsigned* cnt, int b) { return b ? end_of(cnt, b - 1) : 0; }

// The order the sorts give a bucket: by (window, index) (kExact); or by
// (bits 3 .. 18 of the window's hash, index) (kHash), one 32-bit compare,
// which groups a bucket's windows unless two of them share those bits (and
// then differ in the hash's lowest 3 only; checked after the sort, and the
// bucket sorted again by kExact); or by index alone (kIndex), where the
// bucket holds one window.
enum Order { kIndex, kHash, kExact };

__device__ __forceinline__ unsigned hash_mid(unsigned key) { return (key * kHashMul) << kBucketBits & 0xFFFF0000u; }

// The 32-bit sort value of entry (index e) under kIndex or kHash.
__device__ __forceinline__ unsigned value_of(const unsigned* sw, int e, int stride, Order order) {
  return order == kIndex ? (unsigned)e : hash_mid(key_at(sw, e * stride)) | (unsigned)e;
}

// Whether the ordered slot[j - 1] and slot[j] hold two windows that kHash
// cannot tell apart.
__device__ __forceinline__ bool clash(const uint16_t* slot, int j, const unsigned* sw, int stride) {
  const unsigned a = key_at(sw, slot[j - 1] * stride), b = key_at(sw, slot[j] * stride);
  return a != b && hash_mid(a) == hash_mid(b);
}

// The sorts below are one bitonic network: for size = 2, 4, .., p, steps
// j = size / 2, .., 1; at the first step of a size ("flip") entry i meets
// i ^ (size - 1), at the others i + j; the smaller always goes to the
// lower index.  So padding entries (kNone, past every real one) never
// move: a network over p = 2^k entries sorts m <= p of them in place,
// skipping any comparison with an entry at or past m.

// The network over the W * R values that a group of W lanes holds in
// registers, R a lane (entry lane * R + r), unrolled: all of it, or
// (kMerge) only its steps below W * R of a larger size, which end a merge.
// Steps between entries of one lane are register moves; the others one
// shuffle an entry.
template <int R, int W, bool kMerge>
__device__ __forceinline__ void reg_network(unsigned (&v)[R]) {
  const int lane = threadIdx.x & (W - 1);
#pragma unroll
  for (int size = kMerge ? 2 * W * R : 2; size <= (kMerge ? 2 * W * R : W * R); size <<= 1) {
#pragma unroll
    for (int j = (kMerge ? W * R : size) >> 1; j > 0; j >>= 1) {
      const bool flip = !kMerge && j == size >> 1;
      if (j < R) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int q = flip ? r ^ (2 * j - 1) : r + j;
          if (r & j) continue;
          const unsigned a = v[r], b = v[q];
          v[r] = min(a, b);
          v[q] = max(a, b);
        }
      } else {
        const int mask = flip ? size / R - 1 : j / R;
        const bool lower = !(lane & (flip ? size / R / 2 : j / R));
#pragma unroll
        for (int r = 0; r < (flip ? (R + 1) / 2 : R); ++r) {
          const int q = flip ? R - 1 - r : r;  // entry r meets the partner's q, and entry q the partner's r
          const unsigned a = __shfl_xor_sync(kFull, v[q], mask);
          if (q != r) {
            const unsigned b = __shfl_xor_sync(kFull, v[r], mask);
            v[q] = lower ? min(v[q], b) : max(v[q], b);
          }
          v[r] = lower ? min(v[r], a) : max(v[r], a);
        }
      }
    }
  }
}

// Entries [c0, c0 + 32R) of v[0, m) through one warp's registers, by the
// 32-bit values of `order`: the whole network over them, or (merge) its
// last steps.
template <int R>
__device__ __noinline__ void warp_chunk(uint16_t* v, int c0, int m, Order order, bool merge, const unsigned* sw,
                                        int stride, int lane) {
  unsigned x[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = c0 + lane * R + r;
    x[r] = i < m ? value_of(sw, v[i], stride, order) : kNone;
  }
  if (merge) reg_network<R, 32, true>(x); else reg_network<R, 32, false>(x);
  __syncwarp();  // every lane has read its entries
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (c0 + lane * R + r < m) v[c0 + lane * R + r] = (uint16_t)x[r];
  __syncwarp();
}

// One step of the network over v[0, m) (p = 2^k >= m entries) in shared
// memory, by `team` threads from r0: a compare-exchange each a turn.
__device__ __forceinline__ void smem_step(uint16_t* v, int m, int p, int size, int j, Order order,
                                          const unsigned* sw, int stride, int r0, int team) {
  for (int q = r0; q < p >> 1; q += team) {
    const int lo = ((q & ~(j - 1)) << 1) | (q & (j - 1));
    const int hi = j == size >> 1 ? lo ^ (size - 1) : lo + j;
    if (hi >= m) continue;
    const int a = v[lo], c = v[hi];
    bool swap;
    if (order == kExact) {
      const unsigned ka = key_at(sw, a * stride), kc = key_at(sw, c * stride);
      swap = ka > kc || (ka == kc && a > c);
    } else {
      swap = value_of(sw, a, stride, order) > value_of(sw, c, stride, order);
    }
    if (swap) {
      v[lo] = (uint16_t)c;
      v[hi] = (uint16_t)a;
    }
  }
}

// Orders slot[s, s + m) (m <= kWarpMax) by (window, index) with one warp;
// a range of one window by index alone.  Up to 256 entries in registers
// (R = 1, 2, 4 or 8 a lane); more in chunks of 256 so sorted, then merged
// by steps in shared memory down to 256 apart and by chunks in registers
// below; where two of its windows clash under kHash, again by kExact with
// steps in shared memory alone.
__device__ __noinline__ void warp_sort(uint16_t* slot, int s, int m, const unsigned* sw, int stride, int lane) {
  const unsigned k0 = key_at(sw, slot[s] * stride);
  bool eq = true;
  for (int j = s + lane; j < s + m; j += 32) eq &= key_at(sw, slot[j] * stride) == k0;
  const Order order = __all_sync(kFull, eq) ? kIndex : kHash;
  uint16_t* v = slot + s;
  const int p = m <= 32 ? 32 : 1 << (32 - __clz(m - 1));
  if (p == 32) {
    warp_chunk<1>(v, 0, m, order, false, sw, stride, lane);
  } else if (p == 64) {
    warp_chunk<2>(v, 0, m, order, false, sw, stride, lane);
  } else if (p == 128) {
    warp_chunk<4>(v, 0, m, order, false, sw, stride, lane);
  } else {
    for (int c0 = 0; c0 < m; c0 += 256) warp_chunk<8>(v, c0, m, order, false, sw, stride, lane);
    for (int size = 512; size <= p; size <<= 1) {
      for (int j = size >> 1; j >= 256; j >>= 1) {
        smem_step(v, m, p, size, j, order, sw, stride, lane, 32);
        __syncwarp();
      }
      for (int c0 = 0; c0 < m; c0 += 256) warp_chunk<8>(v, c0, m, order, true, sw, stride, lane);
    }
  }
  if (order == kIndex) return;
  bool bad = false;
  for (int j = s + 1 + lane; j < s + m; j += 32) bad |= clash(slot, j, sw, stride);
  if (!__any_sync(kFull, bad)) return;
  for (int size = 2; size <= p; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      smem_step(v, m, p, size, j, kExact, sw, stride, lane, 32);
      __syncwarp();
    }
  }
}

// The network over a group of W lanes for kStack independent sets of W
// entries, one a lane in each (x[r]), by 32-bit value, their shuffles
// interleaved.
template <int W>
__device__ __forceinline__ void stacked_network(unsigned (&x)[kStack]) {
  const int lane = threadIdx.x & (W - 1);
#pragma unroll
  for (int size = 2; size <= W; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const int mask = j == size >> 1 ? size - 1 : j;
      const bool lower = !(lane & j);
#pragma unroll
      for (int r = 0; r < kStack; ++r) {
        const unsigned o = __shfl_xor_sync(kFull, x[r], mask);
        x[r] = lower ? min(x[r], o) : max(x[r], o);
      }
    }
  }
}

// A round of small buckets: groups of W lanes, kStack buckets each, the
// buckets list[first ..] of the n of their class.  By kHash, or where
// any of the round's buckets clash under it, all of them by kExact.
template <int W>
__device__ void small_round(uint16_t* slot, const uint16_t* list, const unsigned* cnt, int n, int first,
                            const unsigned* sw, int stride, int lane) {
  const int li = lane & (W - 1);
  int s[kStack], m[kStack];
  unsigned x[kStack];
#pragma unroll
  for (int r = 0; r < kStack; ++r) {
    const int idx = first + r * (32 / W) + lane / W;
    s[r] = m[r] = 0;
    if (idx < n) {
      const int bkt = list[idx];
      s[r] = start_of(cnt, bkt);
      m[r] = end_of(cnt, bkt) - s[r];
    }
  }
#pragma unroll
  for (int r = 0; r < kStack; ++r) {
    const unsigned e = li < m[r] ? slot[s[r] + li] : 0u;
    x[r] = li < m[r] ? hash_mid(key_at(sw, e * stride)) | e : kNone;
  }
  stacked_network<W>(x);
  const int from = li ? lane - 1 : lane;
  bool bad = false;
#pragma unroll
  for (int r = 0; r < kStack; ++r) {
    const unsigned ke = li < m[r] ? key_at(sw, (x[r] & 0xFFFF) * stride) : 0u;
    const unsigned xp = __shfl_sync(kFull, x[r], from), kp = __shfl_sync(kFull, ke, from);
    bad |= li && li < m[r] && ke != kp && (xp >> 16) == (x[r] >> 16);
  }
  if (__any_sync(kFull, bad)) {  // the buckets as they lie, by kExact, in shared memory
#pragma unroll
    for (int r = 0; r < kStack; ++r) {
      for (int size = 2; size <= W; size <<= 1) {
        for (int j = size >> 1; j > 0; j >>= 1) {
          smem_step(slot + s[r], m[r], W, size, j, kExact, sw, stride, li, W);
          __syncwarp();
        }
      }
    }
    return;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kStack; ++r)
    if (li < m[r]) slot[s[r] + li] = (uint16_t)x[r];
  __syncwarp();
}

// Orders v[0, m) by (window, index), in place in shared memory with the
// whole CTA, a barrier a step.
__device__ void cta_sort(uint16_t* v, int m, const unsigned* sw, int stride, int tid) {
  const int p = 1 << (32 - __clz(m - 1));
  for (int size = 2; size <= p; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      smem_step(v, m, p, size, j, kExact, sw, stride, tid, kThreads);
      __syncthreads();
    }
  }
}

// Orders the bucket slot[s, s + m) with the whole CTA.  The positions of
// its main window w (the window at its middle slot) go through a bitmap
// over the row's positions (set, counted, read back in order: linear in
// m); the others (at most kSpill) are set aside and sorted after them.
// More others than that: cta_sort of the whole bucket.
__device__ void cta_bucket(uint16_t* slot, int s, int m, unsigned* room, unsigned* ctl, const unsigned* sw,
                           int stride, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  unsigned* bits = room;                                              // kMaxRow bits
  uint16_t* spill = reinterpret_cast<uint16_t*>(room + kMaxRow / 32);  // kSpill entries
  const unsigned w = key_at(sw, slot[s + m / 2] * stride);
  for (int k = tid; k < kMaxRow / 32; k += kThreads) bits[k] = 0;
  if (tid == 0) ctl[kNSpill] = 0;
  __syncthreads();
  for (int j0 = s; j0 < s + m; j0 += kThreads) {
    const int j = j0 + tid;
    const int e = j < s + m ? slot[j] : 0;
    const bool main = j < s + m && key_at(sw, e * stride) == w;
    if (j < s + m && !main) {
      const unsigned at = atomicAdd(&ctl[kNSpill], 1u);
      if (at < kSpill) spill[at] = (uint16_t)e;
    }
    // one atomic a word where the warp's main positions fall in two words (runs scattered together)
    const int word = e >> 5, w0 = __shfl_sync(kFull, word, 0);
    const unsigned bit = main ? 1u << (e & 31) : 0u;
    const unsigned lo = __reduce_or_sync(kFull, word == w0 ? bit : 0u);
    const unsigned hi = __reduce_or_sync(kFull, word == w0 + 1 ? bit : 0u);
    if (__all_sync(kFull, !main || word == w0 || word == w0 + 1)) {
      if (lane == 0 && lo) atomicOr(&bits[w0], lo);
      if (lane == 0 && hi) atomicOr(&bits[w0 + 1], hi);
    } else if (main) {
      atomicOr(&bits[word], bit);
    }
  }
  __syncthreads();
  const int others = (int)ctl[kNSpill];
  if (others > kSpill) {
    cta_sort(slot + s, m, sw, stride, tid);
    return;
  }
  // the main window's positions in order: each thread reads kMaxRow / 32 / kThreads words
  constexpr int kWords = kMaxRow / 32 / kThreads;
  unsigned mine[kWords], own = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) own += __popc(mine[i] = bits[tid * kWords + i]);
  unsigned inc = own;
  for (int sh = 1; sh < 32; sh <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, inc, sh);
    if (lane >= sh) inc += u;
  }
  unsigned* sums = ctl + kClassAt + kClasses;
  if (lane == 31) sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const unsigned x = sums[lane];
    unsigned y = x;
    for (int sh = 1; sh < 32; sh <<= 1) {
      const unsigned u = __shfl_up_sync(kFull, y, sh);
      if (lane >= sh) y += u;
    }
    sums[lane] = y - x;
  }
  __syncthreads();
  int at = s + (int)(sums[warp] + inc - own);
#pragma unroll
  for (int i = 0; i < kWords; ++i)
    for (unsigned b = mine[i]; b; b &= b - 1) slot[at++] = (uint16_t)((tid * kWords + i) * 32 + __ffs(b) - 1);
  const int main_count = m - others;
  for (int k = tid; k < others; k += kThreads) slot[s + main_count + k] = spill[k];
  __syncthreads();
  if (others > 1) {
    if (warp == 0 && others <= kWarpMax) warp_sort(slot, s + main_count, others, sw, stride, lane);
    __syncthreads();
    if (others > kWarpMax) cta_sort(slot + s + main_count, others, sw, stride, tid);
  }
}

__global__ void __launch_bounds__(kThreads, 1) lz_match_group_kernel(GroupParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  const unsigned* sw = reinterpret_cast<const unsigned*>(smem);
  uint16_t* slot = reinterpret_cast<uint16_t*>(smem + kSlotAt);
  unsigned* cnt = reinterpret_cast<unsigned*>(smem + kCountAt);
  uint16_t* list = reinterpret_cast<uint16_t*>(smem + kListAt);
  uint16_t* buf = reinterpret_cast<uint16_t*>(smem);  // the write-out's half, once the keys are done
  unsigned* flag = reinterpret_cast<unsigned*>(smem + kListAt);  // once the lists are done
  uint16_t* huge = reinterpret_cast<uint16_t*>(smem + kHugeAt);
  unsigned* ctl = reinterpret_cast<unsigned*>(smem + kCtlAt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = (int)p.row_bytes, stride = p.stride;
  unsigned long long positions = 0, large = 0;  // this thread's share of the counters

  for (long long b = blockIdx.x; b < p.batch; b += gridDim.x) {
    const uint8_t* row = p.data + b * p.row_bytes;
    uint16_t* out = p.out + b * p.row_bytes;
    const int n = (int)min((long long)max(p.lengths[b], 0), p.row_bytes);
    const int pend = min(c, n - 3);  // valid positions are < n - 3
    const int count = pend > 0 ? (pend + stride - 1) / stride : 0;  // and stride-aligned
    if (count == 0) {
      for (int i = tid; i < c; i += kThreads) out[i] = 0;
      continue;
    }
    if (tid == 0) positions += count;

    // 1. the row's bytes, and the counters zeroed
    __syncthreads();  // the previous job is done with the shared memory
    const int span = pend + 3;
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
      const int vecs = span >> 4;
      for (int k = tid; k < vecs; k += kThreads)
        reinterpret_cast<uint4*>(smem)[k] = reinterpret_cast<const uint4*>(row)[k];
      for (int k = (vecs << 4) + tid; k < span; k += kThreads) smem[k] = row[k];
    } else {
      for (int k = tid; k < span; k += kThreads) smem[k] = row[k];
    }
    for (int k = tid; k < kBuckets / 2; k += kThreads) cnt[k] = 0;
    if (tid < kCtl) ctl[tid] = 0;
    __syncthreads();

    // 2. the histogram of the buckets: an atomic a position, or one a warp
    // when its 32 positions share a bucket; kUnroll positions a thread at a
    // time, their windows read first
    for (int k0 = 0; k0 < count; k0 += kUnroll * kThreads) {
      unsigned h[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads + tid;
        h[u] = k < count ? bucket_of(key_at(sw, k * stride)) : kBuckets;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned h0 = __shfl_sync(kFull, h[u], 0);
        if (__all_sync(kFull, h[u] == h0)) {
          if (lane == 0 && h0 < kBuckets) atomicAdd(&cnt[h0 >> 1], 32u << ((h0 & 1) << 4));
        } else if (h[u] < kBuckets) {
          atomicAdd(&cnt[h[u] >> 1], 1u << ((h[u] & 1) << 4));
        }
      }
    }
    __syncthreads();
    {  // the scan: thread t has buckets 8t .. 8t + 7; their starts, and the lists by class
      const uint4 wv = reinterpret_cast<const uint4*>(cnt)[tid];
      const unsigned words[4] = {wv.x, wv.y, wv.z, wv.w};
      unsigned own = 0;
      int cls[8], per[kClasses];
#pragma unroll
      for (int c2 = 0; c2 < kClasses; ++c2) per[c2] = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned m = (words[i >> 1] >> ((i & 1) << 4)) & 0xFFFF;
        own += m;
        if (m > kSmall) large += m;
        cls[i] = m > kWarpMax ? kClasses : m > kFirst ? 0 : m > kSmall ? 1 : m > 16 ? 2 : m > 8 ? 3 : m > 4 ? 4
               : m > 2 ? 5 : m == 2 ? 6 : -1;
#pragma unroll
        for (int c2 = 0; c2 < kClasses; ++c2) per[c2] += cls[i] == c2;
      }
      unsigned inc = own;
      for (int sh = 1; sh < 32; sh <<= 1) {
        const unsigned u = __shfl_up_sync(kFull, inc, sh);
        if (lane >= sh) inc += u;
      }
      unsigned* sums = ctl + kClassAt + kClasses;
      if (lane == 31) sums[warp] = inc;
      int before_me[kClasses];  // this thread's place in each class: the warp's share, then the lanes' before it
#pragma unroll
      for (int c2 = 0; c2 < kClasses; ++c2) {
        int x = per[c2];
        for (int sh = 1; sh < 32; sh <<= 1) {
          const int u = __shfl_up_sync(kFull, x, sh);
          if (lane >= sh) x += u;
        }
        int base = 0;
        if (lane == 31) base = (int)atomicAdd(&ctl[kClassAt + c2], (unsigned)x);
        before_me[c2] = __shfl_sync(kFull, base, 31) + x - per[c2];
      }
      __syncthreads();
      if (warp == 0) {
        const unsigned x = sums[lane];
        unsigned y = x;
        for (int sh = 1; sh < 32; sh <<= 1) {
          const unsigned u = __shfl_up_sync(kFull, y, sh);
          if (lane >= sh) y += u;
        }
        sums[lane] = y - x;
      }
      __syncthreads();
      unsigned run = sums[warp] + inc - own;
      int at[kClasses];
      {
        int base = 0;
#pragma unroll
        for (int c2 = 0; c2 < kClasses; ++c2) {
          at[c2] = base + before_me[c2];
          base += (int)ctl[kClassAt + c2];
        }
      }
      unsigned starts[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int bkt = 8 * tid + i;
        const unsigned m = (words[i >> 1] >> ((i & 1) << 4)) & 0xFFFF;
        if (i & 1) starts[i >> 1] |= run << 16; else starts[i >> 1] = run;
        run += m;
#pragma unroll
        for (int c2 = 0; c2 < kClasses; ++c2)
          if (cls[i] == c2) list[at[c2]++] = (uint16_t)bkt;
        if (cls[i] == kClasses) huge[atomicAdd(&ctl[kNHuge], 1u)] = (uint16_t)bkt;
      }
      reinterpret_cast<uint4*>(cnt)[tid] = make_uint4(starts[0], starts[1], starts[2], starts[3]);
    }
    __syncthreads();

    // 2. the scatter: a bucket's counter runs from its start to its end
    for (int k0 = 0; k0 < count; k0 += kUnroll * kThreads) {
      unsigned h[kUnroll], at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads + tid;
        h[u] = k < count ? bucket_of(key_at(sw, k * stride)) : kBuckets;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // every atomic first, then the stores
        const unsigned h0 = __shfl_sync(kFull, h[u], 0);
        const bool one = __all_sync(kFull, h[u] == h0);
        at[u] = kNone;
        if (one ? lane == 0 && h0 < kBuckets : h[u] < kBuckets)
          at[u] = atomicAdd(&cnt[h[u] >> 1], (one ? 32u : 1u) << ((h[u] & 1) << 4)) >> ((h[u] & 1) << 4) & 0xFFFF;
        if (one) at[u] = h0 < kBuckets ? (__shfl_sync(kFull, at[u], 0) + lane) : kNone;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (at[u] != kNone) slot[at[u]] = (uint16_t)(k0 + u * kThreads + tid);
    }
    __syncthreads();

    // 3. the warps' tasks, from a counter: the large buckets one a warp,
    // the largest first, then the small ones in rounds of 32 >> (c - kBig) lanes a bucket
    int n_class[kClasses], first[kClasses], rounds = 0;
#pragma unroll
    for (int c2 = 0, base = 0; c2 < kClasses; ++c2) {
      n_class[c2] = (int)ctl[kClassAt + c2];
      first[c2] = base;
      base += n_class[c2];
      rounds += c2 < kBig ? n_class[c2] : (n_class[c2] + (kStack << (c2 - kBig)) - 1) / (kStack << (c2 - kBig));
    }
    while (true) {
      int t = 0;
      if (lane == 0) t = (int)atomicAdd(&ctl[kNext], 1u);
      t = __shfl_sync(kFull, t, 0);
      if (t >= rounds) break;
      if (t < first[kBig]) {  // a bucket of kSmall + 1 .. kWarpMax positions (the lists of classes 0, 1 are adjacent)
        const int bkt = list[t];
        const int s = start_of(cnt, bkt), m = end_of(cnt, bkt) - s;
        warp_sort(slot, s, m, sw, stride, lane);
        continue;
      }
      t -= first[kBig];
#pragma unroll
      for (int c2 = kBig; c2 < kClasses; ++c2) {
        const int per = kStack << (c2 - kBig), r = (n_class[c2] + per - 1) / per;
        if (t >= 0 && t < r) {
          const uint16_t* l = list + first[c2];
          switch (c2 - kBig) {
            case 0: small_round<32>(slot, l, cnt, n_class[c2], t * per, sw, stride, lane); break;
            case 1: small_round<16>(slot, l, cnt, n_class[c2], t * per, sw, stride, lane); break;
            case 2: small_round<8>(slot, l, cnt, n_class[c2], t * per, sw, stride, lane); break;
            case 3: small_round<4>(slot, l, cnt, n_class[c2], t * per, sw, stride, lane); break;
            default: small_round<2>(slot, l, cnt, n_class[c2], t * per, sw, stride, lane); break;
          }
        }
        t -= r;
      }
    }
    __syncthreads();

    // 3. the buckets of more than kWarpMax positions, by the whole CTA
    const int n_huge = (int)ctl[kNHuge];
    for (int i = 0; i < n_huge; ++i) {
      const int bkt = huge[i];
      const int s = start_of(cnt, bkt);
      cta_bucket(slot, s, end_of(cnt, bkt) - s, reinterpret_cast<unsigned*>(smem + kListAt), ctl, sw, stride, tid);
      __syncthreads();
    }

    // 4. a flag a slot: its predecessor holds the same window (and so lies
    // in its bucket); then the table in halves staged where the bytes were
    for (int w0 = warp << 7; w0 < count; w0 += kThreads << 2) {  // four slots a lane, eight lanes a word
      const int k0 = w0 + (lane << 2);
      const uint2 four = k0 < count ? *reinterpret_cast<const uint2*>(slot + k0) : make_uint2(0, 0);
      const int e[5] = {k0 && k0 < count ? slot[k0 - 1] : 0, (int)(four.x & 0xFFFF), (int)(four.x >> 16),
                        (int)(four.y & 0xFFFF), (int)(four.y >> 16)};
      unsigned w[5], bits = 0;
#pragma unroll
      for (int q = 0; q < 5; ++q) w[q] = key_at(sw, (k0 + q - 1 < count ? e[q] : 0) * stride);
#pragma unroll
      for (int q = 0; q < 4; ++q) bits |= (unsigned)(k0 + q > 0 && k0 + q < count && w[q + 1] == w[q]) << q;
      bits <<= (lane & 7) << 2;
      bits |= __shfl_xor_sync(kFull, bits, 1);
      bits |= __shfl_xor_sync(kFull, bits, 2);
      bits |= __shfl_xor_sync(kFull, bits, 4);
      if (!(lane & 7)) flag[k0 >> 5] = bits;
    }
    for (int lo = 0; lo < c; lo += kHalf) {
      const int hi = min(c, lo + kHalf);
      __syncthreads();  // the keys and flags, or the last half's stores, are done with the room
      for (int k = tid; k < (hi - lo + 7) >> 3; k += kThreads)
        reinterpret_cast<uint4*>(smem)[k] = make_uint4(0, 0, 0, 0);
      __syncthreads();
      for (int k0 = tid << 2; k0 < count; k0 += kThreads << 2) {  // four slots a thread at a time
        const unsigned bits = flag[k0 >> 5] >> (k0 & 31) & 15;
        if (!bits) continue;
        const uint2 four = *reinterpret_cast<const uint2*>(slot + k0);
        const int e[5] = {k0 ? slot[k0 - 1] : 0, (int)(four.x & 0xFFFF), (int)(four.x >> 16), (int)(four.y & 0xFFFF),
                          (int)(four.y >> 16)};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = e[q + 1] * stride, dist = (e[q + 1] - e[q]) * stride;
          if ((bits >> q & 1) && k0 + q < count && i >= lo && i < hi && dist <= p.max_offset &&
              i <= n - p.end_margin)
            buf[i - lo] = (uint16_t)dist;
        }
      }
      __syncthreads();
      for (int i = lo + tid; i < hi; i += kThreads) out[i] = buf[i - lo];
    }
  }

  if (p.counters) {
    for (int sh = 16; sh > 0; sh >>= 1) large += __shfl_down_sync(kFull, large, sh);
    if (lane == 0 && large) atomicAdd(p.counters + 1, large);
    if (tid == 0 && positions) atomicAdd(p.counters, positions);
  }
}

// Per call, as the attributes are per device (and cheap to set): the
// dynamic shared memory, and all of the SM's unified memory as shared
// memory.
cudaError_t prepare() {
  const cudaError_t err =
      cudaFuncSetAttribute(lz_match_group_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(lz_match_group_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace
}  // namespace tpucomp_lzg

// The grid of the table kernel for `batch` rows of `row_bytes` on the
// current device: the CTAs it holds at once, at most one a job; or minus
// a CUDA error.  Sets *scratch_bytes to the global scratch that grid
// needs, for the caller to allocate (none for rows of up to 64 KB).
extern "C" int tc_lz_match_table_grid(long long batch, long long row_bytes, long long* scratch_bytes) {
  using namespace tpucomp_lzg;
  if (row_bytes > kMaxRow) return tpucomp_lzt::radix_grid(batch, row_bytes, scratch_bytes);
  int dev, sms, per_sm;
  cudaError_t err = prepare();
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, lz_match_group_kernel, kThreads, kSmem);
  if (err != cudaSuccess) return -(int)err;
  *scratch_bytes = 0;
  return (int)min((long long)sms * max(per_sm, 1), batch);
}

// Launches the table kernel on `stream` with `grid` CTAs, each taking
// jobs in turn, with the grid and the scratch of the bytes that
// tc_lz_match_table_grid gave for these rows.  `counters`: the tracer's
// two counters (lz.table.positions, then lz.table.large_bucket_positions),
// or null.  Returns the launch's CUDA error (0 on success).
extern "C" int tc_lz_match_table(const void* data, const void* lengths, void* out, void* scratch,
                                 long long batch, long long row_bytes, int stride, int max_offset,
                                 int end_margin, int grid, void* counters, void* stream) {
  using namespace tpucomp_lzg;
  if (row_bytes > kMaxRow)
    return tpucomp_lzt::radix_launch(data, lengths, out, scratch, batch, row_bytes, stride, max_offset, end_margin,
                                     grid, stream);
  const cudaError_t err = prepare();
  if (err != cudaSuccess) return (int)err;
  GroupParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                static_cast<uint16_t*>(out), static_cast<unsigned long long*>(counters), batch, row_bytes,
                stride, max_offset, end_margin};
  lz_match_group_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
