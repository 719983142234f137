// Shared device helpers of the Cascaded encode and decode kernels.
//
// Both kernels give each scheme chunk to a team of one warp.  A CTA holds
// up to kMaxTeams teams; the host sizes the teams' shared-memory
// workspaces and picks how many teams share one partition (`slots`) and
// how many partitions share one CTA (`parts`), so that a batch of many
// one-chunk partitions (CascadedManager's default) fills the card as well
// as a batch of 16-chunk partitions (the 64 KB main path).  Inside a team,
// most passes take rounds of 32 consecutive elements, one a lane; a pass
// that scans (decode's Delta and RLE expansion) splits the array into one
// contiguous segment per lane whose length is odd, so the lanes' i-th
// elements fall into 32 different shared-memory banks, and joins the
// segments with one warp scan.  Either replaces the block scans and
// barriers of a CTA-wide design.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace tpucomp {

constexpr int kMaxTeams = 8;
constexpr int kPartitionHeader = 8;
constexpr unsigned kFull = 0xffffffffu;
// Shared memory a CTA may use for its teams' workspaces: two CTAs fit on
// one SM's 227 KB (with the 1 KB each that the card reserves), so eight
// teams of the default options' 14,384-byte encode workspace (12,288 for
// decode) share one CTA.  Compiled in, so a variant can be timed against it.
#ifndef TC_CASCADED_SMEM_BUDGET
#define TC_CASCADED_SMEM_BUDGET 115072
#endif
constexpr int kSmemBudget = TC_CASCADED_SMEM_BUDGET;
// The most a CTA may have (the H100's 227 KB); an encode team whose
// workspace passes it writes its chunks in place (cascaded_encode.cu).
#ifndef TC_CASCADED_SMEM_MAX
#define TC_CASCADED_SMEM_MAX (227 * 1024)
#endif
constexpr int kSmemMax = TC_CASCADED_SMEM_MAX;

__host__ __device__ __forceinline__ long long round_up(long long x, long long y) {
  return (x + y - 1) / y * y;
}

// floor division, as Python's // (the JAX reference uses it on signed ints)
__host__ __device__ __forceinline__ long long floor_div(long long x, long long y) {
  long long q = x / y;
  return (q * y != x && ((x < 0) != (y < 0))) ? q - 1 : q;
}

// An element is held in a unit U: uint32_t for widths 1, 2 and 4,
// unsigned long long for 8 (LONGLONG / ULONGLONG).  S is its signed reading.
template <class U>
using SignedOf = typename std::conditional<sizeof(U) == 8, long long, int>::type;

// the low 8 * width bits of a unit
template <class U = uint32_t>
__device__ __forceinline__ U unit_mask(int width) {
  return width >= (int)sizeof(U) ? ~U(0) : ((U(1) << (8 * width)) - U(1));
}

// signed reading of a unit of `width` bytes
__device__ __forceinline__ int32_t sext(uint32_t v, int width) {
  if (width >= 4) return (int32_t)v;
  int sh = 32 - 8 * width;
  return ((int32_t)(v << sh)) >> sh;
}
__device__ __forceinline__ long long sext(unsigned long long v, int) { return (long long)v; }

__device__ __forceinline__ int bit_width(uint32_t r) { return r ? 32 - __clz(r) : 0; }
__device__ __forceinline__ int bit_width(unsigned long long r) { return r ? 64 - __clzll((long long)r) : 0; }

// Warp-wide minimum and maximum: the card's reductions for 32 bits, a
// butterfly of shuffles for 64 (__reduce_*_sync has no 64-bit form).
__device__ __forceinline__ int warp_min(int v) { return __reduce_min_sync(kFull, v); }
__device__ __forceinline__ int warp_max(int v) { return __reduce_max_sync(kFull, v); }
__device__ __forceinline__ long long warp_min(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, (long long)__shfl_xor_sync(kFull, v, o));
  return v;
}
__device__ __forceinline__ long long warp_max(long long v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, (long long)__shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// Ask for the 128-byte line at p in L2 (a no-op where not compiled for the card).
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// This lane's segment [lo, hi) of an n-element array: contiguous, of odd
// length, so that lane l's i-th element sits in bank (l * per + i) % 32.
struct Seg {
  int lo, hi;
};
__device__ __forceinline__ Seg lane_segment(int n) {
  const int per = ((n + 31) >> 5) | 1;
  const int lo = min(n, lane_id() * per);
  return {lo, min(n, lo + per)};
}

// Warp-wide exclusive scan (wrapping for unsigned T); `total` gets the sum.
template <typename T>
__device__ __forceinline__ T warp_exclusive_scan(T v, T& total) {
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, x, o);
    if (lane_id() >= o) x += y;
  }
  total = __shfl_sync(kFull, x, 31);
  return x - v;
}

// Warp-wide exclusive max-scan of unsigned values (0 for lane 0).
__device__ __forceinline__ uint32_t warp_exclusive_max(uint32_t v) {
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane_id() >= o) x = max(x, y);
  }
  const uint32_t e = __shfl_up_sync(kFull, x, 1);
  return lane_id() ? e : 0u;
}

// Loads per thread kept in flight by the copies and the element loads:
// a loop that waits for each load before the next one pays the memory's
// latency every iteration.
constexpr int kBatch = 8;
// Rounds of 32 elements whose shared-memory loads a warp issues before any
// of their stores: the compiler cannot tell that a team's arrays do not
// alias, so a loop that loads and stores would wait on each load in turn.
constexpr int kRounds = 4;

template <typename V>
__device__ __forceinline__ void copy_vec(uint8_t* dst, const uint8_t* src, long long n, int tid, int nth) {
  const long long nv = n / (long long)sizeof(V);
  const V* s = reinterpret_cast<const V*>(src);
  V* d = reinterpret_cast<V*>(dst);
  long long i = tid;
  for (; i + (kBatch - 1) * (long long)nth < nv; i += kBatch * (long long)nth) {
    V r[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) r[u] = s[i + u * (long long)nth];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) d[i + u * (long long)nth] = r[u];
  }
  for (; i < nv; i += nth) d[i] = s[i];
  for (long long j = nv * (long long)sizeof(V) + tid; j < n; j += nth) dst[j] = src[j];
}

// dst[0, n) = src[0, n) by `nth` threads, with the widest vector both
// pointers allow.
__device__ inline void copy_bytes(uint8_t* dst, const uint8_t* src, long long n, int tid, int nth) {
  if (n <= 0) return;
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src;
  if (a % 16 == 0) copy_vec<uint4>(dst, src, n, tid, nth);
  else if (a % 8 == 0) copy_vec<uint2>(dst, src, n, tid, nth);
  else if (a % 4 == 0) copy_vec<uint32_t>(dst, src, n, tid, nth);
  else copy_vec<uint8_t>(dst, src, n, tid, nth);
}

// dst[0, n) = 0 by `nth` threads: bytes up to a 16-byte boundary, then
// 16-byte stores, then the tail.
__device__ inline void zero_bytes(uint8_t* dst, long long n, int tid, int nth) {
  if (n <= 0) return;
  const long long head = min(n, (long long)((16 - ((uintptr_t)dst & 15)) & 15));
  for (long long i = tid; i < head; i += nth) dst[i] = 0;
  const long long nv = (n - head) / 16;
  uint4* v = reinterpret_cast<uint4*>(dst + head);
  for (long long i = tid; i < nv; i += nth) v[i] = make_uint4(0, 0, 0, 0);
  for (long long i = head + 16 * nv + tid; i < n; i += nth) dst[i] = 0;
}

// How a launch spreads over the card: `teams` warps per CTA, `slots` of
// them on the chunks of one partition, `parts` partitions per CTA, each
// team's shared workspace of `ws_bytes`.
struct TeamPlan {
  int teams, slots, parts;
  long long ws_bytes;
};

// The largest power-of-two team count (at most kMaxTeams) whose workspaces
// fit the budget, at least one; the chunks of a partition take up to that
// many teams, and the rest of the CTA takes further partitions.
inline TeamPlan plan_teams(long long ws_bytes, int k) {
  int t = kMaxTeams;
  while (t > 1 && t * ws_bytes > kSmemBudget) t >>= 1;
  const int slots = k < t ? k : t;
  return {t, slots, t / slots, ws_bytes};
}

}  // namespace tpucomp
