// Shared device helpers of the Cascaded encode and decode kernels.
//
// Both kernels run one CTA (thread block) per partition and walk the
// partition's scheme chunks in order.  A chunk's working arrays live in
// dynamic shared memory, one 32-bit slot per element; block-wide scans and
// reductions split an array into one contiguous segment per thread
// (sequential inside the segment, a warp-shuffle scan across segments).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpucomp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPartitionHeader = 8;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ long long round_up(long long x, long long y) {
  return (x + y - 1) / y * y;
}

// floor division, as Python's // (the JAX reference uses it on signed ints)
__host__ __device__ __forceinline__ long long floor_div(long long x, long long y) {
  long long q = x / y;
  return (q * y != x && ((x < 0) != (y < 0))) ? q - 1 : q;
}

__device__ __forceinline__ uint32_t unit_mask(int width) {
  return width >= 4 ? 0xffffffffu : ((1u << (8 * width)) - 1u);
}

// signed reading of a unit of `width` bytes
__device__ __forceinline__ int32_t sext(uint32_t v, int width) {
  if (width >= 4) return (int32_t)v;
  int sh = 32 - 8 * width;
  return ((int32_t)(v << sh)) >> sh;
}

__device__ __forceinline__ int bit_width32(uint32_t r) { return r ? 32 - __clz(r) : 0; }

// Contiguous per-thread segment [lo, hi) of an n-element array.
__device__ __forceinline__ void segment(int n, int& lo, int& hi) {
  int per = (n + kThreads - 1) / kThreads;
  lo = min(n, (int)threadIdx.x * per);
  hi = min(n, lo + per);
}

// Block-wide exclusive scan of one value per thread (wrapping for unsigned
// T).  Every thread gets its exclusive prefix and the block total.  Ends
// with a barrier, so `scratch` can be reused at once.
template <typename T>
__device__ T block_exclusive_scan(T v, T* scratch, T& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    T y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T s = lane < kWarps ? scratch[lane] : T(0);
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      T y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) scratch[lane] = s;
  }
  __syncthreads();
  T base = warp ? scratch[warp - 1] : T(0);
  total = scratch[kWarps - 1];
  __syncthreads();
  return base + x - v;
}

// Block-wide min and max of one value per thread; every thread gets both.
__device__ inline void block_min_max(int32_t& mn, int32_t& mx, int32_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    mn = min(mn, __shfl_xor_sync(kFull, mn, o));
    mx = max(mx, __shfl_xor_sync(kFull, mx, o));
  }
  if (lane == 0) {
    scratch[warp] = mn;
    scratch[kWarps + warp] = mx;
  }
  __syncthreads();
  mn = scratch[0];
  mx = scratch[kWarps];
  for (int i = 1; i < kWarps; ++i) {
    mn = min(mn, scratch[i]);
    mx = max(mx, scratch[kWarps + i]);
  }
  __syncthreads();
}

template <typename V>
__device__ inline void copy_vec(uint8_t* dst, const uint8_t* src, long long n) {
  const long long nv = n / (long long)sizeof(V);
  for (long long i = threadIdx.x; i < nv; i += kThreads)
    reinterpret_cast<V*>(dst)[i] = reinterpret_cast<const V*>(src)[i];
  for (long long i = nv * (long long)sizeof(V) + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// dst[0, n) = src[0, n) with the widest vector both pointers allow.
__device__ inline void copy_bytes(uint8_t* dst, const uint8_t* src, long long n) {
  const uintptr_t a = (uintptr_t)dst | (uintptr_t)src;
  if (a % 16 == 0) copy_vec<uint4>(dst, src, n);
  else if (a % 8 == 0) copy_vec<uint2>(dst, src, n);
  else if (a % 4 == 0) copy_vec<uint32_t>(dst, src, n);
  else copy_vec<uint8_t>(dst, src, n);
}

}  // namespace tpucomp
