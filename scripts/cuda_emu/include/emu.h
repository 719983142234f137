// Host emulation of the CUDA subset that the port's kernels use, so they
// can be built with g++ and checked on a machine without a card
// (scripts/cuda_emu/check_lz_decode.py, check_lz_encode.py,
// check_cascaded.py).  A launch runs its blocks one
// after another; a block's threads run as ucontext coroutines on one OS
// thread; every warp intrinsic is an exchange at which all 32 lanes of the
// warp meet (a warp whose lanes diverge there aborts), __syncthreads one at
// which the block's threads meet.  Shared memory is a function's static
// storage, which is right because blocks never overlap; dynamic shared memory
// (`extern __shared__`, which the check scripts rewrite to
// emu_dynamic_smem()) one static buffer, filled with 0xA5 before each block.  Nothing here
// models timing, the memory model or the compiler: it checks logic only.
#pragma once
#include <climits>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <functional>
#include <type_traits>
#include <tuple>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 { unsigned x, y, z; dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {} };
struct uint3e { unsigned x, y, z; };
extern uint3e threadIdx, blockIdx, blockDim, gridDim;

struct __attribute__((aligned(8))) uint2 { unsigned x, y; };
struct __attribute__((aligned(16))) uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return uint2{a, b}; }
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) { return uint4{a, b, c, d}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaFuncAttributePreferredSharedMemoryCarveout = 1, cudaSharedmemCarveoutMaxShared = 100,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 2, cudaDevAttrMultiProcessorCount = 3 };
inline cudaError_t cudaGetLastError() { return 0; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }  // two "SMs"
template <class F> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) { *n = 1; return 0; }
inline uint8_t* emu_dynamic_smem() { alignas(16) static uint8_t buf[256 << 10]; return buf; }
template <class F, class A, class V> cudaError_t cudaFuncSetAttribute(F, A, V) { return 0; }

template <class A, class B> inline auto min(A a, B b) -> typename std::common_type<A, B>::type { return a < b ? a : b; }
template <class A, class B> inline auto max(A a, B b) -> typename std::common_type<A, B>::type { return a < b ? b : a; }

template <class T> inline T __ldg(const T* p) { return *p; }
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned sh) {
  return (unsigned)((((unsigned long long)hi << 32) | lo) >> (sh & 31));
}
inline int __ffs(unsigned x) { return x ? __builtin_ctz(x) + 1 : 0; }
inline int __ffsll(unsigned long long x) { return x ? __builtin_ctzll(x) + 1 : 0; }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
inline int __clzll(long long x) { return x ? __builtin_clzll((unsigned long long)x) : 64; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline float __frcp_rn(float x) { return 1.0f / x; }

// the exchange: deposit v, wait for every lane of the warp (warp != 0) or
// every thread of the block; returns the deposits, by thread
const unsigned long long* emu_exchange(unsigned long long v, bool block);

template <class T> inline unsigned long long emu_bits(T v) { unsigned long long x = 0; memcpy(&x, &v, sizeof(T)); return x; }
template <class T> inline T emu_from(unsigned long long x) { T v; memcpy(&v, &x, sizeof(T)); return v; }

template <class T> inline T __shfl_sync(unsigned, T v, int src) {
  const unsigned long long* s = emu_exchange(emu_bits(v), false);
  return emu_from<T>(s[(threadIdx.x & ~31u) + (src & 31)]);
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const unsigned long long* s = emu_exchange(emu_bits(v), false);
  const int lane = threadIdx.x & 31;
  return lane >= (int)d ? emu_from<T>(s[threadIdx.x - d]) : v;
}
template <class T> inline T __shfl_down_sync(unsigned, T v, unsigned d) {
  const unsigned long long* s = emu_exchange(emu_bits(v), false);
  const int lane = threadIdx.x & 31;
  return lane + (int)d < 32 ? emu_from<T>(s[threadIdx.x + d]) : v;
}
template <class T> inline T __shfl_xor_sync(unsigned, T v, int m) {
  const unsigned long long* s = emu_exchange(emu_bits(v), false);
  return emu_from<T>(s[(threadIdx.x & ~31u) + ((threadIdx.x & 31) ^ m)]);
}
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned long long* s = emu_exchange(pred ? 1 : 0, false);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)(s[(threadIdx.x & ~31u) + i] & 1) << i;
  return m;
}
inline unsigned __match_any_sync(unsigned, unsigned v) {
  const unsigned long long* s = emu_exchange(v, false);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)(s[(threadIdx.x & ~31u) + i] == v) << i;
  return m;
}
inline int __any_sync(unsigned mk, int p) { return __ballot_sync(mk, p) != 0; }
inline int __all_sync(unsigned mk, int p) { return __ballot_sync(mk, p) == ~0u; }
inline void __syncwarp(unsigned = ~0u) { emu_exchange(0, false); }
inline void __syncthreads() { emu_exchange(0, true); }

void emu_run(unsigned grid, unsigned block, std::function<void()> body);

struct emu_cfg { unsigned g, b; emu_cfg(unsigned g_, unsigned b_, size_t = 0, void* = nullptr) : g(g_), b(b_) {} };
template <class K> struct emu_launcher {
  K k; emu_cfg c;
  template <class... A> void operator()(A... a) { emu_run(c.g, c.b, [=]() { k(a...); }); }
};
template <class K> emu_launcher<K> emu_launch(K k, emu_cfg c) { return {k, c}; }
inline long long clock64() { static long long c = 0; return c += 3; }  // counts calls, not time
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) { auto o = *p; *p += v; return o; }
inline unsigned atomicAdd(unsigned* p, unsigned v) { auto o = *p; *p += v; return o; }
template <class T> inline int cudaMemcpyToSymbol(T& sym, const void* src, size_t n) { memcpy(&sym, src, n); return 0; }
template <class T> inline int cudaMemcpyFromSymbol(void* dst, const T& sym, size_t n) { memcpy(dst, &sym, n); return 0; }
template <class T> inline T emu_reduce(T v, bool take_max) {
  const unsigned long long* s = emu_exchange(emu_bits(v), false);
  T m = v;
  for (int i = 0; i < 32; ++i) {
    const T x = emu_from<T>(s[(threadIdx.x & ~31u) + i]);
    m = take_max ? (x > m ? x : m) : (x < m ? x : m);
  }
  return m;
}
inline int __reduce_min_sync(unsigned, int v) { return emu_reduce(v, false); }
inline int __reduce_max_sync(unsigned, int v) { return emu_reduce(v, true); }
inline unsigned __reduce_min_sync(unsigned, unsigned v) { return emu_reduce(v, false); }
inline unsigned __reduce_max_sync(unsigned, unsigned v) { return emu_reduce(v, true); }
// a block barrier whose result is whether any thread's predicate holds
inline int __syncthreads_or(int pred) {
  const unsigned long long* s = emu_exchange(pred ? 1 : 0, true);
  int any = 0;
  for (unsigned i = 0; i < blockDim.x; ++i) any |= (int)s[i];
  return any;
}
inline unsigned atomicOr(unsigned* p, unsigned v) { auto o = *p; *p |= v; return o; }
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  const unsigned long long* s = emu_exchange(v, false);
  unsigned m = 0;
  for (int i = 0; i < 32; ++i) m |= (unsigned)s[(threadIdx.x & ~31u) + i];
  return m;
}
