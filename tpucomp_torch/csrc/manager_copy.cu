// The managers' batched stream copy, for NVIDIA Hopper: pack (a manager's
// artifact assembly) and unpack (its stream slicing).
//
// Replaces no TPU kernel.  It replaces the plain versions' per-byte int64
// index in tpucomp_torch/highlevel/manager.py, which the CPU route keeps:
// `_assemble_plain`'s `permute.place` (an int64 target for every byte of
// the padded rows, a `where`, one `index_put_`) and `_slice_plain`'s
// gather (`artifact[src]` over the same index, a `where`).  At a
// manager's 256 MB those build 2.2 GB index tensors and take some 30-50x
// the time a copy needs.  The outputs are equal to the plain versions' on
// every input, damaged tables included.
//
// pack: artifact[out_max] from comp[k, row] (the codec's rows), sizes[k]
// and inc[k], their inclusive cumsum (int64 each): the static head and
// comp_data_size (u64 LE at 8), the u64 LE offset and size tables at
// sections_off, the reserved-zero checksum tables (8 bytes a chunk), each
// comp[i, :sizes[i]] at data_off + inc[i] - sizes[i], and zeros to
// out_max.  Every artifact byte is written, by exactly one thread.
//
// unpack: rows[k, max_chunk] and sizes[k] (int32) from an artifact of
// numel bytes, by its own tables: row i holds
// artifact[clamp(data_off + off_i + t, 0, numel - 1)] for t < size_i
// (offsets and sizes as int64, the sum wrapping as torch's does) and
// zeros past it; sizes[i] is size_i's low 32 bits.
//
// What bounds it on the H100: device memory.  Each stream byte is read
// once and written once, each zero once: for 256 MB at 64 KB chunks some
// 2 x 270 MB, 0.16 ms at 3.35 TB/s.  The design: one CTA a chunk (a
// stream in pack, a row in unpack), so a CTA finds its stream with no
// search; pack's CTA i also zeroes its share (1/k) of the artifact past
// the streams and writes its chunk's three table entries, CTA 0 the head.
// A CTA writes its destination span [a, b) in aligned 16-byte words, one
// store a thread an iteration, neighbouring threads on neighbouring
// words; the words it shares with the spans beside it (a stream's first
// and last, packed gaplessly at any byte offset) it writes byte by byte,
// so each byte has one writer.  Source and destination alignments differ
// (a 65,800-byte row is no multiple of 16), but by a constant r a span:
// a word reads the two aligned source words that hold its bytes and
// shifts them into place by funnel shifts (a body instantiated for each
// r / 4, the shift 8 (r % 4)).  Only aligned words that hold a byte of
// the source are read.  The same path serves 4,096 streams of 64 KB and
// 65,536 of 4 KB: it sees bytes and an offset table, never a codec.
//
// Counters (tpucomp_torch/utils/profiling.py): `bytes`, when not null,
// takes each CTA's stream bytes copied, one atomic a CTA
// (manager.pack.bytes / manager.unpack.bytes); on a sound artifact
// either sums to comp_data_size.  Null costs a branch a CTA.

#include <cstdint>

#include <cuda_runtime.h>

namespace tpucomp_mgr {
namespace {

constexpr int kThreads = 256;
constexpr int kHeadWords = 16;  // the static head and its padding to sections_off, in u64

struct PackParams {
  const uint8_t* comp;
  const long long* sizes;
  const long long* inc;
  uint8_t* artifact;
  long long k, row, sections_off, data_off, out_max;
  unsigned long long* bytes;
  unsigned long long head[kHeadWords];
};

struct UnpackParams {
  const uint8_t* artifact;
  uint8_t* rows;
  int32_t* sizes;
  long long numel, k, max_chunk, sections_off, data_off;
  unsigned long long* bytes;
};

// 16 bytes from offset r of the 32 in (lo, hi), r = 4 Q + s / 8
template <int Q>
__device__ __forceinline__ uint4 shift_words(uint4 lo, uint4 hi, unsigned s) {
  const unsigned x[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(x[Q], x[Q + 1], s), __funnelshift_r(x[Q + 1], x[Q + 2], s),
                    __funnelshift_r(x[Q + 2], x[Q + 3], s), __funnelshift_r(x[Q + 3], x[Q + 4], s));
}

__device__ __forceinline__ uint8_t span_byte(const uint8_t* src, long long j, long long n) {
  return j < n ? src[j] : 0;
}

// The aligned words [w0, w1) of a span that starts at a: word w's bytes
// are src[16 w - a + q] where that index is below n, else 0.  r is the
// source's misalignment, the same for every word.
template <int Q>
__device__ void copy_words(uint8_t* __restrict__ dst, long long a, long long w0, long long w1,
                           const uint8_t* __restrict__ src, long long n, unsigned r) {
  const unsigned s = 8u * (r & 3u);
  for (long long w = w0 + threadIdx.x; w < w1; w += kThreads) {
    const long long j = 16 * w - a;
    uint4 v;
    if (j + 16 <= n) {  // the word's bytes all come from the source
      const uint4* at = reinterpret_cast<const uint4*>(src + j - r);
      const uint4 lo = at[0];
      v = shift_words<Q>(lo, r ? at[1] : lo, s);  // at[1] holds src[j + 15] when r > 0
    } else if (j >= n) {
      v = make_uint4(0u, 0u, 0u, 0u);
    } else {  // the word where the source ends
      unsigned x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < 16; ++q) x[q >> 2] |= (unsigned)span_byte(src, j + q, n) << (8 * (q & 3));
      v = make_uint4(x[0], x[1], x[2], x[3]);
    }
    *reinterpret_cast<uint4*>(dst + 16 * w) = v;
  }
}

// The CTA writes dst[a, b) (dst 16-byte aligned): byte p takes src[p - a]
// where p - a < n, else 0.  src[0, n) must be readable; n <= b - a.
__device__ void copy_span(uint8_t* __restrict__ dst, long long a, long long b,
                          const uint8_t* __restrict__ src, long long n) {
  if (a >= b) return;
  const long long a16 = (a + 15) & ~15LL, b16 = b & ~15LL;
  const long long head_end = a16 < b ? a16 : b;
  for (long long p = a + threadIdx.x; p < head_end; p += kThreads) dst[p] = span_byte(src, p - a, n);
  if (a16 >= b) return;
  for (long long p = b16 + threadIdx.x; p < b; p += kThreads) dst[p] = span_byte(src, p - a, n);
  if (a16 >= b16) return;
  const long long w0 = a16 >> 4, w1 = b16 >> 4;
  const unsigned r = (unsigned)(((uintptr_t)src + (uintptr_t)(a16 - a)) & 15u);
  switch (r >> 2) {
    case 0: copy_words<0>(dst, a, w0, w1, src, n, r); break;
    case 1: copy_words<1>(dst, a, w0, w1, src, n, r); break;
    case 2: copy_words<2>(dst, a, w0, w1, src, n, r); break;
    default: copy_words<3>(dst, a, w0, w1, src, n, r); break;
  }
}

__global__ void __launch_bounds__(kThreads) manager_pack_kernel(PackParams p) {
  const long long i = blockIdx.x;
  const long long size = p.sizes[i], off = p.inc[i] - size, total = p.inc[p.k - 1];
  const int t = threadIdx.x;
  unsigned long long* table = reinterpret_cast<unsigned long long*>(p.artifact + p.sections_off);
  if (t == 0) table[i] = (unsigned long long)off;
  if (t == 1) table[p.k + i] = (unsigned long long)size;
  if (t == 2) table[2 * p.k + i] = 0ull;  // 8 bytes of the reserved-zero checksum tables
  if (i == 0 && t < p.sections_off / 8)
    reinterpret_cast<unsigned long long*>(p.artifact)[t] = t == 1 ? (unsigned long long)total : p.head[t];
  // the stream (sizes from a codec lie in [0, row]; the writes stay inside
  // [data_off, out_max) whatever they are)
  const long long a = p.data_off + off, len = size > 0 ? size : 0;
  const long long b = a + len < p.out_max ? a + len : p.out_max;
  const long long n = len < p.row ? len : p.row;
  long long copied = 0;
  if (a >= p.data_off && a < b) {
    copy_span(p.artifact, a, b, p.comp + i * p.row, n);
    copied = n < b - a ? n : b - a;
  }
  // this CTA's share of the zeros past the streams
  const long long z = p.data_off + (total > 0 ? total : 0), zeros = p.out_max - z;
  if (zeros > 0) {
    const long long q = zeros / p.k, rem = zeros % p.k;
    const long long z0 = z + i * q + (i < rem ? i : rem);
    copy_span(p.artifact, z0, z0 + q + (i < rem), nullptr, 0);
  }
  if (t == 0 && p.bytes && copied) atomicAdd(p.bytes, (unsigned long long)copied);
}

// a u64 LE at an address of any alignment
__device__ unsigned long long load_u64le(const uint8_t* at) {
  unsigned long long v = 0;
  for (int q = 7; q >= 0; --q) v = v << 8 | at[q];
  return v;
}

__global__ void __launch_bounds__(kThreads) manager_unpack_kernel(UnpackParams p) {
  __shared__ unsigned long long entry[2];  // this row's offset and size
  const long long i = blockIdx.x;
  const int t = threadIdx.x;
  if (t < 2) entry[t] = load_u64le(p.artifact + p.sections_off + 8 * (t * p.k + i));
  __syncthreads();
  const long long size = (long long)entry[1];
  if (t == 0) p.sizes[i] = (int32_t)(uint32_t)entry[1];
  const long long n = size < 0 ? 0 : (size < p.max_chunk ? size : p.max_chunk);
  const long long s = (long long)((unsigned long long)p.data_off + entry[0]);  // wraps as torch's int64 sum
  const long long a = i * p.max_chunk;
  if (s >= 0 && s <= p.numel - n) {  // no byte of the row is clamped
    copy_span(p.rows, a, a + p.max_chunk, p.artifact + s, n);
  } else {  // a table that points outside the artifact: each byte's index clamped
    for (long long j = t; j < p.max_chunk; j += kThreads) {
      long long at = (long long)((unsigned long long)s + (unsigned long long)j);
      at = at < 0 ? 0 : (at > p.numel - 1 ? p.numel - 1 : at);
      p.rows[a + j] = j < n ? p.artifact[at] : 0;
    }
  }
  if (t == 0 && p.bytes && n) atomicAdd(p.bytes, (unsigned long long)n);
}

}  // namespace
}  // namespace tpucomp_mgr

// Launches the pack kernel on `stream` (one CTA a chunk, k >= 1; the
// artifact 16-byte aligned; head_bytes <= sections_off <= 128, both
// multiples of 8 apart from head_bytes; data_off = sections_off + 24 k);
// returns cudaGetLastError() (0 on success).
extern "C" int tc_manager_pack(const void* comp, const void* sizes, const void* inc, void* artifact, long long k,
                               long long row, const void* head, int head_bytes, long long sections_off,
                               long long data_off, long long out_max, void* bytes, void* stream) {
  using namespace tpucomp_mgr;
  PackParams p{static_cast<const uint8_t*>(comp), static_cast<const long long*>(sizes),
               static_cast<const long long*>(inc), static_cast<uint8_t*>(artifact), k, row, sections_off,
               data_off, out_max, static_cast<unsigned long long*>(bytes), {}};
  const uint8_t* h = static_cast<const uint8_t*>(head);
  for (int q = 0; q < head_bytes && q < 8 * kHeadWords; ++q)
    p.head[q / 8] |= (unsigned long long)h[q] << (8 * (q % 8));
  manager_pack_kernel<<<(unsigned)k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Launches the unpack kernel on `stream` (one CTA a row, k >= 1; rows
// 16-byte aligned; the tables inside the artifact's numel bytes).
extern "C" int tc_manager_unpack(const void* artifact, void* rows, void* sizes, long long numel, long long k,
                                 long long max_chunk, long long sections_off, long long data_off, void* bytes,
                                 void* stream) {
  using namespace tpucomp_mgr;
  UnpackParams p{static_cast<const uint8_t*>(artifact), static_cast<uint8_t*>(rows), static_cast<int32_t*>(sizes),
                 numel, k, max_chunk, sections_off, data_off, static_cast<unsigned long long*>(bytes)};
  manager_unpack_kernel<<<(unsigned)k, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
