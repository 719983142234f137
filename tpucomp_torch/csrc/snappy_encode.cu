// Snappy encode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel
// tpucomp/kernels/snappy_pallas.py::_snappy_encode_kernel.  Its plain
// PyTorch version is tpucomp_torch/codecs/snappy.py::_compress_plain; the
// streams are equal byte for byte, and equal to the JAX package's Pallas
// kernel and to the sequential oracle (tests/oracles/snappy_oracle.py).
//
// Input: the chunk bytes and the candidate tables of the torch pre-pass
// (tpucomp_torch/codecs/lz77.py::candidate_tables with the Snappy limits):
// nmp[i], the first match candidate at or after i (1 << 30 if none), and
// dist[i], the distance to the exact nearest previous occurrence of the
// 4-byte window at i.  A candidate starts at most at n - 4, at most 32768
// back.
//
// Design: one warp per chunk, as the LZ4 encoder (lz4_encode.cu).  The
// warp writes the varint of n, then from anchor a reads q = nmp[a];
// q > n - 4 ends the parse.  It extends the match at q exactly and
// without bound, comparing the input with itself 128 bytes a step (4 per
// lane; a ballot and __ffs find the first difference), up to the chunk's
// end n - q (Snappy has no end rules).  It then emits the literal header
// (1 byte for runs of at most 60 bytes, else the tag 60 + k - 1 and k LE
// bytes of the length - 1, k = 1..3), the literals [a, q), and the copy
// elements: k64 copy2(64), a copy2(60) when the remainder is 65-67, and a
// final copy1 (length <= 11, offset < 2048) or copy2.  The next anchor is
// q + m; the literals [a, n) close the stream.  Byte runs are written one
// byte per lane; the output row is zero past the stream (the wrapper
// allocates it with torch.zeros).
//
// What bounds it on the H100: the latency of the parse's dependent loads
// (nmp, then dist, then the compared bytes) per element, with one warp
// per chunk; device-memory bytes (the chunk, two int32 tables, the
// stream) are far from the limit.  The design hides latency only by the
// number of chunks in flight (one warp each); staging the tables in
// shared memory is later work.
//
// Covers chunks up to 16 MB (a literal header holds at most 2**24 bytes;
// positions fit int32).

#include "lz4_common.cuh"

namespace tpucomp_snappy {
namespace {

using tpucomp_lz4::kFull;
using tpucomp_lz4::kMinMatch;
using tpucomp_lz4::kThreads;
using tpucomp_lz4::kWarpsPerBlock;
using tpucomp_lz4::warp_chunk;

struct EncodeParams {
  const uint8_t* data;
  const int32_t* lengths;
  const int32_t* nmp;
  const int32_t* dist;
  uint8_t* out;
  int32_t* sizes;
  long long batch, row_bytes, out_row;
};

// One chunk's output stream, written by the whole warp.
struct Writer {
  uint8_t* out;
  long long o;
  int lane;

  __device__ void byte(int v) {
    if (lane == 0) out[o] = (uint8_t)v;
    ++o;
  }

  __device__ void varint(unsigned v) {
    for (; v >= 128; v >>= 7) byte((int)(v & 0x7f) | 0x80);
    byte((int)v);
  }

  // a literal element of the len >= 1 bytes at src
  __device__ void literal(const uint8_t* src, long long len) {
    const long long v = len - 1;
    if (len <= 60) {
      byte((int)(v << 2));
    } else {
      const int extra = len <= 256 ? 1 : (len <= 65536 ? 2 : 3);
      byte((59 + extra) << 2);
      for (int k = 0; k < extra; ++k) byte((int)((v >> (8 * k)) & 0xff));
    }
    for (long long k = lane; k < len; k += 32) out[o + k] = src[k];
    o += len;
  }

  // the copy elements of a match of ml >= 4 bytes at offset off in [1, 32768]
  __device__ void match(int off, long long ml) {
    const long long k64 = ml >= 68 ? (ml - 4) / 64 : 0;
    const int lo = off & 0xff, hi = off >> 8;
    for (long long k = lane; k < 3 * k64; k += 32) {
      const int r = (int)(k % 3);
      out[o + k] = (uint8_t)(r == 0 ? (63 << 2) | 2 : (r == 1 ? lo : hi));
    }
    o += 3 * k64;
    long long fin = ml - 64 * k64;
    if (fin > 64) {
      byte((59 << 2) | 2);
      byte(lo);
      byte(hi);
      fin -= 60;
    }
    if (fin <= 11 && off < 2048) {
      byte(1 | (int)((fin - 4) << 2) | (hi << 5));
      byte(lo);
    } else {
      byte((int)((fin - 1) << 2) | 2);
      byte(lo);
      byte(hi);
    }
  }
};

// Length of the match at q, offset off: the first k >= 4 with
// d[q + k] != d[q - off + k] or k == limit.  The first 4 bytes are equal
// by construction of the tables.
__device__ int extend(const uint8_t* d, int q, int off, int limit, int lane) {
  for (int m = kMinMatch;; m += 128) {
    int first = -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = m + 4 * lane + j;
      const bool stop = k >= limit || d[q + k] != d[q - off + k];
      if (stop && first < 0) first = 4 * lane + j;
    }
    const unsigned hit = __ballot_sync(kFull, first >= 0);
    if (hit) return m + __shfl_sync(kFull, first, __ffs(hit) - 1);
  }
}

__global__ void __launch_bounds__(kThreads) snappy_encode_kernel(EncodeParams p) {
  const long long b = warp_chunk(p.batch);
  if (b < 0) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* d = p.data + b * p.row_bytes;
  const int32_t* nmp = p.nmp + b * p.row_bytes;
  const int32_t* dist = p.dist + b * p.row_bytes;
  // the codec clamps lengths to the row; so does the kernel, which then
  // never reads past a row whoever calls it
  const int n = (int)min((long long)max(p.lengths[b], 0), p.row_bytes);
  Writer w{p.out + b * p.out_row, 0, lane};
  w.varint((unsigned)n);
  int a = 0;  // anchor: the first byte not yet emitted
  while (a <= n - kMinMatch) {
    const int q = nmp[a];
    if (q > n - kMinMatch) break;
    const int off = dist[q];
    const int m = extend(d, q, off, n - q, lane);
    if (q > a) w.literal(d + a, q - a);
    w.match(off, m);
    a = q + m;
  }
  if (n > a) w.literal(d + a, n - a);
  if (lane == 0) p.sizes[b] = (int32_t)w.o;
}

}  // namespace
}  // namespace tpucomp_snappy

// Launches the encode kernel on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int tc_snappy_encode(const void* data, const void* lengths, const void* nmp,
                                const void* dist, void* out, void* sizes, long long batch,
                                long long row_bytes, long long out_row, void* stream) {
  using namespace tpucomp_snappy;
  EncodeParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                 static_cast<const int32_t*>(nmp),   static_cast<const int32_t*>(dist),
                 static_cast<uint8_t*>(out),         static_cast<int32_t*>(sizes),
                 batch, row_bytes, out_row};
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  snappy_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
