// LZ4 encode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/lz_pallas.py::_lz4_encode_kernel.
// Its plain PyTorch version is tpucomp_torch/codecs/lz4.py::_compress_plain;
// the streams are equal byte for byte, and equal to the JAX package's
// Pallas kernel and to the uncapped sequential oracle.
//
// Input: the chunk bytes and the candidate tables of the torch pre-pass
// (tpucomp_torch/codecs/lz77.py::candidate_tables): nmp[i], the first
// match candidate at or after i (1 << 30 if none), and dist[i], the
// distance to the exact nearest previous occurrence of the 4-byte window
// at i.  A candidate starts at most at n - 13, at most 65535 back.
//
// Design: one warp per chunk, after the reference's warp-cooperative
// compressStream.  From anchor a the warp reads q = nmp[a]; q >= n - 12
// ends the parse.  It extends the match at q exactly and without bound,
// comparing the input with itself 128 bytes a step (4 per lane; a ballot
// and __ffs find the first difference), up to the end rule n - 5 - q.
// Comparing the input with itself makes overlapping matches no special
// case.  The warp then emits the sequence: token, literal LSIC, the
// literals [a, q), the u16 LE offset and the match LSIC, the byte runs
// one byte per lane.  The next anchor is q + m; the last sequence takes
// the literals [a, n).  The output row is zero past the stream: the
// wrapper allocates it with torch.zeros.
//
// What bounds it on the H100: the latency of the parse's dependent loads
// (nmp, then dist, then the compared bytes) per sequence, with one warp
// per chunk; device-memory bytes (the chunk, two int32 tables of 4 bytes
// per input byte, the stream) are far from the limit.  The design hides
// latency only by the number of chunks in flight (one warp each, all
// resident at 4096 chunks); staging the tables in shared memory and a
// hash pre-pass fused into this kernel are later work.
//
// Covers chunks up to 16 MB (positions fit int32) with element strides
// 1, 2 and 4 (the stride lives in the tables).

#include "lz4_common.cuh"

namespace tpucomp_lz4 {
namespace {

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

  // the LSIC extension bytes of a length field value v >= 15
  __device__ void lsic(long long v) {
    const long long r = v - 15, nb = r / 255 + 1;
    const uint8_t last = (uint8_t)(r - 255 * (nb - 1));
    for (long long k = lane; k < nb; k += 32) out[o + k] = k < nb - 1 ? 255 : last;
    o += nb;
  }

  __device__ void copy(const uint8_t* src, long long len) {
    for (long long k = lane; k < len; k += 32) out[o + k] = src[k];
    o += len;
  }

  // literals [lit, lit + llen), then a match of mlen at offset off (mlen 0:
  // the last, literals-only sequence)
  __device__ void sequence(const uint8_t* lit, long long llen, int off, long long mlen) {
    const int tok_m = mlen ? (int)min(mlen - kMinMatch, 15LL) : 0;
    byte(((int)min(llen, 15LL) << 4) | tok_m);
    if (llen >= 15) lsic(llen);
    copy(lit, llen);
    if (mlen) {
      byte(off & 0xff);
      byte(off >> 8);
      if (mlen - kMinMatch >= 15) lsic(mlen - kMinMatch);
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

__global__ void __launch_bounds__(kThreads) lz4_encode_kernel(EncodeParams p) {
  const long long b = warp_chunk(p.batch);
  if (b < 0) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* d = p.data + b * p.row_bytes;
  const int32_t* nmp = p.nmp + b * p.row_bytes;
  const int32_t* dist = p.dist + b * p.row_bytes;
  // the codec clamps lengths to the row; so does the kernel, which then
  // never reads past a row whoever calls it
  const int n = (int)min((long long)max(p.lengths[b], 0), p.row_bytes);
  if (n == 0) {
    if (lane == 0) p.sizes[b] = 0;
    return;
  }
  Writer w{p.out + b * p.out_row, 0, lane};
  int a = 0;  // anchor: the first byte not yet emitted
  for (;;) {
    const int q = nmp[a];
    if (q >= n - 12) break;
    const int off = dist[q];
    const int m = extend(d, q, off, n - 5 - q, lane);
    w.sequence(d + a, q - a, off, m);
    a = q + m;
  }
  w.sequence(d + a, n - a, 0, 0);
  if (lane == 0) p.sizes[b] = (int32_t)w.o;
}

}  // namespace
}  // namespace tpucomp_lz4

// Launches the encode kernel on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int tc_lz4_encode(const void* data, const void* lengths, const void* nmp,
                             const void* dist, void* out, void* sizes, long long batch,
                             long long row_bytes, long long out_row, void* stream) {
  using namespace tpucomp_lz4;
  EncodeParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                 static_cast<const int32_t*>(nmp),   static_cast<const int32_t*>(dist),
                 static_cast<uint8_t*>(out),         static_cast<int32_t*>(sizes),
                 batch, row_bytes, out_row};
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lz4_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
