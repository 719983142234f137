// LZ4 decode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/lz_pallas.py::_lz4_decode_kernel.
// Its plain PyTorch version is tpucomp_torch/codecs/lz4.py::_decompress_plain;
// data, lengths and statuses are equal, including on corrupt input, and
// equal to the JAX package's XLA path (tpucomp/codecs/lz4.py::decompress)
// except where that path's packed parse tables cut LSIC runs of 512 bytes
// and more.
//
// Design: one warp per chunk.  The parse is sequential and uniform across
// the warp: token, literal LSIC, offset, match LSIC (a 255-run is scanned
// 32 bytes a step with a ballot).  Every check of the plain `_delimit` is
// mirrored literally, before any byte of the sequence is written:
// literals end at or before comp_len; the offset is in [1, o + llen]; the
// offset and match LSIC end at or before comp_len; the output stays
// within out_capacity.  So are its reads: bytes are read through the row
// with the index clamped to [0, CMAX - 1], the byte after the row's last
// is its first, and a 255-run stops at the row's last byte and takes its
// value.  The lanes then copy the literals, one byte each, and the match:
// out[o + k] = out[o - off + k mod off] reads only bytes before o, so a
// self-overlapping match needs no ordering inside it; __syncwarp() orders
// each copy after the one before.  A failing chunk zeroes what it wrote.
//
// The JAX loop records at most s_max = CMAX / 3 + 2 sequences and checks
// that bound every 8 steps: a chunk stops unfinished only after a multiple
// of 8 steps >= s_max, and when one ends past s_max its output continues
// the last recorded match periodically up to its length.  The kernel
// does the same.
//
// What bounds it on the H100: the latency of the parse's dependent loads
// (token, LSIC, offset) per sequence, with one warp per chunk; the copies
// move one byte per lane.  Device-memory bytes (the streams read, the
// output written) are far from the limit.  Staging the stream in shared
// memory and wider copies are later work.
//
// Covers streams and outputs up to 16 MB and more (positions in 64 bits).

#include "lz4_common.cuh"

namespace tpucomp_lz4 {
namespace {

constexpr int kStatusSuccess = 0;
constexpr int kStatusCannotDecompress = 12;

struct DecodeParams {
  const uint8_t* comp;
  const int32_t* comp_sizes;
  uint8_t* out;
  int32_t* lengths;
  int32_t* status;
  long long batch, row_bytes, out_capacity;
};

// One compressed row of c >= 1 bytes.
struct Stream {
  const uint8_t* p;
  long long c;

  __device__ int at(long long i) const { return p[i < 0 ? 0 : (i >= c ? c - 1 : i)]; }

  // The LSIC extension at i in [0, c): its byte count and the value it
  // adds beyond 15 (255 per 255-byte, then the last byte's value).
  __device__ void lsic(long long i, int lane, long long& bytes, long long& value) const {
    for (long long base = i;; base += 32) {
      const long long k = base + lane;
      const bool stop = k >= c - 1 || p[k] != 255;
      const unsigned hit = __ballot_sync(kFull, stop);
      if (hit) {
        const long long end = min(base + __ffs(hit) - 1, c - 1);
        bytes = end - i + 1;
        value = 255 * (end - i) + p[end];
        return;
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads) lz4_decode_kernel(DecodeParams P) {
  const long long b = warp_chunk(P.batch);
  if (b < 0) return;
  const int lane = threadIdx.x & 31;
  const Stream s{P.comp + b * P.row_bytes, P.row_bytes};
  const long long c = P.row_bytes, cap = P.out_capacity;
  uint8_t* out = P.out + b * cap;
  const long long comp_len = P.comp_sizes[b];
  const long long s_max = c / 3 + 2, s_stop = (s_max + 7) / 8 * 8;

  long long p = 0, o = 0, written = 0, last_off = 1;
  bool done = comp_len <= 0, ok = comp_len >= 0;
  for (long long step = 0; !done && step < s_stop; ++step) {
    const long long pc = p < 0 ? 0 : (p >= c ? c - 1 : p);
    const int token = s.at(pc);
    long long lb = 0, llen = token >> 4;
    if (llen == 15) {
      long long v;
      s.lsic((pc + 1) % c, lane, lb, v);
      llen = 15 + v;
    }
    const long long src = p + 1 + lb, q = src + llen;
    const bool is_last = q >= comp_len;
    const long long qc = q < 0 ? 0 : (q >= c ? c - 1 : q);
    const long long off = s.at(qc) | (s.at((qc + 1) % c) << 8);
    long long mb = 0, mlen = 0;
    if (!is_last) {
      mlen = token & 15;
      if (mlen == 15) {
        long long v;
        s.lsic((qc + 2) % c, lane, mb, v);
        mlen = 15 + v;
      }
      mlen += kMinMatch;
    }
    bool step_ok = q <= comp_len && o + llen + mlen <= cap;
    if (!is_last) step_ok = step_ok && off >= 1 && off <= o + llen && q + 2 + mb <= comp_len;
    if (!step_ok) {
      ok = false;
      break;
    }
    if (step < s_max) {
      for (long long k = lane; k < llen; k += 32) out[o + k] = (uint8_t)s.at(src + k);
      __syncwarp();
      copy_match(out, o + llen, off, mlen, lane);
      __syncwarp();
      written = o + llen + mlen;
      if (mlen) last_off = off;
    }
    o += llen + mlen;
    if (is_last) done = true;
    else p = q + 2 + mb;
  }
  ok = ok && done;
  if (ok && written < o) {
    // ended past s_max: the last recorded match runs on to the end
    copy_match(out, written, last_off, o - written, lane);
    __syncwarp();
  }
  if (!ok) {
    for (long long k = lane; k < written; k += 32) out[k] = 0;
  }
  if (lane == 0) {
    P.lengths[b] = ok ? (int32_t)o : 0;
    P.status[b] = ok ? kStatusSuccess : kStatusCannotDecompress;
  }
}

}  // namespace
}  // namespace tpucomp_lz4

// Launches the decode kernel on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int tc_lz4_decode(const void* comp, const void* comp_sizes, void* out, void* lengths,
                             void* status, long long batch, long long row_bytes,
                             long long out_capacity, void* stream) {
  using namespace tpucomp_lz4;
  DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                 static_cast<uint8_t*>(out),         static_cast<int32_t*>(lengths),
                 static_cast<int32_t*>(status),      batch, row_bytes, out_capacity};
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lz4_decode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
