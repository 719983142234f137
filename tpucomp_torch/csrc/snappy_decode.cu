// Snappy decode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel
// tpucomp/kernels/snappy_pallas.py::_snappy_decode_kernel.  Its plain
// PyTorch version is tpucomp_torch/codecs/snappy.py::_decompress_plain;
// data, lengths and statuses are equal, including on corrupt input, and
// equal to the JAX package's XLA path (tpucomp/codecs/snappy.py::decompress)
// on every stream without a literal of negative length (below).
//
// Design: one warp per chunk.  The walk is sequential and uniform across
// the warp: the varint, then per element the tag and the 4 bytes after
// it, classified as literal (1-4 extra length bytes), copy1, copy2 or
// copy4.  Every check and read of the plain `_delimit` is mirrored
// literally, before any byte of the element is written: the varint is
// read from at most 4 bytes (the 4th's low 7 bits whatever its
// continuation bit); the tag is read with the index clamped into the row
// and the 4 bytes after it through the row rolled (past the row's last
// byte they wrap to its first); lengths, offsets and positions are int32
// and wrap as the JAX package's do (add32); an element fails when it
// ends past comp_len, a copy's offset is 0 or reaches before the output,
// or the output would pass out_capacity.  The lanes then copy the
// literal, one byte each, or the match: out[o+k] = out[o-off + k mod off]
// reads only bytes before o, so a self-overlapping match needs no
// ordering inside it; __syncwarp() orders each element after the one
// before.  The chunk decodes when it ended at comp_len and produced
// exactly the varint's length; a failing chunk zeroes what it wrote.
//
// The JAX loop records at most s_max = CMAX / 2 + 2 elements and checks
// that bound every 8 steps: a chunk stops unfinished only after a multiple
// of 8 steps >= s_max, and when one ends past s_max its output continues
// the last recorded element periodically up to its length (a literal as
// a run of its last byte).  The kernel does the same.
//
// One divergence, pinned by tests/test_torch_snappy.py: a literal whose
// 4-byte length field has its top bit set has a length <= 0 and moves the
// output position back; the JAX path resolves the overlapping elements
// that follow by their output starts, the kernel in stream order (it
// never writes outside [0, out_capacity)).  Statuses and lengths agree.
//
// What bounds it on the H100: the latency of the walk's dependent loads
// (tag, then the next element's tag) per element, with one warp per
// chunk; the copies move one byte per lane.  Device-memory bytes (the
// streams read, the output written) are far from the limit.  Staging the
// stream in shared memory and wider copies are later work.
//
// Covers streams and outputs up to 16 MB and more (positions in 64 bits
// where they index memory).

#include "lz4_common.cuh"

namespace tpucomp_snappy {
namespace {

using tpucomp_lz4::copy_match;
using tpucomp_lz4::kThreads;
using tpucomp_lz4::kWarpsPerBlock;
using tpucomp_lz4::warp_chunk;

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

// int32 addition that wraps, as XLA's does
__device__ __forceinline__ int add32(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__global__ void __launch_bounds__(kThreads) snappy_decode_kernel(DecodeParams P) {
  const long long b = warp_chunk(P.batch);
  if (b < 0) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* row = P.comp + b * P.row_bytes;
  const long long c = P.row_bytes, cap = P.out_capacity;
  uint8_t* out = P.out + b * cap;
  const int comp_len = P.comp_sizes[b];
  const long long s_max = c / 2 + 2, s_stop = (s_max + 7) / 8 * 8;

  auto at = [&](long long i) -> int { return row[i < 0 ? 0 : (i >= c ? c - 1 : i)]; };
  const int b0 = at(0), b1 = at(1), b2 = at(2), b3 = at(3);
  const int vlen = b0 < 128 ? 1 : (b1 < 128 ? 2 : (b2 < 128 ? 3 : 4));
  int n_out = b0 & 0x7f;
  if (vlen >= 2) n_out |= (b1 & 0x7f) << 7;
  if (vlen >= 3) n_out |= (b2 & 0x7f) << 14;
  if (vlen >= 4) n_out |= (b3 & 0x7f) << 21;

  int p = vlen, o = 0, last_off = 1;
  long long written = 0, high = 0;  // end of the last recorded element; highest byte written
  bool done = comp_len <= vlen || comp_len <= 0, ok = comp_len > 0;
  for (long long step = 0; !done && step < s_stop; ++step) {
    const long long pc = p < 0 ? 0 : (p >= c ? c - 1 : p);
    const int tag = row[pc];
    const unsigned e1 = row[(pc + 1) % c], e2 = row[(pc + 2) % c], e3 = row[(pc + 3) % c],
                   e4 = row[(pc + 4) % c];
    const int u4 = (int)(e1 | e2 << 8 | e3 << 16 | e4 << 24);
    const int kind = tag & 3;
    int len, off = 0, adv, lit_src = 0;
    if (kind == 0) {
      const int lraw = tag >> 2, lk = lraw < 60 ? 0 : lraw - 59;
      const int lv = lk == 0   ? lraw
                     : lk == 1 ? (int)e1
                     : lk == 2 ? (int)(e1 | e2 << 8)
                     : lk == 3 ? (int)(e1 | e2 << 8 | e3 << 16)
                               : u4;
      len = add32(lv, 1);
      lit_src = add32(p, 1 + lk);
      adv = add32(1 + lk, len);
    } else {
      len = kind == 1 ? ((tag >> 2) & 7) + 4 : (tag >> 2) + 1;
      off = kind == 1 ? ((tag >> 5) << 8) | (int)e1 : (kind == 2 ? (int)(e1 | e2 << 8) : u4);
      adv = kind == 1 ? 2 : (kind == 2 ? 3 : 5);
    }
    const int p2 = add32(p, adv), o2 = add32(o, len);
    const bool step_ok = p2 <= comp_len && o2 <= cap && (kind == 0 || (off >= 1 && off <= o));
    if (!step_ok) {
      ok = false;
      break;
    }
    if (step < s_max && len > 0) {
      // the bytes [lo, hi) of the element that lie in the output (o and o2
      // may have wrapped; a copy has o >= off >= 1)
      const long long lo = max((long long)o, 0LL), hi = min((long long)o + len, cap);
      if (kind == 0) {
        for (long long t = lo + lane; t < hi; t += 32) out[t] = (uint8_t)at((long long)lit_src + (t - o));
        last_off = 1;
      } else {
        if (hi > o) copy_match(out, o, off, hi - o, lane);
        last_off = off;
      }
      __syncwarp();
      written = o2;
      high = max(high, hi);
    }
    p = p2;
    o = o2;
    done = p2 >= comp_len;
  }
  ok = ok && done && o == n_out && n_out <= cap;
  if (ok && written < o && written >= last_off) {
    // ended past s_max: the last recorded element runs on to the end
    copy_match(out, written, last_off, o - written, lane);
    high = max(high, (long long)o);
  }
  __syncwarp();
  for (long long k = (ok ? o : 0) + lane; k < high; k += 32) out[k] = 0;
  if (lane == 0) {
    P.lengths[b] = ok ? o : 0;
    P.status[b] = ok ? kStatusSuccess : kStatusCannotDecompress;
  }
}

}  // namespace
}  // namespace tpucomp_snappy

// Launches the decode kernel on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int tc_snappy_decode(const void* comp, const void* comp_sizes, void* out,
                                void* lengths, void* status, long long batch,
                                long long row_bytes, long long out_capacity, void* stream) {
  using namespace tpucomp_snappy;
  DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                 static_cast<uint8_t*>(out),         static_cast<int32_t*>(lengths),
                 static_cast<int32_t*>(status),      batch, row_bytes, out_capacity};
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  snappy_decode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
