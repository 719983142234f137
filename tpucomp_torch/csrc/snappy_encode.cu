// Snappy encode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel
// tpucomp/kernels/snappy_pallas.py::_snappy_encode_kernel.  Its plain
// PyTorch version is tpucomp_torch/codecs/snappy.py::_compress_plain; the
// streams are equal byte for byte, and equal to the JAX package's Pallas
// kernel and to the sequential oracle (tests/oracles/snappy_oracle.py).
//
// Input: the chunk bytes and their match table (lz_match_table.cu, with
// the Snappy limits: a candidate at most 32768 back and at most at
// n - 4), uint16, 0 where a position is no candidate.
//
// Design (shared machinery in lz_encode_common.cuh, as the LZ4 encoder):
// one warp per chunk; the walk reads the table 32 positions at once,
// finds the next candidate by a ballot, and hops between candidates by
// shuffles, each lane having extended the match at its own position up
// to 16 bytes alone; longer matches take the warp-cooperative extension
// (exact and unbounded, up to the chunk's end n - q: Snappy has no end
// rules).  The warp first writes the varint of n.  A batch of up to 32
// sequences is then emitted at once: each lane computes its sequence's
// size, a prefix sum gives the output offsets, and each lane writes its
// literal header (1 byte for runs of at most 60 bytes, else the tag
// 60 + k - 1 and k LE bytes of the length - 1, k = 1..3) and its copy
// elements (k64 copy2(64), a copy2(60) when the remainder is 65-67, and a
// final copy1 (length <= 11, offset < 2048) or copy2); runs of more than
// 4 copy2(64) go warp-wide, and the batch's literals are laid end to end
// a byte per lane.  The literals [a, n) close the stream.  The kernel
// writes every byte of the output row: zeros past the stream.
//
// What bounds it on the H100: the walk's dependent steps per sequence,
// one warp per chunk, and the byte-per-lane copies of the literals, as
// for LZ4.  Device-memory bytes are far from the limit.  On an H100 at 700 W
// the longest chunk of the mixed batch walks at 380 ns a sequence with 8
// warps per SM and 526 with 31 (chip_smoke.py phase 14, PERF.md): mostly
// latency, some issue slots at the full batch.
//
// Covers chunks up to 16 MB (a literal header holds at most 2**24 bytes;
// positions fit int32).
//
// Where `sequences` is not null (tracing on, tpucomp_torch/utils/
// profiling.py), each chunk adds the sequences its walk emitted, the last
// literals-only one included; null costs a branch a chunk.

#include "lz_encode_common.cuh"

namespace tpucomp_snappy {
namespace {

using namespace tpucomp_lze;

constexpr int kOwnCopies = 4;  // copy2(64) runs a lane writes itself; longer ones go warp-wide

struct EncodeParams {
  const uint8_t* data;
  const int32_t* lengths;
  const uint16_t* table;
  uint8_t* out;
  int32_t* sizes;
  long long batch, row_bytes, out_row;
  unsigned long long* sequences;  // the tracer's counter (profiling.py); null: count nothing
};

// Writes batches of sequences at out[o...] (see encode_walk): each as a
// literal element (none for ll = 0) and the copy elements of its match.
struct Emitter {
  const uint8_t* d;
  uint8_t* out;
  int o;
  int lane;

  __device__ void operator()(int lit, int ll, int off, int m, int count, bool) {
    const bool mine = lane < count;
    if (!mine) ll = m = 0;
    const int extra = ll <= 60 ? 0 : (ll <= 256 ? 1 : (ll <= 65536 ? 2 : 3));
    const int hdr = ll ? 1 + extra : 0;
    const int k64 = m >= 68 ? (m - 4) / 64 : 0;
    int fin = m - 64 * k64;
    const bool c60 = fin > 64;
    if (c60) fin -= 60;
    const bool c1 = fin <= 11 && off < 2048;
    const int copies = m ? 3 * k64 + (c60 ? 3 : 0) + (c1 ? 2 : 3) : 0;
    const int size = hdr + ll + copies;
    const int end = warp_inclusive(size, lane);
    const int at = o + end - size;
    const int lo = off & 0xff, hi = off >> 8;
    if (ll) {
      const int v = ll - 1;
      out[at] = (uint8_t)(ll <= 60 ? v << 2 : (59 + extra) << 2);
      for (int k = 0; k < extra; ++k) out[at + 1 + k] = (uint8_t)((v >> (8 * k)) & 0xff);
    }
    int co = at + hdr + ll;  // the copy elements
    for (unsigned big = __ballot_sync(kFull, k64 > kOwnCopies); big; big &= big - 1) {
      const int e = __ffs(big) - 1;
      const int eco = __shfl_sync(kFull, co, e), ek = __shfl_sync(kFull, k64, e);
      const int elo = __shfl_sync(kFull, lo, e), ehi = __shfl_sync(kFull, hi, e);
      for (int k = lane; k < 3 * ek; k += 32) {
        const int r = k % 3;
        out[eco + k] = (uint8_t)(r == 0 ? (63 << 2) | 2 : (r == 1 ? elo : ehi));
      }
    }
    if (m) {
      if (k64 <= kOwnCopies)
        for (int k = 0; k < k64; ++k) {
          out[co + 3 * k] = (uint8_t)((63 << 2) | 2);
          out[co + 3 * k + 1] = (uint8_t)lo;
          out[co + 3 * k + 2] = (uint8_t)hi;
        }
      co += 3 * k64;
      if (c60) {
        out[co] = (uint8_t)((59 << 2) | 2);
        out[co + 1] = (uint8_t)lo;
        out[co + 2] = (uint8_t)hi;
        co += 3;
      }
      if (c1) {
        out[co] = (uint8_t)(1 | ((fin - 4) << 2) | (hi << 5));
        out[co + 1] = (uint8_t)lo;
      } else {
        out[co] = (uint8_t)(((fin - 1) << 2) | 2);
        out[co + 1] = (uint8_t)lo;
        out[co + 2] = (uint8_t)hi;
      }
    }
    copy_flat(out, d, lit, at + hdr, ll, lane);
    o += __shfl_sync(kFull, end, 31);
  }
};

__global__ void __launch_bounds__(kThreads) snappy_encode_kernel(EncodeParams p) {
  const long long b = warp_chunk(p.batch);
  if (b < 0) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* d = p.data + b * p.row_bytes;
  // the codec clamps lengths to the row; so does the kernel, which then
  // never reads past a row whoever calls it
  const int n = (int)min((long long)max(p.lengths[b], 0), p.row_bytes);
  Emitter emit{d, p.out + b * p.out_row, 0, lane};
  for (unsigned v = (unsigned)n;; v >>= 7) {  // the varint of n
    if (lane == 0) emit.out[emit.o] = (uint8_t)(v >= 128 ? (v & 0x7f) | 0x80 : v);
    ++emit.o;
    if (v < 128) break;
  }
  const int seqs = n > 0 ? encode_walk(d, p.table + b * p.row_bytes, n, kMinMatch, 0, lane, emit) : 0;
  zero_fill(emit.out, emit.o, (int)p.out_row, lane);
  if (lane == 0) {
    p.sizes[b] = (int32_t)emit.o;
    if (p.sequences && seqs) atomicAdd(p.sequences, (unsigned long long)seqs);
  }
}

}  // namespace
}  // namespace tpucomp_snappy

// Launches the encode kernel on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int tc_snappy_encode(const void* data, const void* lengths, const void* table, void* out,
                                void* sizes, long long batch, long long row_bytes, long long out_row,
                                void* sequences, void* stream) {
  using namespace tpucomp_snappy;
  EncodeParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                 static_cast<const uint16_t*>(table), static_cast<uint8_t*>(out),
                 static_cast<int32_t*>(sizes), batch, row_bytes, out_row,
                 static_cast<unsigned long long*>(sequences)};
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  snappy_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
