// LZ4 encode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/lz_pallas.py::_lz4_encode_kernel.
// Its plain PyTorch version is tpucomp_torch/codecs/lz4.py::_compress_plain;
// the streams are equal byte for byte, and equal to the JAX package's
// Pallas kernel and to the uncapped sequential oracle.
//
// Input: the chunk bytes and their match table (lz_match_table.cu, with
// the LZ4 limits: a candidate at most 65535 back and at most at n - 13),
// uint16, 0 where a position is no candidate.
//
// Design (shared machinery in lz_encode_common.cuh): one warp per chunk.
// The walk reads the table 32 positions at once and finds the next
// candidate by a ballot; each lane extends the match at its own position
// up to 16 bytes alone, so the walk hops between candidates by shuffles
// and only longer matches take the warp-cooperative extension (exact and
// unbounded, up to the end rule n - 5 - q).  A batch of up to 32
// sequences is then emitted at once: each lane computes its sequence's
// size (token, literal LSIC, literals, u16 LE offset, match LSIC), a
// prefix sum gives the output offsets, each lane writes its token,
// offset and short LSIC runs, long LSIC runs go warp-wide, and the
// literals of the batch are laid end to end a byte per lane.  The last
// sequence takes the literals [a, n).  The kernel writes every byte of
// the output row: zeros past the stream.
//
// What bounds it on the H100: the walk's dependent steps per sequence,
// one warp per chunk (a table load and a ballot per 32 positions, a
// shuffle per sequence, loads through L1), and the byte-per-lane copies
// of the literals.  Device-memory bytes (the chunk, 2 bytes of table per
// input byte, the stream) are far from the limit.  On an H100 at 700 W
// the longest chunk of the mixed batch walks at 375 ns a sequence with 8
// warps per SM and 525 with 31 (chip_smoke.py phase 14, PERF.md): mostly
// latency, some issue slots at the full batch.
//
// Covers chunks up to 16 MB (positions fit int32) with element strides
// 1, 2 and 4 (the stride lives in the table).
//
// Where `sequences` is not null (tracing on, tpucomp_torch/utils/
// profiling.py), each chunk adds the sequences it emitted, the last
// literals-only one included; null costs a branch a chunk.

#include "lz_encode_common.cuh"

namespace tpucomp_lz4 {
namespace {

using namespace tpucomp_lze;

constexpr int kLastLiterals = 5;  // a match ends at least 5 bytes before the end
constexpr int kLastMatch = 13;    // and starts at most at n - 13
constexpr int kOwnRun = 8;        // LSIC runs a lane writes itself; longer ones go warp-wide

struct EncodeParams {
  const uint8_t* data;
  const int32_t* lengths;
  const uint16_t* table;
  uint8_t* out;
  int32_t* sizes;
  long long batch, row_bytes, out_row;
  unsigned long long* sequences;  // the tracer's counter (profiling.py); null: count nothing
};

__device__ __forceinline__ int lsic_bytes(int v) { return v >= 15 ? (v - 15) / 255 + 1 : 0; }

// Writes batches of sequences at out[o...] (see encode_walk).
struct Emitter {
  const uint8_t* d;
  uint8_t* out;
  int o;
  int lane;

  __device__ void operator()(int lit, int ll, int off, int m, int count, bool) {
    const bool mine = lane < count;
    const int llb = mine ? lsic_bytes(ll) : 0;
    const int mlb = mine && m ? lsic_bytes(m - kMinMatch) : 0;
    const int size = mine ? 1 + llb + ll + (m ? 2 + mlb : 0) : 0;
    const int end = warp_inclusive(size, lane);
    const int at = o + end - size;  // this sequence's token
    const int mo = at + 1 + llb + ll;  // its offset
    if (mine) {
      out[at] = (uint8_t)((min(ll, 15) << 4) | (m ? min(m - kMinMatch, 15) : 0));
      if (m) {
        out[mo] = (uint8_t)(off & 0xff);
        out[mo + 1] = (uint8_t)(off >> 8);
      }
    }
    // LSIC runs: 255s, then the remainder
    fill_runs(out, at + 1, llb, 255, ll - 15 - 255 * (llb - 1), kOwnRun, lane);
    fill_runs(out, mo + 2, mlb, 255, m - kMinMatch - 15 - 255 * (mlb - 1), kOwnRun, lane);
    copy_flat(out, d, lit, at + 1 + llb, mine ? ll : 0, lane);
    o += __shfl_sync(kFull, end, 31);
  }
};

__global__ void __launch_bounds__(kThreads) lz4_encode_kernel(EncodeParams p) {
  const long long b = warp_chunk(p.batch);
  if (b < 0) return;
  const int lane = threadIdx.x & 31;
  const uint8_t* d = p.data + b * p.row_bytes;
  // the codec clamps lengths to the row; so does the kernel, which then
  // never reads past a row whoever calls it
  const int n = (int)min((long long)max(p.lengths[b], 0), p.row_bytes);
  Emitter emit{d, p.out + b * p.out_row, 0, lane};
  const int seqs =
      n > 0 ? encode_walk(d, p.table + b * p.row_bytes, n, kLastMatch, kLastLiterals, lane, emit) : 0;
  zero_fill(emit.out, emit.o, (int)p.out_row, lane);
  if (lane == 0) {
    p.sizes[b] = (int32_t)emit.o;
    if (p.sequences && seqs) atomicAdd(p.sequences, (unsigned long long)seqs);
  }
}

}  // namespace
}  // namespace tpucomp_lz4

// Launches the encode kernel on `stream`; returns cudaGetLastError() (0 on
// success).
extern "C" int tc_lz4_encode(const void* data, const void* lengths, const void* table, void* out,
                             void* sizes, long long batch, long long row_bytes, long long out_row,
                             void* sequences, void* stream) {
  using namespace tpucomp_lz4;
  EncodeParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                 static_cast<const uint16_t*>(table), static_cast<uint8_t*>(out),
                 static_cast<int32_t*>(sizes), batch, row_bytes, out_row,
                 static_cast<unsigned long long*>(sequences)};
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lz4_encode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
