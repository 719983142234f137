// LZ4 decode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/lz_pallas.py::_lz4_decode_kernel.
// Its plain PyTorch version is tpucomp_torch/codecs/lz4.py::_decompress_plain;
// data, lengths and statuses are equal on every input, corrupt ones
// included, and equal to the JAX package's XLA path
// (tpucomp/codecs/lz4.py::decompress) except where that path's packed
// parse tables cut LSIC runs of 512 bytes and more.
//
// What bounds it on the H100: the walk.  Each sequence's position depends
// on the one before, so a chunk is a chain of dependent steps, one warp
// per chunk, and the 4,096 chunks of a 256 MB batch are all resident at
// once (~31 warps per SM): only a shorter step helps.  On the earlier
// design of this kernel the step time grew 14% from 8 to 16 warps per SM
// and 66% from 16 to 31 (chip_smoke.py phase 14, PERF.md): at low
// occupancy a step waited on its chain of dependent device-memory loads
// (token, LSIC, offset) and 64-bit remainders (latency), at the full batch
// also for issue slots.  Device memory bytes are ~1% of the time.  So the
// design shortens the chain and cuts the instructions per sequence.  Now
// the step time grows 10% and 41% over the same ranges: the walk, a
// shuffle a link, and the copies still wait on both, less on issue.  The
// copies (write_batch) take 45% of a step's cycles on mixed, the walk 43%
// (scripts/torch_decode_clocks.py, PERF.md).
//
// The design (shared machinery in lz_decode_common.cuh): the stream is
// staged in shared memory (Window), the output's last 4 KB too (Out);
// the walk reads 32 positions at once: lane j reads a sequence at base +
// j as if one started there (token, LSIC runs of up to 4 bytes, alone),
// and the walk hops from lane to lane by shuffles while it stays within
// those 32 positions; a sequence with a longer LSIC run the warp steps
// together, scanning the run 32 bytes a step with a ballot.  Positions
// are 64-bit only where an LSIC value can pass 2**31; the rolled reads
// compare and subtract, no remainder.  After up to 16 sequences, each
// lane checks its own, all at once, and write_batch writes their literal
// runs and matches: literals and far matches in one pass over the
// batch's bytes, then near matches in order, filled from their period.
//
// Every check of the plain `_delimit` is mirrored literally, before any
// byte of the sequence is written: literals end at or before comp_len;
// the offset is in [1, o + llen]; the offset and match LSIC end at or
// before comp_len; the output stays within out_capacity.  So are its
// reads: bytes are read through the row with the index clamped to
// [0, CMAX - 1], the byte after the row's last is its first, and a
// 255-run stops at the row's last byte and takes its value.  The JAX loop
// records at most s_max = CMAX / 3 + 2 sequences and checks that bound
// every 8 steps: a chunk stops unfinished only after a multiple of 8
// steps >= s_max, and when one ends past s_max its output continues the
// last recorded match periodically up to its length.  The kernel writes
// every byte of the output row: zeros past the length, and across a row
// that fails.
//
// Where `sequences` is not null (tracing on, tpucomp_torch/utils/
// profiling.py), each row adds the sequences its walk completed (all of
// them when it decodes); null costs a branch a row.

#include <climits>

#include "lz_decode_common.cuh"

namespace tpucomp_lz4 {
namespace {

using namespace tpucomp_lzd;

constexpr int kStatusSuccess = 0;
constexpr int kStatusCannotDecompress = 12;

struct DecodeParams {
  const uint8_t* comp;
  const int32_t* comp_sizes;
  uint8_t* out;
  int32_t* lengths;
  int32_t* status;
  long long batch, row_bytes, out_capacity;
  unsigned long long* sequences;  // the tracer's counter (profiling.py); null: count nothing
};

__device__ __forceinline__ int next_in_row(int i, int c) { return i + 1 == c ? 0 : i + 1; }

// The LSIC extension at row index i in [0, c): its byte count and the
// value it adds beyond 15 (255 per 255-byte, then the last byte's value).
// Collective: the lanes scan 32 bytes a step, with a ballot.
__device__ __forceinline__ void lsic_warp(const Window& w, int i, int lane, int& bytes, long long& value) {
  const int first = w.at(i);
  if (first != 255 || i >= w.c - 1) {
    bytes = 1;
    value = first;
    return;
  }
  for (int base = i;; base += 32) {
    const int k = base + lane;
    const bool stop = k >= w.c - 1 || w.at(k) != 255;
    const unsigned hit = __ballot_sync(kFull, stop);
    if (hit) {
      const int end = min(base + __ffs(hit) - 1, w.c - 1);
      bytes = end - i + 1;
      value = 255LL * (end - i) + w.at(end);
      return;
    }
  }
}

// The same, by one lane alone, for runs of at most kShortRun bytes: false
// past them.
constexpr int kShortRun = 4;
__device__ __forceinline__ bool lsic_lane(const Window& w, int i, int& bytes, long long& value) {
  int k = i;
  while (k < w.c - 1 && w.at(k) == 255)
    if (++k - i >= kShortRun) return false;
  bytes = k - i + 1;
  value = 255LL * (k - i) + w.at(k);
  return true;
}

// The sequence at stream position pos >= 0, as `_delimit` reads it.
struct Seq {
  long long llen, mlen, src, q, next;  // lengths, literal source, offset position, next sequence
  int mb;                              // the match LSIC's bytes
  bool last;                           // the literals reach comp_len: no match
};

// Collective: every lane passes the same pos.
__device__ __forceinline__ void seq_at(const Window& w, long long pos, int comp_len, int lane, Seq& s) {
  const int c = w.c, pc = pos >= c ? c - 1 : (int)pos;
  const int token = w.at(pc);
  int lb = 0;
  long long v;
  s.llen = token >> 4;
  s.mlen = token & 15;
  s.mb = 0;
  if (s.llen == 15) {
    lsic_warp(w, next_in_row(pc, c), lane, lb, v);
    s.llen = 15 + v;
  }
  s.src = pos + 1 + lb;
  s.q = s.src + s.llen;
  s.last = s.q >= comp_len;
  if (s.last) {
    s.mlen = 0;
  } else {
    if (s.mlen == 15) {
      lsic_warp(w, next_in_row(next_in_row(clamp_row(s.q, c), c), c), lane, s.mb, v);
      s.mlen = 15 + v;
    }
    s.mlen += kMinMatch;
  }
  s.next = s.q + 2 + s.mb;
}

// The same by one lane alone, relative to pos, when both LSIC runs are
// at most kShortRun bytes (false otherwise): the lengths stay small.
struct Near {
  int llen, mlen, lb, mb;
  int next;  // next sequence - pos
  bool last;
};

__device__ __forceinline__ bool near_at(const Window& w, long long pos, int comp_len, Near& s) {
  const int c = w.c, pc = pos >= c ? c - 1 : (int)pos;
  const int token = w.at(pc);
  long long v;
  s.llen = token >> 4;
  s.mlen = token & 15;
  s.lb = s.mb = 0;
  if (s.llen == 15) {
    if (!lsic_lane(w, next_in_row(pc, c), s.lb, v)) return false;
    s.llen = 15 + (int)v;
  }
  const int q = 1 + s.lb + s.llen;
  s.last = pos + q >= comp_len;
  if (s.last) {
    s.mlen = 0;
  } else {
    if (s.mlen == 15) {
      if (!lsic_lane(w, next_in_row(next_in_row(clamp_row(pos + q, c), c), c), s.mb, v)) return false;
      s.mlen = 15 + (int)v;
    }
    s.mlen += kMinMatch;
  }
  s.next = q + 2 + s.mb;
  return true;
}

__global__ void __launch_bounds__(kThreads, 8) lz4_decode_kernel(DecodeParams P) {
  __shared__ __align__(16) uint8_t win[kWarpsPerBlock][kWin + kWinPad];
  __shared__ uint8_t ring[kWarpsPerBlock][kRing];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= P.batch) return;
  const int c = (int)P.row_bytes, cap = (int)P.out_capacity;
  Out out{P.out + b * P.out_capacity, ring[warp]};
  const int comp_len = P.comp_sizes[b];
  const int s_max = c / 3 + 2, s_stop = (s_max + 7) / 8 * 8;
  Window w{P.comp + b * P.row_bytes, win[warp], c, 0, 0, 0};
  w.fill(0, lane);

  long long p = 0, o = 0;  // 64-bit: a corrupt LSIC run's value can pass 2**31
  int step = 0, written = 0, last_off = 1;
  bool done = comp_len <= 0, ok = comp_len >= 0;
  while (!done && step < s_stop) {
    // walk up to 16 sequences; lane k keeps the k-th one's fields
    const int m = min(16, s_stop - step);
    const int p0 = p >= c ? c - 1 : (int)p;
    int my_o = 0, my_llen = 0, my_mlen = 0, my_mb = 0, my_src = 0, k = 0;
    long long my_q = 0;
    bool last = false;
    do {
      // lane j reads a sequence at base + j, as if one started there; the
      // walk then hops from lane to lane by shuffles while it stays within
      // these 32 positions, and steps a sequence with a long LSIC run itself
      const int pc = p >= c ? c - 1 : (int)p;  // p >= 0: it only grows, from 0
      if (!w.holds(pc, 64) && w.hi < c)  // restage, from the batch's start if it fits
        w.fill(p0 <= pc && pc - p0 <= kWin - 256 ? p0 : pc, lane);
      const long long base = p;
      Near nj{};
      const int rel_j = near_at(w, base + lane, comp_len, nj) ? lane + nj.next : -1;  // -1: step it collectively
      const int out_j = (nj.llen + nj.mlen) | (nj.last ? INT_MIN : 0);              // top bit: the last
      int my_j = -1;  // the lane whose reading this lane's sequence is, in this round
      while (true) {
        const int j = (int)(p - base);
        const int rel = __shfl_sync(kFull, rel_j, j);
        if (rel >= 0) {
          const int ob = __shfl_sync(kFull, out_j, j);
          if (lane == k) {
            my_o = (int)o;
            my_j = j;
          }
          o += ob & INT_MAX;
          p = base + rel;
          last = ob < 0;
        } else {
          Seq u;
          seq_at(w, p, comp_len, lane, u);
          if (lane == k) {  // a length past 2**31 - 1 fails its check as 2**31 - 1 does
            my_o = (int)o;
            my_llen = (int)min(u.llen, (long long)INT_MAX);
            my_mlen = (int)min(u.mlen, (long long)INT_MAX);
            my_mb = u.mb;
            my_src = (int)min(u.src, (long long)INT_MAX);
            my_q = u.q;
          }
          o += u.llen + u.mlen;
          p = u.next;
          last = u.last;
        }
        if (++k >= m || last || p - base >= 32) break;
      }
      // the sequences read by lanes take their fields from them
      const int from = my_j < 0 ? lane : my_j;
      const int f_llen = __shfl_sync(kFull, nj.llen, from), f_mlen = __shfl_sync(kFull, nj.mlen, from);
      const int f_lb = __shfl_sync(kFull, nj.lb, from), f_mb = __shfl_sync(kFull, nj.mb, from);
      if (my_j >= 0) {
        my_llen = f_llen;
        my_mlen = f_mlen;
        my_mb = f_mb;
        my_src = (int)(base + my_j + 1 + f_lb);
        my_q = base + my_j + 1 + f_lb + f_llen;
      }
    } while (k < m && !last);
    // each lane checks its sequence; the row fails at the first that fails
    const bool mine = lane < k;
    const int qc = clamp_row(my_q, c);
    const int off = w.at(qc) | w.at(next_in_row(qc, c)) << 8;
    const long long ol = (long long)my_o + my_llen;
    const bool step_ok = my_q <= comp_len && ol + my_mlen <= cap &&
                         (my_mlen == 0 || (off >= 1 && off <= ol && my_q + 2 + my_mb <= comp_len));
    if (__ballot_sync(kFull, mine && !step_ok)) {
      ok = false;
      break;
    }
    // lanes 2j and 2j + 1 write sequence j's literals and match
    const bool rec = mine && step + lane < s_max;
    const int j = lane >> 1;
    const bool is_match = lane & 1;
    const int jo = __shfl_sync(kFull, my_o, j), jl = __shfl_sync(kFull, my_llen, j);
    const int jm = __shfl_sync(kFull, my_mlen, j), js = __shfl_sync(kFull, my_src, j);
    const int joff = __shfl_sync(kFull, off, j);
    const bool jrec = __shfl_sync(kFull, rec, j);
    const int e_len = is_match ? jm : jl;
    if (const unsigned recs = __ballot_sync(kFull, rec)) {
      const int first = __ffs(recs) - 1, lastr = 31 - __clz(recs);
      written = __shfl_sync(kFull, (int)ol + my_mlen, lastr);
      if (const unsigned matches = __ballot_sync(kFull, rec && my_mlen > 0))
        last_off = __shfl_sync(kFull, off, 31 - __clz(matches));
      write_batch(out, w, lane, jrec && e_len > 0, is_match ? jo + jl : jo, e_len, is_match ? joff : js,
                  !is_match, __shfl_sync(kFull, my_o, first), written);
    }
    step += k;
    done = last;
  }
  ok = ok && done;
  const int n = ok ? (int)o : 0;  // o <= cap when the row decodes
  if (ok && written < n) {
    // ended past s_max: the last recorded match runs on to the end
    copy_match(out, written, last_off, n - written, n - kRing, lane);
  }
  __syncwarp();
  zero_fill(out.g, n, cap, lane);
  if (lane == 0) {
    P.lengths[b] = n;
    P.status[b] = ok ? kStatusSuccess : kStatusCannotDecompress;
    if (P.sequences && step) atomicAdd(P.sequences, (unsigned long long)step);
  }
}

}  // namespace
}  // namespace tpucomp_lz4

// Launches the decode kernel on `stream`; returns cudaGetLastError() (0 on
// success).  Rows below 2**30 bytes (the wrapper checks).
extern "C" int tc_lz4_decode(const void* comp, const void* comp_sizes, void* out, void* lengths,
                             void* status, long long batch, long long row_bytes,
                             long long out_capacity, void* sequences, void* stream) {
  using namespace tpucomp_lz4;
  DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                 static_cast<uint8_t*>(out),         static_cast<int32_t*>(lengths),
                 static_cast<int32_t*>(status),      batch, row_bytes, out_capacity,
                 static_cast<unsigned long long*>(sequences)};
  // shared memory over L1, so 8 CTAs fit an SM; set on every launch, for
  // the function's attributes are per device
  const cudaError_t carve = cudaFuncSetAttribute(lz4_decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lz4_decode_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
