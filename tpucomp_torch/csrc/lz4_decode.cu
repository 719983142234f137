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
// (scripts/torch_decode_clocks.py, PERF.md).  A chunk's walk and copies
// can overlap on two warps: at 8 chunks an SM that cuts a chunk's time by
// a third, but two warps for every chunk of the full batch leave 32
// registers a thread (the walk alone wants 56) and spill, or do not fit in
// one wave (PERF.md).  So every chunk keeps one warp of 64
// registers, and the second warp comes from warps that are idle: those
// whose chunk is done, in the tail where a few heavy chains set the
// kernel's time, and those a batch smaller than the card leaves free.
// On the 256 MB mixed batch that takes the kernel from 5.07 to 4.52 ms.
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
// Two warps a chunk where warps are idle (lz4_handoff.cuh): a CTA holds
// four chunks, a warp each, and eight CTAs an SM, so every chunk of a 256 MB
// batch starts at once with a warp of its own, as above.  A warp whose
// chunk is done (or that started with none: the launch gives up to twice
// as many warps as chunks where the card holds them) takes the copies of
// the CTA's chunk with the most sequences left that has no helper yet:
// from its next batch on, that chunk's own warp walks and checks alone and
// hands each batch of up to 16 checked sequences to the helper through a
// 2-slot ring in shared memory, and the helper writes them and ends the
// row.  The walk and the copies of a chunk then overlap instead of taking
// turns; the literals stay in the walker's stream window, which it stages
// anew only once the helper is done with every batch handed over.  A
// chunk whose helper comes after its last batch is ended by the helper
// all the same.
//
// Where `counters` is not null (tracing on, tpucomp_torch/utils/
// profiling.py), each row adds the sequences its walk completed (all of
// them when it decodes), the ring slots its walker filled, and the fills
// that found the ring full and waited on the helper, in three adjacent
// slots; null costs a branch a row.

#include <climits>

#include "lz4_handoff.cuh"

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
  // the tracer's counters (profiling.py), three adjacent slots: sequences,
  // hand-offs, walker waits; null: count nothing
  unsigned long long* counters;
};

constexpr int kWarps = 4;        // warps a CTA, and its chunks
constexpr int kBlocksPerSm = 8;  // 32 warps an SM, 64 registers a thread: every chunk of a
                                 // 256 MB batch of 64 KB chunks resident at once

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

// The CTA's chunks: the stream window, the output ring, the hand-off ring
// and its barriers of each, and its state (kAlone, kHelped, kEnded) and an
// estimate of the sequences it has left to walk, which an idle warp reads
// to choose the chunk it helps.
constexpr int kAlone = 0, kHelped = 1, kEnded = 2;
struct Chunks {
  uint8_t win[kWarps][kWin + kWinPad];
  uint8_t ring[kWarps][kRing];
  Slot slots[kWarps][kSlots];
  unsigned long long bars[kWarps][2 * kSlots];  // kSlots full, then kSlots empty
  int state[kWarps], left[kWarps];
};

// The end of a row that decoded (ok) into n bytes, or failed: the
// continuation past s_max, the zeros past the length (the whole row when
// it fails), its length and status.
__device__ __forceinline__ void end_row(const DecodeParams& P, long long b, Out& out, bool ok, int n, int written,
                                        int last_off, int lane) {
  if (ok && written < n) {
    // ended past s_max: the last recorded match runs on to the end
    copy_match(out, written, last_off, n - written, n - kRing, lane);
  }
  __syncwarp();
  zero_fill(out.g, ok ? n : 0, (int)P.out_capacity, lane);
  if (lane == 0) {
    P.lengths[b] = ok ? n : 0;
    P.status[b] = ok ? kStatusSuccess : kStatusCannotDecompress;
  }
}

// Chunk i of the CTA (row b) by the warp it was given to: the walk, every
// check, and the copies, batch by batch, as one warp, until an idle warp
// of the CTA has taken the copies (state kHelped); from the next batch on
// this warp walks alone and hands each batch over (Handoff), and the
// helper ends the row.
__device__ __forceinline__ void decode(const DecodeParams& P, long long b, int i, int lane, Chunks& S) {
  const int c = (int)P.row_bytes, cap = (int)P.out_capacity;
  const int comp_len = P.comp_sizes[b];
  const int s_max = c / 3 + 2, s_stop = (s_max + 7) / 8 * 8;
  volatile int* state = &S.state[i];
  volatile int* left = &S.left[i];
  Out out{P.out + b * P.out_capacity, S.ring[i]};
  Handoff h{S.slots[i], S.bars[i], S.bars[i] + kSlots, 0, 0};
  Window w{P.comp + b * P.row_bytes, S.win[i], c, 0, 0, 0};
  w.fill(0, lane);

  long long p = 0, o = 0;  // 64-bit: a corrupt LSIC run's value can pass 2**31
  int step = 0, written = 0, last_off = 1;
  bool done = comp_len <= 0, ok = comp_len >= 0, helped = false, sent_last = false;
  while (!done && step < s_stop) {
    if (lane == 0)  // the sequences left, at the density walked so far (a third of the stream at first)
      *left = p < comp_len ? (int)((float)(comp_len - p) * (step ? step : 1) / (step ? (float)p : 3.0f)) : 0;
    // walk up to kBatch sequences; lane k keeps the k-th one's fields
    const int m = min(kBatch, s_stop - step);
    const int p0 = p >= c ? c - 1 : (int)p;
    int my_o = 0, my_llen = 0, my_mlen = 0, my_mb = 0, my_src = 0, k = 0;
    long long my_q = 0;
    bool last = false;
    do {
      // lane j reads a sequence at base + j, as if one started there; the
      // walk then hops from lane to lane by shuffles while it stays within
      // these 32 positions, and steps a sequence with a long LSIC run itself
      const int pc = p >= c ? c - 1 : (int)p;  // p >= 0: it only grows, from 0
      if (!w.holds(pc, 64) && w.hi < c) {  // restage, from the batch's start if it fits,
        h.drain();                         // once a helper is done with the window
        w.fill(p0 <= pc && pc - p0 <= kWin - 256 ? p0 : pc, lane);
      }
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
    // the sequences before s_max are recorded: lanes 0 .. n - 1
    const unsigned recs = __ballot_sync(kFull, mine && step + lane < s_max);
    const int n = __popc(recs);
    const int o_first = written;
    if (n) {
      written = __shfl_sync(kFull, (int)ol + my_mlen, n - 1);
      if (const unsigned matches = __ballot_sync(kFull, lane < n && my_mlen > 0))
        last_off = __shfl_sync(kFull, off, 31 - __clz(matches));
    }
    step += k;
    done = last;
    if (!helped) helped = __shfl_sync(kFull, *state, 0) == kHelped;
    if (helped) {
      if (n || done)
        h.send(lane, n, make_int4(my_o, my_llen, my_mlen, my_src), off,
               make_int4(n, written, last_off, done ? kFinal | kRowOk : 0), make_int4(w.base, w.lo, w.hi, (int)o));
      sent_last = done;
    } else if (n) {
      // lanes 2j and 2j + 1 write sequence j's literals and match
      const int j = lane >> 1;
      const bool is_match = lane & 1;
      const int jo = __shfl_sync(kFull, my_o, j), jl = __shfl_sync(kFull, my_llen, j);
      const int jm = __shfl_sync(kFull, my_mlen, j), js = __shfl_sync(kFull, my_src, j);
      const int joff = __shfl_sync(kFull, off, j);
      const int e_len = is_match ? jm : jl;
      write_batch(out, w, lane, j < n && e_len > 0, is_match ? jo + jl : jo, e_len, is_match ? joff : js,
                  !is_match, o_first, written);
    }
  }
  ok = ok && done;
  if (!helped) {  // a helper that came after the last batch ends the row
    int was = kAlone;
    if (lane == 0) was = atomicExch((int*)state, kEnded);
    helped = __shfl_sync(kFull, was, 0) == kHelped;
  }
  if (helped) {
    if (!sent_last)
      h.send(lane, 0, int4{}, 0, make_int4(0, written, last_off, ok ? kFinal | kRowOk : kFinal),
             make_int4(w.base, w.lo, w.hi, ok ? (int)o : 0));
  } else {
    end_row(P, b, out, ok, (int)o, written, last_off, lane);  // o <= cap when the row decodes
  }
  if (lane == 0 && P.counters) {
    if (step) atomicAdd(P.counters, (unsigned long long)step);
    if (h.sent) atomicAdd(P.counters + 1, (unsigned long long)h.sent);
    if (h.waits) atomicAdd(P.counters + 2, (unsigned long long)h.waits);
  }
}

// The copies of chunk i of the CTA (row b), from the batch its walker hands
// over first to the row's end, by a warp that helps it.
__device__ __forceinline__ void help(const DecodeParams& P, long long b, int i, int lane, Chunks& S) {
  Out out{P.out + b * P.out_capacity, S.ring[i]};
  Window w{P.comp + b * P.row_bytes, S.win[i], (int)P.row_bytes, 0, 0, 0};
  unsigned long long* full = S.bars[i];
  unsigned long long* empty = S.bars[i] + kSlots;
  int4 head, tail;
  for (int t = 0;; ++t) {
    const int s = t % kSlots;
    mbar_wait(&full[s], (t / kSlots) & 1);
    const Slot& d = S.slots[i][s];
    head = d.head;
    tail = d.tail;
    if (head.x) {
      // lanes 2j and 2j + 1 write sequence j's literals and match
      w.base = tail.x;
      w.lo = tail.y;
      w.hi = tail.z;
      const int j = lane >> 1;
      const bool is_match = lane & 1, rec = j < head.x;
      const int4 q = rec ? d.seq[j] : int4{};
      const int e_len = is_match ? q.z : q.y;
      write_batch(out, w, lane, rec && e_len > 0, is_match ? q.x + q.y : q.x, e_len, is_match ? (int)d.off[j] : q.w,
                  !is_match, d.seq[0].x, head.y);
    }
    if (head.w & kFinal) break;
    mbar_arrive(&empty[s]);
  }
  end_row(P, b, out, head.w & kRowOk, tail.w, head.y, head.z, lane);
}

// The chunk an idle warp helps: of the CTA's chunks still decoded by one
// warp alone, the one with the most sequences left, taken for good (kAlone
// -> kHelped); -1 when there is none.
__device__ __forceinline__ int take(Chunks& S, int lane) {
  while (true) {
    const volatile int* state = S.state;
    const volatile int* left = S.left;
    const int mine = lane < kWarps && state[lane] == kAlone ? left[lane] : -1;
    const int most = __reduce_max_sync(kFull, mine);
    if (most < 0) return -1;
    const int i = __ffs(__ballot_sync(kFull, mine == most)) - 1;
    int won = 0;
    if (lane == 0) won = atomicCAS(&S.state[i], kAlone, kHelped) == kAlone;
    if (__shfl_sync(kFull, won, 0)) return i;
  }
}

// Warp i of CTA x decodes row i * gridDim.x + x, and then, as long as some
// chunk of its CTA is decoded by one warp alone, takes that chunk's copies.
__global__ void __launch_bounds__(32 * kWarps, kBlocksPerSm) lz4_decode_kernel(DecodeParams P) {
  __shared__ __align__(16) Chunks S;
  const int lane = threadIdx.x & 31, i = threadIdx.x >> 5;
  const long long b = (long long)i * gridDim.x + blockIdx.x;
  if (threadIdx.x < kWarps * 2 * kSlots) mbar_init(&S.bars[0][0] + threadIdx.x, 32);  // a warp's lanes
  if (threadIdx.x < kWarps) {
    const long long bt = (long long)threadIdx.x * gridDim.x + blockIdx.x;
    S.state[threadIdx.x] = bt < P.batch ? kAlone : kEnded;
    S.left[threadIdx.x] = bt < P.batch ? max(P.comp_sizes[bt], 0) / 3 : 0;
  }
  __syncthreads();
  if (b < P.batch) decode(P, b, i, lane, S);
  for (int j; (j = take(S, lane)) >= 0;) help(P, (long long)j * gridDim.x + blockIdx.x, j, lane, S);
}

}  // namespace
}  // namespace tpucomp_lz4

// Launches the decode kernel on `stream`; returns cudaGetLastError() (0 on
// success).  Rows below 2**30 bytes (the wrapper checks).
extern "C" int tc_lz4_decode(const void* comp, const void* comp_sizes, void* out, void* lengths,
                             void* status, long long batch, long long row_bytes,
                             long long out_capacity, void* counters, void* stream) {
  using namespace tpucomp_lz4;
  DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                 static_cast<uint8_t*>(out),         static_cast<int32_t*>(lengths),
                 static_cast<int32_t*>(status),      batch, row_bytes, out_capacity,
                 static_cast<unsigned long long*>(counters)};
  // shared memory over L1, so 8 CTAs fit an SM; set on every launch, for
  // the function's attributes are per device
  const cudaError_t carve = cudaFuncSetAttribute(lz4_decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  // a CTA a chunk a warp, and, where the card holds more CTAs, up to twice
  // as many warps as chunks: the warps that start with no chunk help at once
  static int sms_of[64];  // the SM count of each device, read once
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess && device < 64 && !sms_of[device])
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int sms = device < 64 ? sms_of[device] : 1;
  const long long need = (batch + kWarps - 1) / kWarps, room = (long long)kBlocksPerSm * sms;
  const unsigned blocks = (unsigned)(2 * need < room ? 2 * need : need > room ? need : room);
  lz4_decode_kernel<<<blocks, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
