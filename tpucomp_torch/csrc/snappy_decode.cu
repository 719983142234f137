// Snappy decode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel
// tpucomp/kernels/snappy_pallas.py::_snappy_decode_kernel.  Its plain
// PyTorch version is tpucomp_torch/codecs/snappy.py::_decompress_plain;
// data, lengths and statuses are equal on every input, corrupt ones
// included, and so equal to the JAX package's XLA path
// (tpucomp/codecs/snappy.py::decompress).
//
// What bounds it on the H100: the walk.  Each element's position depends
// on the one before, so a chunk is a chain of dependent steps, one warp
// per chunk, and the 4,096 chunks of a 256 MB batch are all resident at
// once (~31 warps per SM): only a shorter step helps.  On the earlier
// design of this kernel the step time grew 9-14% from 8 to 16 warps per SM
// and 36-66% from 16 to 31 (chip_smoke.py phase 14, PERF.md): at low
// occupancy a step waited on its chain of dependent device-memory loads
// and 64-bit remainders (latency), at the full batch also for issue slots.
// Device memory bytes are ~1% of the time.  So the design shortens the
// chain and cuts the instructions per element.  Now the step time grows 6%
// and 27% over the same ranges: the walk, a shuffle a link, and the copies
// still wait on both, less on issue.  The copies (write_batch) take 63%
// of a step's cycles on mixed, the walk 28% (scripts/
// torch_decode_clocks.py, PERF.md).
//
// The design (shared machinery in lz_decode_common.cuh):
//   - the stream is staged in shared memory (Window), the output's last
//     4 KB too (Out), so tags, literal bytes and near match sources are
//     shared-memory reads;
//   - the walk reads 32 positions at once: lane j steps an element at
//     base + j as if one started there (length and advance, from a
//     256-entry tag table in shared memory), and the walk then hops from
//     lane to lane by shuffles, one shuffle per element on its chain,
//     while it stays within those 32 positions;
//   - positions are 32-bit and the rolled reads compare and subtract: no
//     remainder on the walk;
//   - after up to 32 elements, each lane decodes and checks its own, all
//     at once, and write_batch writes them: literals and far matches in
//     one pass over the batch's bytes, then near matches in order, filled
//     from their period.
//
// Every check and read of the plain `_delimit` is mirrored literally,
// before any byte of an element is written: the varint is read from at
// most 4 bytes (the 4th's low 7 bits whatever its continuation bit); the
// tag is read with the index clamped into the row and the 4 bytes after
// it through the row rolled (past the row's last byte they wrap to its
// first); lengths, offsets and positions are int32 and wrap as the JAX
// package's do (add32); an element fails when it ends past comp_len, a
// copy's offset is 0 or reaches before the output, or the output would
// pass out_capacity.  The chunk decodes when it ended at comp_len and
// produced exactly the varint's length.  The JAX loop records at most
// s_max = CMAX / 2 + 2 elements and checks that bound every 8 steps: a
// chunk stops unfinished only after a multiple of 8 steps >= s_max, and
// when one ends past s_max its output continues the last recorded
// element periodically (a literal as a run of its last byte).  The two
// kernels below write every byte of the output row: zeros past the
// length, and across a row that fails.
//
// Output by start, not by stream order.  `lz77.materialize` gives each
// output byte t to the recorded element of length > 0 whose start in
// [0, out_capacity) is the largest at or before t, runs that element on
// past its end (a literal as a run of its last byte, a match
// periodically) and resolves match sources through the final output; a
// byte before every start reads the output's byte 0, and byte 0 then the
// row's first.  Where starts never go back this is stream order, which
// the walk writes.  They go back only after a literal of negative length
// (a 4-byte length field with its top bit set) or a wrapped sum; the walk
// then stops writing and flags the row, and a row that decodes with the
// flag set (or whose output nothing recorded covers) is left with status
// pending.  A second kernel, snappy_rewrite_kernel, writes such rows by
// start (`rewrite_by_start`): one walk of the row's elements marks each
// start with its element's stream position in an int32 scratch of one
// entry per output byte, then one pass over the output gives each byte
// the last mark at or before it and resolves sources within 32 bytes by
// pointer doubling over the lanes.  So a pending row costs one more walk
// and one element decode per output byte, linear in the row, and the
// kernel rewrites as many rows at once as the wrapper gives it scratch
// slots (out_capacity int32 each).  Only crafted streams reach it; no row
// of the corpora does, and on them the second launch only reads the
// statuses.  Two recorded elements with one start have no defined result
// in the JAX package (its scatter has duplicate indices); here the later
// one in the stream owns the start.
//
// Where `elements` is not null (tracing on, tpucomp_torch/utils/
// profiling.py), each row adds the elements the decode walk completed;
// null costs a branch a row.

#include "lz_decode_common.cuh"

namespace tpucomp_snappy {
namespace {

using namespace tpucomp_lzd;

constexpr int kStatusSuccess = 0;
constexpr int kStatusCannotDecompress = 12;
constexpr int kStatusPending = -1;  // decoded; snappy_rewrite_kernel writes its output by start

struct DecodeParams {
  const uint8_t* comp;
  const int32_t* comp_sizes;
  uint8_t* out;
  int32_t* lengths;
  int32_t* status;
  long long batch, row_bytes, out_capacity;
  unsigned long long* elements;  // the tracer's counter (profiling.py); null: count nothing
};

// Table entry of a tag.  x: bits 0-7 the length (a literal with extra
// length bytes: 1, to which their value is added), bits 8-10 the stream
// advance of a copy, or of a literal before its bytes (1 + the extra
// bytes), bits 12-14 copy1's offset bits 8-10, bit 31 set for a literal;
// y: the mask of a literal's extra length bytes (0 for a copy).
__device__ uint2 tag_entry(int tag) {
  const int kind = tag & 3, v = tag >> 2;
  if (kind == 0) {
    const unsigned lk = v < 60 ? 0 : v - 59;
    return make_uint2((lk ? 1u : (unsigned)v + 1) | (1u + lk) << 8 | 1u << 31,
                      lk >= 4 ? ~0u : (1u << (8 * lk)) - 1u);
  }
  if (kind == 1) return make_uint2((unsigned)((v & 7) + 4) | 2u << 8 | (unsigned)(tag >> 5) << 12, 0u);
  return make_uint2((unsigned)(v + 1) | (kind == 2 ? 3u : 5u) << 8, 0u);
}

// The varint at the row's start, as `_read_varint` reads it: at most 4
// bytes, the 4th's low 7 bits whatever its continuation bit.  Returns its
// byte count.
__device__ __forceinline__ int read_varint(const Window& w, int& n_out) {
  const int b0 = w.at(0), b1 = w.at(1), b2 = w.at(2), b3 = w.at(3);
  const int vlen = b0 < 128 ? 1 : (b1 < 128 ? 2 : (b2 < 128 ? 3 : 4));
  n_out = b0 & 0x7f;
  if (vlen >= 2) n_out |= (b1 & 0x7f) << 7;
  if (vlen >= 3) n_out |= (b2 & 0x7f) << 14;
  if (vlen >= 4) n_out |= (b3 & 0x7f) << 21;
  return vlen;
}

// The tag at p and the 4 bytes after it, as `_delimit` reads them: the
// tag's index clamped into the row, the bytes through the row rolled.
__device__ __forceinline__ void read_tag(const Window& w, int p, int& tag, unsigned& u4) {
  if (w.holds(p, 5)) {
    tag = w.s[p - w.base];
    u4 = w.u32_in(p + 1);
    return;
  }
  const int pc = clamp_row(p, w.c);
  tag = w.at(pc);
  u4 = 0;
  for (int k = 4; k >= 1; --k) {
    int i = pc + k;
    while (i >= w.c) i -= w.c;
    u4 = u4 << 8 | (unsigned)w.at(i);
  }
}

// The walk's step: the length and stream advance of the element at p
// (int32 sums that wrap, as the JAX package's).
__device__ __forceinline__ void walk_step(const uint2* tags, const Window& w, int p, int& len, int& adv) {
  int tag;
  unsigned u4;
  read_tag(w, p, tag, u4);
  const uint2 e = tags[tag];
  const unsigned l = (e.x & 0xff) + (u4 & e.y);
  len = (int)l;
  adv = (int)(((e.x >> 8) & 7) + (l & (unsigned)((int)e.x >> 31)));
}

// One element, as `_delimit` reads it at position p.
struct Element {
  int len, adv, src;  // output bytes, stream advance, literal source (row index) or copy offset
  bool lit;
};

__device__ __forceinline__ Element decode(const uint2* tags, const Window& w, int p) {
  int tag;
  unsigned u4;
  read_tag(w, p, tag, u4);
  const uint2 e = tags[tag];
  const unsigned head = (e.x >> 8) & 7, nx = head - 1;
  Element el;
  el.lit = (int)e.x < 0;
  el.len = (int)((e.x & 0xff) + (u4 & e.y));
  el.adv = (int)(head + (el.lit ? (unsigned)el.len : 0u));
  el.src = el.lit ? (int)((unsigned)p + head)
                  : (int)((u4 & (nx >= 4 ? ~0u : (1u << (8 * nx)) - 1u)) | ((e.x >> 12) & 7) << 8);
  return el;
}

// The row's output [0, total) as lz77.materialize computes it (header
// note), for a row that decoded with status kStatusPending: every one of
// its recorded elements passed its checks.  owner: total int32 of scratch.
// Linear in the row: one walk of its elements marks each start with the
// stream position of the last element that starts there, then one pass
// over the output gives each byte the last mark at or before it.
// Warp-collective.
__device__ void rewrite_by_start(const DecodeParams& P, long long b, const uint2* tags, uint8_t* win,
                                 int32_t* owner, int lane) {
  const int c = (int)P.row_bytes, comp_len = P.comp_sizes[b], total = P.lengths[b], s_max = c / 2 + 2;
  uint8_t* out = P.out + b * P.out_capacity;
  Window w{P.comp + b * P.row_bytes, win, c, 0, 0, 0};
  w.fill(0, lane);
  for (int t = lane; t < total; t += 32) owner[t] = -1;
  __syncwarp();
  int n_out;
  int p = read_varint(w, n_out), o = 0;
  for (int s = 0; s < s_max && p < comp_len; ++s) {  // the recorded elements, as the walk read them
    if (p >= 0 && p < c && !w.holds(p, min(5, c - p))) w.fill(p, lane);
    const Element el = decode(tags, w, p);
    if (lane == 0 && el.len > 0 && o >= 0 && o < total) owner[o] = p;  // a later element takes the start over
    p = (int)((unsigned)p + (unsigned)el.adv);
    o = (int)((unsigned)o + (unsigned)el.len);
  }
  __syncwarp();
  int prev_o = -1, prev_p = 0;  // the owner of the byte before these 32 (-1: none)
  for (int t0 = 0; t0 < total; t0 += 32) {
    const int t = t0 + lane;
    const int mark = t < total ? owner[t] : -1;
    int last = mark >= 0 ? lane : -1;  // the last lane at or before this one whose byte starts an element
    for (int s = 1; s < 32; s <<= 1) {
      const int v = __shfl_up_sync(kFull, last, s);
      if (lane >= s) last = max(last, v);
    }
    const int mp = __shfl_sync(kFull, mark, last < 0 ? 0 : last);
    const int eo = last < 0 ? prev_o : t0 + last, ep = last < 0 ? prev_p : mp;
    prev_o = __shfl_sync(kFull, eo, 31);
    prev_p = __shfl_sync(kFull, ep, 31);
    // each byte is a value, or the value of an earlier byte j
    bool has = false;
    int val = 0, j = 0;
    if (eo < 0) {
      has = t == 0;
      if (has) val = w.at(0);
    } else {
      const Element el = decode(tags, w, ep);
      if (el.lit) {
        const long long end = (long long)eo + el.len;
        has = t < end;
        if (has) val = w.at((long long)el.src + (t - eo));
        else j = (int)(end - 1);
      } else {
        j = eo - el.src + (t - eo) % el.src;
      }
    }
    for (int r = 0; r < 5; ++r) {  // chains inside these 32 bytes: at most 31 links
      const bool near = !has && j >= t0;
      const int from = near ? j - t0 : lane;
      const bool fh = __shfl_sync(kFull, has, from);
      const int fv = __shfl_sync(kFull, val, from), fj = __shfl_sync(kFull, j, from);
      if (near) {
        has = fh;
        val = fv;
        j = fj;
      }
    }
    if (t < total) out[t] = has ? (uint8_t)val : out[j];  // j < t0: final
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 8) snappy_decode_kernel(DecodeParams P) {
  __shared__ uint2 tags[256];
  __shared__ __align__(16) uint8_t win[kWarpsPerBlock][kWin + kWinPad];
  __shared__ uint8_t ring[kWarpsPerBlock][kRing];
  for (int t = threadIdx.x; t < 256; t += kThreads) tags[t] = tag_entry(t);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long b = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (b >= P.batch) return;
  const int c = (int)P.row_bytes, cap = (int)P.out_capacity;
  Out out{P.out + b * P.out_capacity, ring[warp]};
  const int comp_len = P.comp_sizes[b];
  const int s_max = c / 2 + 2, s_stop = (s_max + 7) / 8 * 8;
  Window w{P.comp + b * P.row_bytes, win[warp], c, 0, 0, 0};
  w.fill(0, lane);

  int n_out;
  const int vlen = read_varint(w, n_out);
  int p = vlen, o = 0, step = 0, written = 0, last_off = 1;
  bool done = comp_len <= vlen || comp_len <= 0, ok = comp_len > 0, back = false;
  while (!done && step < s_stop) {
    // walk up to 32 elements; lane k keeps the k-th one's position and output start
    const int m = min(32, s_stop - step), p0 = p;
    int my_p = p, my_o = o, k = 0;
    do {
      // lane j steps an element at base + j, as if one started there; the
      // walk then hops from lane to lane by shuffles while it stays within
      // these 32 positions
      if (!w.holds(p, 32 + 5) && p >= 0 && p < c && w.hi < c)  // restage, from the batch's start if it fits
        w.fill(p0 >= 0 && p0 <= p && p - p0 <= kWin - 256 ? p0 : p, lane);
      const int base = p;
      int len_j, adv_j;
      walk_step(tags, w, (int)((unsigned)base + lane), len_j, adv_j);
      do {
        const int j = (int)((unsigned)p - (unsigned)base);
        const int len = __shfl_sync(kFull, len_j, j), adv = __shfl_sync(kFull, adv_j, j);
        if (lane == k) {
          my_p = p;
          my_o = o;
        }
        p = (int)((unsigned)p + (unsigned)adv);
        o = (int)((unsigned)o + (unsigned)len);
      } while (++k < m && p < comp_len && (unsigned)p - (unsigned)base < 32u);
    } while (k < m && p < comp_len);
    // each lane checks its element; the row fails at the first that fails
    const bool mine = lane < k;
    const Element el = decode(tags, w, my_p);
    const int o2 = (int)((unsigned)my_o + (unsigned)el.len);
    const bool step_ok = (int)((unsigned)my_p + (unsigned)el.adv) <= comp_len && o2 <= cap &&
                         (el.lit || (el.src >= 1 && el.src <= my_o));
    if (__ballot_sync(kFull, mine && !step_ok)) {
      ok = false;
      break;
    }
    // from the first element whose output goes back on, nothing is written
    const unsigned backs = __ballot_sync(kFull, mine && o2 < my_o);
    const int first_back = back ? 0 : (backs ? __ffs(backs) - 1 : 32);
    back = back || backs;
    const bool rec = mine && lane < first_back && step + lane < s_max && el.len > 0;
    if (const unsigned recs = __ballot_sync(kFull, rec)) {
      const int last = 31 - __clz(recs);
      written = __shfl_sync(kFull, o2, last);
      last_off = __shfl_sync(kFull, el.lit ? 1 : el.src, last);
      write_batch(out, w, lane, rec, my_o, el.len, el.src, el.lit, __shfl_sync(kFull, my_o, __ffs(recs) - 1),
                  written);
    }
    step += k;
    done = p >= comp_len;
  }
  ok = ok && done && o == n_out && n_out <= cap;
  const bool by_start = ok && (back || (written == 0 && o > 0));  // snappy_rewrite_kernel writes [0, o)
  if (ok && !by_start && written < o) {
    // ended past s_max: the last recorded element runs on to the end
    copy_match(out, written, last_off, o - written, o - kRing, lane);
  }
  __syncwarp();
  zero_fill(out.g, ok ? o : 0, cap, lane);
  if (lane == 0) {
    P.lengths[b] = ok ? o : 0;
    P.status[b] = by_start ? kStatusPending : ok ? kStatusSuccess : kStatusCannotDecompress;
    if (P.elements && step) atomicAdd(P.elements, (unsigned long long)step);
  }
}

// The rows that snappy_decode_kernel left pending, by start; each block
// (one warp) takes every gridDim.x-th group of 32 rows, with its own
// out_capacity int32 of scratch.
__global__ void __launch_bounds__(32) snappy_rewrite_kernel(DecodeParams P, int32_t* scratch) {
  __shared__ uint2 tags[256];
  __shared__ __align__(16) uint8_t win[kWin + kWinPad];
  const int lane = threadIdx.x;
  for (int t = lane; t < 256; t += 32) tags[t] = tag_entry(t);
  __syncwarp();
  int32_t* owner = scratch + blockIdx.x * P.out_capacity;
  for (long long b0 = 32LL * blockIdx.x; b0 < P.batch; b0 += 32LL * gridDim.x) {
    const long long b = b0 + lane;
    for (unsigned pend = __ballot_sync(kFull, b < P.batch && P.status[b] == kStatusPending); pend;
         pend &= pend - 1) {
      const long long r = b0 + __ffs(pend) - 1;
      rewrite_by_start(P, r, tags, win, owner, lane);
      __syncwarp();
      if (lane == 0) P.status[r] = kStatusSuccess;
    }
  }
}

}  // namespace
}  // namespace tpucomp_snappy

// Launches the decode kernel, then the rewrite kernel, on `stream`;
// returns the first CUDA error (0 on success).  Rows below 2**30 bytes
// (the wrapper checks); scratch: slots x out_capacity int32, slots >= 1.
extern "C" int tc_snappy_decode(const void* comp, const void* comp_sizes, void* out,
                                void* lengths, void* status, long long batch,
                                long long row_bytes, long long out_capacity, void* scratch,
                                long long slots, void* elements, void* stream) {
  using namespace tpucomp_snappy;
  DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                 static_cast<uint8_t*>(out),         static_cast<int32_t*>(lengths),
                 static_cast<int32_t*>(status),      batch, row_bytes, out_capacity,
                 static_cast<unsigned long long*>(elements)};
  // shared memory over L1, so 8 CTAs fit an SM; set on every launch, for
  // the function's attributes are per device
  const cudaError_t carve = cudaFuncSetAttribute(snappy_decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                                 cudaSharedmemCarveoutMaxShared);
  if (carve != cudaSuccess) return (int)carve;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = (unsigned)((batch + kWarpsPerBlock - 1) / kWarpsPerBlock);
  snappy_decode_kernel<<<blocks, kThreads, 0, s>>>(p);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  const unsigned groups = (unsigned)((batch + 31) / 32);
  snappy_rewrite_kernel<<<slots < groups ? (unsigned)slots : groups, 32, 0, s>>>(p, static_cast<int32_t*>(scratch));
  return (int)cudaGetLastError();
}
