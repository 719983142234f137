// Cascaded decode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/cascaded_pallas.py:874
// _decode_kernel (_decode_one, _unpack_blob_tile, _delta_decode_tile,
// _rle_decode_tile).  Its plain PyTorch version is
// tpucomp_torch/codecs/cascaded.py::_decompress_plain; data, byte counts and
// statuses are equal, including on corrupt input.
//
// What bounds it on the H100: device-memory bytes would (one read of the
// stream, one write of the output row), but each chunk's inverse pipeline
// is a chain of dependent passes (unpack, RLE expansion, Delta prefix sum,
// RLE expansion), so latency bounds it unless many chunks are in flight.
// The first port decoded a partition's chunks one after another in one
// CTA, with one thread parsing each chunk's metadata while 255 waited and
// a binary search per output element.
//
// Design: walk the chain once, decode in parallel, place after counting.
// - One lane of the partition's first team follows the chunk chain (each
//   total clamped to the row size + 8, the next chunk at roundUp(pos +
//   max(total, 4), w), the walk stopping at end4 or after k chunks) for up
//   to `slots` chunks at a time; then one lane per chunk parses its
//   metadata and checks every blob against the compressed size before any
//   blob is read.
// - One warp (a team) decodes one chunk with warp primitives only: the
//   final blob is unpacked by lane (consecutive elements on consecutive
//   lanes), Delta is a warp scan over contiguous odd-length lane segments
//   (conflict-free shared memory), RLE is expanded by scattering each
//   run's start at its scanned offset and filling forward with a max-scan.
//   Blob reads keep the JAX reference's word addressing (offsets floored
//   to a word, word indices clamped into the row), so corrupt streams
//   decode as there.
// - The teams of a partition read each other's element counts: their
//   running sum (64-bit) places each chunk's first min(n, E) elements and
//   decides the partition, on the same conditions as the reference: a
//   chunk fails its checks, the running count passes n_elems, the final
//   count differs from n_elems, or chunks are left before end4.  The
//   outcome is all or nothing, so a failed partition writes zeros over
//   whatever it placed.
// - Every byte of every row up to out_capacity is written (data, then
//   zeros; or zeros), so the wrapper allocates with torch.empty.  The raw
//   fallback is a vectorised copy.
// - Teams per CTA are sized by the workspace (plan_teams), so a batch of
//   one-chunk partitions (CascadedManager's default) puts several
//   partitions in one CTA.
//
// The chunk element counts are summed in 64 bits; the JAX reference sums
// them in int32, so the two could differ only on streams whose chunks claim
// more than 2**31 elements in total.
//
// Elements are held in 32-bit units for widths 1, 2 and 4 and in 64-bit
// units for 8 (LONGLONG / ULONGLONG), one instantiation each; the 64-bit
// one reads tpucomp's XLA streams for w = 8: a 16-byte bitpack header,
// bit widths up to 64 (an element spans up to three words), 8-byte Delta
// first values, Delta wrapping in 64 bits.
//
// Supported: element widths 1, 2, 4 and 8; every validated option set.

#include "cascaded_common.cuh"

namespace tpucomp {
namespace {

constexpr int kStatusSuccess = 0;
constexpr int kStatusCannotDecompress = 12;
constexpr long long kNoChunk = -2, kBadChunk = -1;  // chunk counts that are not counts
constexpr uint32_t kNoRun = 0xffffffffu;

struct DecodeParams {
  const uint8_t* comp;
  const int32_t* comp_sizes;
  uint8_t* out;
  int32_t* out_bytes;
  int32_t* status;
  long long batch, row_bytes, out_capacity;  // row_bytes: CMAX
  int width, dtype, elems, k, nr, nd, bp;
  int slots, parts, arr_words;  // TeamPlan; E rounded up to 4: the elements of each of a team's arrays
};

// One compressed row, read as bytes (zero past its end) or as u32 words
// (the index clamped into [0, nwords), bytes past the end zero).
struct Row {
  const uint8_t* p;
  long long bytes, nwords;
  bool aligned;

  __device__ uint8_t byte(long long i) const { return i < bytes ? p[i] : 0; }

  __device__ uint32_t word(long long j) const {
    j = j < 0 ? 0 : (j >= nwords ? nwords - 1 : j);
    const long long at = 4 * j;
    if (aligned && at + 4 <= bytes) return *reinterpret_cast<const uint32_t*>(p + at);
    uint32_t v = 0;
    for (int q = 0; q < 4; ++q) v |= (uint32_t)byte(at + q) << (8 * q);
    return v;
  }

  // u32 of the 4 bytes at byte offset `at` (no flooring)
  __device__ uint32_t bytes4(long long at) const {
    uint32_t v = 0;
    for (int q = 0; q < 4; ++q) v |= (uint32_t)byte(at + q) << (8 * q);
    return v;
  }

};

// A chunk's metadata, parsed by one lane.
template <class U>
struct ChunkInfo {
  long long base, final_off, rle_off[7], sizes[9];
  U firsts[7];
  int ok;
};

// The metadata of the chunk at `pos`, every blob checked against the
// compressed size (end_words) before any is read.
template <class U>
__device__ void parse_chunk(const Row& row, long long pos, long long end_words, const DecodeParams& p,
                            ChunkInfo<U>& ci) {
  const int w = p.width;
  const long long clamp = p.row_bytes + 8;
  const int dh_off = (int)round_up(4 + 4 * (p.nr + 1), w);
  const int meta_size = dh_off + (int)round_up(w * p.nd, 4);
  for (int j = 0; j < p.nr + 2; ++j) ci.sizes[j] = min((long long)row.bytes4(pos + 4 * j), clamp);
  for (int d = 0; d < p.nd; ++d) {
    U v = 0;
    for (int q = 0; q < w; ++q) v |= (U)row.byte(pos + dh_off + d * w + q) << (8 * q);
    ci.firsts[d] = v;
  }
  ci.base = pos + meta_size;
  ci.rle_off[0] = 0;
  for (int r = 0; r + 1 < p.nr; ++r) ci.rle_off[r + 1] = round_up(ci.rle_off[r] + ci.sizes[r + 1], 4);
  ci.final_off = p.nr ? round_up(ci.rle_off[p.nr - 1] + ci.sizes[p.nr], max(4, w)) : 0;
  auto in_bounds = [&](long long off, long long size) {
    return (ci.base + off) / 4 + (size + 3) / 4 <= end_words;
  };
  bool ok = (pos + meta_size) / 4 <= end_words && in_bounds(ci.final_off, ci.sizes[p.nr + 1]);
  for (int r = 0; r < p.nr; ++r) ok = ok && in_bounds(ci.rle_off[r], ci.sizes[r + 1]);
  ci.ok = ok;
}

// The blob at `off` (raw units or a bitpack blob) into dst, one element a
// lane: its first min(count, e) elements, then zeros up to `zeros_to`
// (below e).  Returns the blob's own element count, which may exceed e.  Element i is bits [i * bw, (i + 1) * bw) of the little-endian
// stream from the word after the header (8 bytes, 16 for 8-byte units;
// raw: from `off`, bw = 8 * width, frame 0) floored, as the reference
// reads it unit by unit: a funnel shift of the two words it lies in (of
// three words for 8-byte units).  Where every word read lies inside the
// row they are loaded directly, else through Row::word's clamping.
template <class U>
__device__ long long team_read_blob(const Row& row, long long off, long long size, int width, bool bp, U* dst,
                                    int e, long long zeros_to) {
  constexpr bool kWide = sizeof(U) == 8;
  const U mask = unit_mask<U>(width);
  const int tbits = 8 * width;
  long long n = size / width, da = off;
  U frame = 0;
  int bw = tbits;
  if (bp) {
    frame = row.word(off >> 2) & mask;
    if constexpr (kWide) frame |= (U)row.word((off + 4) >> 2) << 32;
    const uint32_t bw_word = row.word((off + (kWide ? 8 : 4)) >> 2);
    n = bw_word & 0xffffu;
    bw = min((int)(bw_word >> 16), tbits);  // clamp corrupt widths
    da = off + (kWide ? 16 : 8);
  }
  const long long wb = da >> 2;
  const int m = (int)min(n, (long long)e);  // elements read
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(row.p) + wb;
  const int count = (int)max((long long)m, min(zeros_to, (long long)e));
  // two loops, not one over a word count: a loop shared with the 64-bit
  // form cost the 32-bit kernel 4 registers and 6% on run-heavy decode
  // on an H100 (scripts/torch_cascaded_ab.py; PERF.md §6)
  if constexpr (kWide) {
    const U vmask = bw >= 64 ? ~U(0) : ((U(1) << bw) - U(1));
    const bool direct = row.aligned && m > 0 && 4 * (wb + (((long long)(m - 1) * bw) >> 5) + 3) <= row.bytes;
    for (int i0 = lane_id(); i0 < count; i0 += 32 * kBatch) {
      uint32_t w0[kBatch], w1[kBatch], w2[kBatch];  // kBatch elements' words in flight
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u, j = (i * bw) >> 5;
        w0[u] = w1[u] = w2[u] = 0;
        if (i < m && bw > 0) {
          w0[u] = direct ? wp[j] : row.word(wb + j);
          w1[u] = direct ? wp[j + 1] : row.word(wb + j + 1);
          w2[u] = direct ? wp[j + 2] : row.word(wb + j + 2);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u, sh = (i * bw) & 31;
        U v = ((U)w1[u] << 32 | w0[u]) >> sh;
        if (sh) v |= (U)w2[u] << (64 - sh);
        if (i < count) dst[i] = i < m ? (v & vmask) + frame : U(0);
      }
    }
  } else {
    const uint32_t vmask = bw >= 32 ? 0xffffffffu : ((1u << bw) - 1u);
    const bool direct = row.aligned && m > 0 && 4 * (wb + (((long long)(m - 1) * bw) >> 5) + 2) <= row.bytes;
    for (int i0 = lane_id(); i0 < count; i0 += 32 * kBatch) {
      uint32_t lo[kBatch], hi[kBatch];  // kBatch elements' words in flight
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u, j = (i * bw) >> 5;
        lo[u] = hi[u] = 0;
        if (i < m && bw > 0) {
          lo[u] = direct ? wp[j] : row.word(wb + j);
          hi[u] = direct ? wp[j + 1] : row.word(wb + j + 1);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + 32 * u;
        if (i < count) dst[i] = i < m ? ((__funnelshift_r(lo[u], hi[u], (i * bw) & 31) & vmask) + frame) & mask : 0u;
      }
    }
  }
  __syncwarp();
  return n;
}

// In place: a[i] = first + sum(a[j] for j < i, j < n) for i <= n, i < e.
template <class U>
__device__ void team_delta_decode(U* a, long long n, U first, int e, U mask) {
  const int live = (int)min(n + 1, (long long)e);
  const Seg sg = lane_segment(live);
  U local = 0;
  for (int i = sg.lo; i < sg.hi; ++i) local += i < n ? a[i] : U(0);
  U total;
  U run = warp_exclusive_scan(local, total);
  for (int i = sg.lo; i < sg.hi; ++i) {
    const U v = i < n ? a[i] : U(0);
    a[i] = (first + run) & mask;
    run += v;
  }
  __syncwarp();
}

// Expands the first num_runs runs (values in vals, counts in z) into
// out[0, min(total, e)): each run with a count marks its start (its scanned
// offset, if below e) with its index + 1, and a max-scan fills every
// element with the last run started at or before it.  The scans cover the
// runs and the elements that exist, not all e.  z is overwritten.  Returns
// the unclipped total of the counts.
template <class U>
__device__ long long team_rle_decode(const U* vals, uint32_t* z, long long num_runs, U* out, int e) {
  const int runs = (int)min(num_runs, (long long)e);
  Seg sg = lane_segment(runs);
  int local = 0;
  for (int i = sg.lo; i < sg.hi; ++i) local += (int)z[i];
  int total;
  int run = warp_exclusive_scan(local, total);
  const int live = min(total, e);
  for (int i = sg.lo; i < sg.hi; ++i) {
    const int c = (int)z[i];
    z[i] = (c > 0 && run < e) ? (uint32_t)run : kNoRun;
    run += c;
  }
  for (int j = lane_id(); j < live; j += 32) out[j] = 0;
  __syncwarp();
  for (int i = sg.lo; i < sg.hi; ++i)
    if (z[i] != kNoRun) out[z[i]] = (U)i + 1;
  __syncwarp();
  sg = lane_segment(live);
  uint32_t m = 0;
  for (int j = sg.lo; j < sg.hi; ++j) m = max(m, (uint32_t)out[j]);
  m = warp_exclusive_max(m);
  for (int j = sg.lo; j < sg.hi; ++j) {
    m = max(m, (uint32_t)out[j]);
    out[j] = m ? vals[m - 1] : U(0);
  }
  __syncwarp();
  return total;
}

// The inverse op schedule of one chunk by one warp; `cur` ends holding the
// chunk's elements (the two arrays swap roles at each RLE expansion).
// Returns their count (which may exceed e).
template <class U>
__device__ long long decode_chunk(const Row& row, const ChunkInfo<U>& ci, const DecodeParams& p, U*& cur, U*& alt,
                                  uint32_t* z) {
  const int e = p.elems, w = p.width;
  const U mask = unit_mask<U>(w);
  // no stage reads past its input's count (the counts read up to the runs
  // they expand), so elements past a stage's count are left as they are
  long long n = team_read_blob(row, ci.base + ci.final_off, ci.sizes[p.nr + 1], w, p.bp, cur, e, 0);
  int rle_rem = p.nr, delta_rem = p.nd;
  const int layers = max(p.nr, p.nd);
  for (int layer = 0; layer < layers; ++layer) {
    if (delta_rem > 0 && delta_rem >= rle_rem) {
      team_delta_decode(cur, n, ci.firsts[delta_rem - 1], e, mask);
      n = min(n + 1, (long long)e);
      --delta_rem;
    }
    if (rle_rem > 0 && rle_rem >= delta_rem) {
      const int r = rle_rem - 1;
      team_read_blob<uint32_t>(row, ci.base + ci.rle_off[r], ci.sizes[r + 1], 2, p.bp, z, e, n);
      n = team_rle_decode(cur, z, n, alt, e);
      U* t = cur; cur = alt; alt = t;
      --rle_rem;
    }
  }
  return n;
}

template <class U>
__global__ void __launch_bounds__(32 * kMaxTeams) cascaded_decode_kernel(DecodeParams p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ ChunkInfo<U> info[kMaxTeams];
  __shared__ long long chunk_at[kMaxTeams];  // each team's chunk position, or kNoChunk
  __shared__ long long counts[kMaxTeams];    // each team's element count, kNoChunk or kBadChunk
  __shared__ long long walk_end[kMaxTeams];
  const int team = threadIdx.x >> 5, lane = lane_id();
  const int e = p.elems, w = p.width;
  // a team's workspace: two arrays of units and the u32 counts
  U* cur = reinterpret_cast<U*>(smem + (long long)team * (2 * sizeof(U) / 4 + 1) * p.arr_words);
  U* alt = cur + p.arr_words;
  uint32_t* z = reinterpret_cast<uint32_t*>(alt + p.arr_words);

  // this team's partition, and its slot among the partition's teams
  const int q = team / p.slots, s = team % p.slots;
  const long long b = (long long)blockIdx.x * p.parts + q;
  const bool mine = q < p.parts && b < p.batch;
  const uint8_t* src = p.comp + (mine ? b : 0) * p.row_bytes;
  const Row row{src, p.row_bytes, max(2LL, (p.row_bytes + 3) / 4), ((uintptr_t)src & 3) == 0};
  uint8_t* o = p.out + (mine ? b : 0) * p.out_capacity;

  const long long comp_size = mine ? p.comp_sizes[b] : 0;
  const int nr = row.byte(0), nd = row.byte(1), ubp = row.byte(2), dt = row.byte(3);
  const long long n_bytes = (int32_t)row.bytes4(4);  // read as int32, as the JAX reference does
  const long long n_elems = floor_div(n_bytes, w);
  const long long cap_elems = p.out_capacity / w;
  const bool hdr_ok = comp_size >= kPartitionHeader && p.out_capacity >= n_bytes;
  const bool is_fallback = nr == 0 && nd == 0 && ubp == 0;
  bool ok = mine && hdr_ok && !is_fallback && nr == p.nr && nd == p.nd && ubp == p.bp && dt == p.dtype;
  const long long end_words = comp_size / 4;
  const long long end4 = end_words * 4;
  long long cum = 0, placed_end = 0;  // elements counted and placed so far
  long long pos = kPartitionHeader;   // the walk (lane 0 of team slot 0)
  int steps = 0;
  // the walk's loads depend on each other: ask for the row's lines first
  if (ok)
    for (long long at = 128LL * (s * 32 + lane); at < min(end4, p.row_bytes); at += 128LL * 32 * p.slots)
      prefetch_l2(src + at);

  for (;;) {
    // walk and parse the next group of chunks
    bool any = false;
    if (mine && s == 0) {
      long long at = kNoChunk;
      for (int j = 0; j < p.slots; ++j) {
        const bool live = ok && steps < p.k && pos < end4;
        if (lane == j) at = live ? pos : kNoChunk;
        if (live) {
          const long long total = min((long long)row.word(pos >> 2), p.row_bytes + 8);
          pos = round_up(pos + max(total, 4LL), w);
          ++steps;
        }
      }
      if (lane < p.slots) {
        chunk_at[team + lane] = at;
        if (at >= 0) parse_chunk(row, at, end_words, p, info[team + lane]);
      }
      if (lane == 0) walk_end[q] = pos;
      any = __any_sync(kFull, at >= 0);
    }
    if (!__syncthreads_or(any)) break;
    long long n = kNoChunk;
    if (mine && chunk_at[team] >= 0) {
      n = kBadChunk;
      if (info[team].ok) n = decode_chunk(row, info[team], p, cur, alt, z);
    }
    if (lane == 0) counts[team] = n;
    __syncthreads();
    if (!mine) continue;
    long long before = 0, round = 0;
    for (int j = 0; j < p.slots; ++j) {
      const long long c = counts[q * p.slots + j];
      if (c == kBadChunk) ok = false;
      if (c < 0) continue;
      cum += c;
      before += j < s ? min(c, (long long)e) : 0;
      round += min(c, (long long)e);
    }
    ok = ok && cum <= n_elems;
    if (ok && n >= 0) {  // the chunk's first min(n, e) elements, in the row's capacity
      const long long at0 = placed_end + before;
      const long long placed = min(min(n, (long long)e), cap_elems - at0);
      for (long long j = lane; j < placed; j += 32) {
        const U v = cur[j];
        if constexpr (sizeof(U) == 8) reinterpret_cast<unsigned long long*>(o)[at0 + j] = v;
        else if (w == 4) reinterpret_cast<uint32_t*>(o)[at0 + j] = v;
        else if (w == 2) reinterpret_cast<uint16_t*>(o)[at0 + j] = (uint16_t)v;
        else o[at0 + j] = (uint8_t)v;
      }
    }
    placed_end += round;
  }

  // the partition's teams write the rest of its row and its status
  if (!mine) return;
  const int tid = s * 32 + lane, nth = p.slots * 32;
  long long end = 0;  // bytes of data at the row's start
  if (is_fallback) {
    ok = hdr_ok && comp_size >= kPartitionHeader + n_elems * w;
    if (ok) {
      end = max(0LL, min(n_elems * w, p.row_bytes - kPartitionHeader));
      copy_bytes(o, src + kPartitionHeader, end, tid, nth);
    }
  } else {
    ok = ok && cum == n_elems && walk_end[q] >= end4;  // every element, every chunk consumed
    if (ok) end = min(placed_end, cap_elems) * w;
  }
  zero_bytes(o + end, p.out_capacity - end, tid, nth);
  if (tid == 0) {
    p.out_bytes[b] = ok ? (int32_t)(n_elems * w) : 0;
    p.status[b] = ok ? kStatusSuccess : kStatusCannotDecompress;
  }
}

template <class U>
int launch_decode(const DecodeParams& p, const TeamPlan& plan, cudaStream_t st) {
  const size_t smem = (size_t)(plan.teams * plan.ws_bytes);
  const cudaError_t err = cudaFuncSetAttribute(cascaded_decode_kernel<U>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((p.batch + plan.parts - 1) / plan.parts);
  cascaded_decode_kernel<U><<<grid, 32 * plan.teams, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tpucomp

// C interface, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tc_cascaded_decode(const void* comp, const void* comp_sizes, void* out,
                                  void* out_bytes, void* status, long long batch,
                                  long long row_bytes, long long out_capacity, int width, int dtype,
                                  int elems, int k, int nr, int nd, int bp, void* stream) {
  using namespace tpucomp;
  // a team's workspace: two arrays of E units (4 bytes, 8 for w = 8) and
  // the u32 counts
  const bool wide = width == 8;
  const long long arr_words = round_up(elems, 4);
  const TeamPlan plan = plan_teams((wide ? 20 : 12) * arr_words, k);
  const DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                       static_cast<uint8_t*>(out), static_cast<int32_t*>(out_bytes),
                       static_cast<int32_t*>(status), batch, row_bytes, out_capacity, width, dtype, elems, k,
                       nr, nd, bp, plan.slots, plan.parts, (int)arr_words};
  return wide ? launch_decode<unsigned long long>(p, plan, static_cast<cudaStream_t>(stream))
              : launch_decode<uint32_t>(p, plan, static_cast<cudaStream_t>(stream));
}
