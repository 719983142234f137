// Variant of tpucomp_torch/csrc/cascaded_decode.cu for the A/B of
// scripts/torch_cascaded_ab.py: each chunked partition's compressed row is
// first copied into shared memory (where the teams' workspaces and the
// rows fit the CTA's 227 KB), and the chain walk, the parse and every blob
// read go to that copy instead of global memory.  It equals the shipped
// kernel's output; the A/B kept the global walk (PERF.md, §6).

#include "cascaded_common.cuh"

namespace tpucomp {
namespace {

constexpr int kStatusSuccess = 0;
constexpr int kStatusCannotDecompress = 12;
constexpr long long kNoChunk = -2, kBadChunk = -1;  // chunk counts that are not counts
constexpr uint32_t kNoRun = 0xffffffffu;
#ifndef TC_CASCADED_STAGE_ROW
#define TC_CASCADED_STAGE_ROW 1
#endif

struct DecodeParams {
  const uint8_t* comp;
  const int32_t* comp_sizes;
  uint8_t* out;
  int32_t* out_bytes;
  int32_t* status;
  long long batch, row_bytes, out_capacity;  // row_bytes: CMAX
  int width, dtype, elems, k, nr, nd, bp;
  int slots, parts, arr_words;  // TeamPlan; words of each of a team's three arrays
  long long stage_row_bytes;    // shared bytes a staged compressed row takes
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
struct ChunkInfo {
  long long base, final_off, rle_off[7], sizes[9];
  uint32_t firsts[7];
  int ok;
};

// The metadata of the chunk at `pos`, every blob checked against the
// compressed size (end_words) before any is read.
__device__ void parse_chunk(const Row& row, long long pos, long long end_words, const DecodeParams& p,
                            ChunkInfo& ci) {
  const int w = p.width;
  const long long clamp = p.row_bytes + 8;
  const int dh_off = (int)round_up(4 + 4 * (p.nr + 1), w);
  const int meta_size = dh_off + (int)round_up(w * p.nd, 4);
  for (int j = 0; j < p.nr + 2; ++j) ci.sizes[j] = min((long long)row.bytes4(pos + 4 * j), clamp);
  for (int d = 0; d < p.nd; ++d) {
    uint32_t v = 0;
    for (int q = 0; q < w; ++q) v |= (uint32_t)row.byte(pos + dh_off + d * w + q) << (8 * q);
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
// stream from the word at `off + 8` (bitpack; raw: `off`, bw = 8 * width,
// frame 0) floored, as the reference reads it unit by unit: a funnel shift
// of the two words it lies in.  Where every word read lies inside the row
// they are loaded directly, else through Row::word's clamping.
__device__ long long team_read_blob(const Row& row, long long off, long long size, int width, bool bp,
                                    uint32_t* dst, int e, long long zeros_to) {
  const uint32_t mask = unit_mask(width);
  const int tbits = 8 * width;
  long long n = size / width, da = off;
  uint32_t frame = 0;
  int bw = tbits;
  if (bp) {
    frame = row.word(off >> 2) & mask;
    const uint32_t bw_word = row.word((off + 4) >> 2);
    n = bw_word & 0xffffu;
    bw = min((int)(bw_word >> 16), tbits);  // clamp corrupt widths
    da = off + 8;
  }
  const uint32_t vmask = bw >= 32 ? 0xffffffffu : ((1u << bw) - 1u);
  const long long wb = da >> 2;
  const int m = (int)min(n, (long long)e);  // elements read
  const bool direct = row.aligned && m > 0 && 4 * (wb + (((long long)(m - 1) * bw) >> 5) + 2) <= row.bytes;
  const uint32_t* wp = reinterpret_cast<const uint32_t*>(row.p) + wb;
  const int count = (int)max((long long)m, min(zeros_to, (long long)e));
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
  __syncwarp();
  return n;
}

// In place: a[i] = first + sum(a[j] for j < i, j < n) for i <= n, i < e.
__device__ void team_delta_decode(uint32_t* a, long long n, uint32_t first, int e, uint32_t mask) {
  const int live = (int)min(n + 1, (long long)e);
  const Seg sg = lane_segment(live);
  uint32_t local = 0;
  for (int i = sg.lo; i < sg.hi; ++i) local += i < n ? a[i] : 0u;
  uint32_t total;
  uint32_t run = warp_exclusive_scan(local, total);
  for (int i = sg.lo; i < sg.hi; ++i) {
    const uint32_t v = i < n ? a[i] : 0u;
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
__device__ long long team_rle_decode(const uint32_t* vals, uint32_t* z, long long num_runs, uint32_t* out,
                                     int e) {
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
    if (z[i] != kNoRun) out[z[i]] = (uint32_t)i + 1;
  __syncwarp();
  sg = lane_segment(live);
  uint32_t m = 0;
  for (int j = sg.lo; j < sg.hi; ++j) m = max(m, out[j]);
  m = warp_exclusive_max(m);
  for (int j = sg.lo; j < sg.hi; ++j) {
    m = max(m, out[j]);
    out[j] = m ? vals[m - 1] : 0u;
  }
  __syncwarp();
  return total;
}

// The inverse op schedule of one chunk by one warp; `cur` ends holding the
// chunk's elements (the two arrays swap roles at each RLE expansion).
// Returns their count (which may exceed e).
__device__ long long decode_chunk(const Row& row, const ChunkInfo& ci, const DecodeParams& p, uint32_t*& cur,
                                  uint32_t*& alt, uint32_t* z) {
  const int e = p.elems, w = p.width;
  const uint32_t mask = unit_mask(w);
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
      team_read_blob(row, ci.base + ci.rle_off[r], ci.sizes[r + 1], 2, p.bp, z, e, n);
      n = team_rle_decode(cur, z, n, alt, e);
      uint32_t* t = cur; cur = alt; alt = t;
      --rle_rem;
    }
  }
  return n;
}

template <bool kStage>
__global__ void __launch_bounds__(32 * kMaxTeams) cascaded_decode_kernel(DecodeParams p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ ChunkInfo info[kMaxTeams];
  __shared__ long long chunk_at[kMaxTeams];  // each team's chunk position, or kNoChunk
  __shared__ long long counts[kMaxTeams];    // each team's element count, kNoChunk or kBadChunk
  __shared__ long long walk_end[kMaxTeams];
  const int team = threadIdx.x >> 5, lane = lane_id();
  const int e = p.elems, w = p.width;
  uint32_t* cur = smem + (long long)team * 3 * p.arr_words;
  uint32_t* alt = cur + p.arr_words;
  uint32_t* z = alt + p.arr_words;

  // this team's partition, and its slot among the partition's teams
  const int q = team / p.slots, s = team % p.slots;
  const long long b = (long long)blockIdx.x * p.parts + q;
  const bool mine = q < p.parts && b < p.batch;
  const uint8_t* src = p.comp + (mine ? b : 0) * p.row_bytes;
  Row row{src, p.row_bytes, max(2LL, (p.row_bytes + 3) / 4), ((uintptr_t)src & 3) == 0};
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
  if (kStage) {  // a chunked partition's row into shared memory, for the walk and every blob read
    uint8_t* staged = reinterpret_cast<uint8_t*>(smem + (long long)(blockDim.x >> 5) * 3 * p.arr_words) +
                      (long long)q * p.stage_row_bytes;
    if (ok) copy_bytes(staged, src, p.row_bytes, s * 32 + lane, p.slots * 32);
    __syncthreads();
    if (ok) {
      row.p = staged;
      row.aligned = true;
    }
  }

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
        const uint32_t v = cur[j];
        if (w == 4) reinterpret_cast<uint32_t*>(o)[at0 + j] = v;
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

}  // namespace
}  // namespace tpucomp

// C interface, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tc_cascaded_decode(const void* comp, const void* comp_sizes, void* out,
                                  void* out_bytes, void* status, long long batch,
                                  long long row_bytes, long long out_capacity, int width, int dtype,
                                  int elems, int k, int nr, int nd, int bp, void* stream) {
  using namespace tpucomp;
  const long long arr_words = round_up(elems, 4);
  const TeamPlan plan = plan_teams(3 * 4 * arr_words, k);
  // TC_CASCADED_STAGE_ROW=1 builds the variant that first copies each
  // chunked partition's compressed row into shared memory, where it fits
  const long long stage_row = round_up(row_bytes, 16);
  const bool stage = TC_CASCADED_STAGE_ROW && plan.teams * plan.ws_bytes + plan.parts * stage_row <= kSmemMax;
  DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                 static_cast<uint8_t*>(out), static_cast<int32_t*>(out_bytes),
                 static_cast<int32_t*>(status), batch, row_bytes, out_capacity, width, dtype, elems, k,
                 nr, nd, bp, plan.slots, plan.parts, (int)arr_words, stage_row};
  const size_t smem = (size_t)(plan.teams * plan.ws_bytes + (stage ? plan.parts * stage_row : 0));
  const unsigned grid = (unsigned)((batch + plan.parts - 1) / plan.parts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (stage) {
    err = cudaFuncSetAttribute(cascaded_decode_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cascaded_decode_kernel<true><<<grid, 32 * plan.teams, smem, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(cascaded_decode_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    cascaded_decode_kernel<false><<<grid, 32 * plan.teams, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}
