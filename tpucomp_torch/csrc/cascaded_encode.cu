// Cascaded encode kernel (RLE / Delta / FOR + bitpack) for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/cascaded_pallas.py:294
// _encode_kernel (bodies _pipeline_body and _assembly_body).  Its plain
// PyTorch version is tpucomp_torch/codecs/cascaded.py::_compress_plain; the
// bytes are equal.
//
// What bounds it on the H100: device-memory bytes would (one read of the
// input, one write of the output row), but a chunk's pipeline is a chain
// of dependent passes (loads, RLE, Delta, RLE, three bit-packings), so
// latency bounds it unless many chunks are in flight.  A design that gives a partition's chunks to one CTA in turn
// (the first port's) pays a dozen CTA barriers per chunk with 4 elements
// a thread.
//
// Design: chunks in parallel, sizes before bytes, every byte written.
// - One warp (a team) encodes one scheme chunk with warp primitives only,
//   in rounds of 32 consecutive elements, one a lane (coalesced,
//   conflict-free shared memory, and rounds independent of each other but
//   for a running count): RLE in one pass (run ends by comparing with the
//   next element, run ranks by ballot and popc), Delta, and bit-packing
//   without atomics (a round of 32 elements fills exactly bw words, built
//   by __reduce_or_sync or gathered by shuffles; see team_pack).  The
//   frame and bit width of each blob come from the range of its units,
//   which the pass that writes them gathers (warp_min / warp_max), so no
//   pass reads a blob's units twice.  A batch of rounds issues all its
//   shared-memory loads before its stores (kRounds).
// - Every offset inside a chunk is relative to the chunk's metadata, and
//   every one is a multiple of 4, so a team stages
//   its whole chunk (metadata and RLE-count blobs in its staging area,
//   the final blob in its dead working array) without knowing where the
//   chunk lands.  The teams of a partition then read each other's chunk
//   totals: the running offset gives each its place, and the partition's
//   size gives the raw-copy fallback as one decision, the same rule as the
//   format's per-blob check, since blob ends only grow: no layer is
//   enabled, or the last blob ends past 8 + roundUp4(input_bytes).  (For
//   8-byte elements a chunk's total is its blob end rounded up to 8; every
//   chunk starts at a multiple of 8 and so does the limit, so the padded
//   end passes the limit exactly when the blob end does.)  Teams
//   copy their staged chunks to the row with the widest stores the
//   alignment allows.  A partition with more chunks than teams loops over
//   groups of chunks, carrying the running offset; once it passes the
//   limit, the fallback is certain, the partition stops, and nothing more
//   of it is staged or copied.  A fallback partition copies the row raw.
// - The kernel writes every byte of every row up to PMAX (chunks, then
//   zeros; or the raw copy, then zeros) and every size, so the wrapper
//   allocates its outputs with torch.empty.
// - Teams per CTA are sized by the workspace (plan_teams): the 64 KB main
//   path gives four teams to each partition's 16 chunks; CascadedManager's
//   4 KB partitions (one chunk each) put four partitions in one CTA.
// - Where a team's arrays and staging area do not fit shared memory
//   (1-byte elements in 16 KB chunks with many RLE layers), one team per
//   CTA encodes the partition's chunks in order and writes them straight
//   into the row, whose offsets it then knows ("direct" mode).
//
// Elements are held in 32-bit units for widths 1, 2 and 4 and in 64-bit
// units for 8 (LONGLONG / ULONGLONG): each kernel is instantiated for
// both, and the 64-bit one follows tpucomp's XLA path for w = 8 (16-byte
// bitpack header, a signed 64-bit range whose difference wraps in 64 bits,
// bit widths up to 64, blobs and chunk totals aligned to 8).
//
// Supported: element widths 1, 2, 4 and 8; every validated option set.

#include "cascaded_common.cuh"

namespace tpucomp {
namespace {

struct EncodeParams {
  const uint8_t* data;
  const int32_t* lengths;
  uint8_t* out;
  int32_t* sizes;
  long long batch, row_bytes, pmax;  // row_bytes: C
  int width, dtype, elems, k, nr, nd, bp;
  int slots, parts;                       // TeamPlan
  int arr_words, ends_words, stage_words;  // a team's workspace; stage_words 0: direct
};

// Unsigned element at element index gi of an input row; bytes past the
// row's end read 0.
template <class U>
__device__ __forceinline__ U load_elem(const uint8_t* in, long long row_bytes, long long gi, int width,
                                       bool aligned) {
  const long long byte = gi * width;
  if (aligned && byte + width <= row_bytes) {
    if constexpr (sizeof(U) == 8) return *reinterpret_cast<const unsigned long long*>(in + byte);
    if (width == 4) return *reinterpret_cast<const uint32_t*>(in + byte);
    if (width == 2) return *reinterpret_cast<const uint16_t*>(in + byte);
    return in[byte];
  }
  U v = 0;
  for (int j = 0; j < width; ++j)
    if (byte + j < row_bytes) v |= (U)in[byte + j] << (8 * j);
  return v;
}

// The signed minimum and maximum of a set of units (a blob's frame of
// reference and bit width), gathered by the pass that writes the units.
template <class S>
struct Range {
  S mn = (S)((1ull << (8 * sizeof(S) - 1)) - 1), mx = -mn - 1;  // the largest and the least S
  __device__ void add(S v) {
    mn = min(mn, v);
    mx = max(mx, v);
  }
  __device__ Range reduced() const { return {warp_min(mn), warp_max(mx)}; }
};

// Runs of cur[0, n): each run's value to vals[r], its end (index + 1) to
// ends[r].  One pass of rounds of 32 elements, one a lane: a run ends where
// an element differs from the next; its rank is the ends before it (a
// ballot and a popc), and its length is its end minus the end before it
// (the next lower end lane of the round, or the round's carry).  Also
// gives the range of the lengths and, where `last` (no stage follows, so
// the values are the final blob's), of the run values (units of `width`).
// Returns the run count.
template <class U>
__device__ int team_rle(const U* cur, int n, int width, bool last, U* vals, uint16_t* ends,
                        Range<SignedOf<U>>& vr, Range<int>& cr) {
  const int lane = lane_id();
  const unsigned below = (1u << lane) - 1u;
  int base = 0, carry = 0;  // runs so far, and the end of the last
  Range<SignedOf<U>> v_range;
  Range<int> c_range;
  for (int r0 = 0; r0 < n; r0 += 32 * kRounds) {
    U v[kRounds], next[kRounds];  // every load of the batch before any store
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int i = r0 + 32 * u + lane;
      v[u] = i < n ? cur[i] : U(0);
      next[u] = i + 1 < n ? cur[i + 1] : U(0);
    }
#pragma unroll
    for (int u = 0; u < kRounds; ++u) {
      const int i = r0 + 32 * u + lane;
      const bool end = i < n && (i == n - 1 || v[u] != next[u]);
      const unsigned m = __ballot_sync(kFull, end);
      if (end) {
        const unsigned lower = m & below;
        const int r = base + __popc(lower);
        vals[r] = v[u];
        ends[r] = (uint16_t)(i + 1);
        if (last) v_range.add(sext(v[u], width));
        c_range.add(i + 1 - (lower ? r0 + 32 * u + 32 - __clz(lower) : carry));
      }
      base += __popc(m);
      if (m) carry = r0 + 32 * u + 32 - __clz(m);
    }
  }
  vr = v_range.reduced();
  cr = c_range.reduced();
  __syncwarp();
  return base;
}

// The blob of value(0..n), whose units of `width` span `range`: a bitpack
// blob (its header at hdr: u32 frame, u32 (bw << 16) | n; for 8-byte
// units a u64 frame, the same word, then a zero word; then the
// little-endian bit stream at data) or the raw units, zero-padded to a
// word (a bit stream of 8 * width bits an element and frame 0) at data.
// Only words below hdr_room and data_room are written.  Returns the
// blob's size in bytes.
//
// Rounds of 32 elements, one a lane: round r's 32 * bw bits are exactly
// the words [r * bw, (r + 1) * bw), and lane j < bw writes word j of the
// round.  Narrow elements (bw < 8): each lane's bits fall into at most two
// of the round's words, and word j is the OR over lanes of their share of
// it (__reduce_or_sync).  Wide elements: word j spans at most five
// elements, which lane j gathers by shuffles.  Wider than 32 bits (8-byte
// units only): word j spans at most two elements, gathered by shuffles,
// and lane j writes words j and j + 32.  Every unit whose bits fit 32 goes
// through the 32-bit paths.  No atomics, no zero-fill: every word below
// the blob's end is written once.
template <class U, class Value>
__device__ uint32_t team_pack(Value value, int n, int width, bool bp, Range<SignedOf<U>> range, uint32_t* hdr,
                              long long hdr_room, uint32_t* data, long long room) {
  constexpr bool kWide = sizeof(U) == 8;
  const int lane = lane_id();
  const U mask = unit_mask<U>(width);
  U frame = 0;
  int bw = 8 * width;
  if (bp) {
    frame = n ? ((U)range.mn & mask) : U(0);
    bw = n ? bit_width((U)range.mx - (U)range.mn) : 0;
    if (lane == 0) {
      if constexpr (kWide) {
        if (hdr_room > 0) hdr[0] = (uint32_t)frame;
        if (hdr_room > 1) hdr[1] = (uint32_t)(frame >> 32);
        if (hdr_room > 2) hdr[2] = ((uint32_t)bw << 16) | (uint32_t)n;
        if (hdr_room > 3) hdr[3] = 0;
      } else {
        if (hdr_room > 0) hdr[0] = frame;
        if (hdr_room > 1) hdr[1] = ((uint32_t)bw << 16) | (uint32_t)n;
      }
    }
  }
  const int nwords = (int)(((long long)n * bw + 31) >> 5);
  const int lim = (int)min((long long)nwords, max(room, 0LL));
  if (bw > 0 && bw < 8) {
    const int bit = lane * bw, wa = bit >> 5, sa = bit & 31;  // this lane's bits: word wa of the round, at sa
    for (int r0 = 0; r0 < n; r0 += 32) {
      const int i = r0 + lane;
      const uint32_t u = i < n ? (uint32_t)((value(i) - frame) & mask) : 0u;
      const uint32_t lo = u << sa, hi = sa + bw > 32 ? u >> (32 - sa) : 0u;
      uint32_t mine = 0;
      for (int j = 0; j < bw; ++j) {
        const uint32_t word = __reduce_or_sync(kFull, wa == j ? lo : (wa + 1 == j ? hi : 0u));
        if (lane == j) mine = word;
      }
      const int wi = (r0 >> 5) * bw + lane;
      if (lane < bw && wi < lim) data[wi] = mine;
    }
  } else if (bw >= 8 && (!kWide || bw <= 32)) {
    // word `lane` of a round holds the elements first..last of the round
    const int first = lane < bw ? (32 * lane) / bw : 31;
    const int last = lane < bw ? min(31, (32 * lane + 31) / bw) : 30;
    const int spans = __reduce_max_sync(kFull, last - first + 1);
    for (int r0 = 0; r0 < n; r0 += 32 * kRounds) {
      uint32_t us[kRounds];  // every load of the batch before any store
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int i = r0 + 32 * u + lane;
        us[u] = i < n ? (uint32_t)((value(i) - frame) & mask) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        uint32_t word = 0;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          if (k >= spans) break;
          const int src = min(first + k, 31);
          const uint32_t x = __shfl_sync(kFull, us[u], src);
          const int sh = src * bw - 32 * lane;  // in (-bw, 32) for the elements of this word
          if (first + k <= last) word |= sh >= 0 ? x << sh : x >> -sh;
        }
        const int wi = ((r0 >> 5) + u) * bw + lane;
        if (lane < bw && wi < lim) data[wi] = word;
      }
    }
  }
  if constexpr (kWide) {
    if (bw > 32) {
      for (int r0 = 0; r0 < n; r0 += 32) {
        const int i = r0 + lane;
        const U u = i < n ? (value(i) - frame) & mask : U(0);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // word j of the round: bits [32j, 32j + 32) of the stream, from
          // element `first` and, where its bits reach the word, the next
          const int j = lane + 32 * h, first = min(32 * j / bw, 31);
          const U x0 = __shfl_sync(kFull, u, first);
          const U x1 = __shfl_sync(kFull, u, min(first + 1, 31));
          const int sh0 = 32 * j - first * bw, sh1 = (first + 1) * bw - 32 * j;  // sh0 in [0, bw)
          uint32_t word = (uint32_t)(x0 >> sh0);
          if (sh1 < 32) word |= (uint32_t)(x1 << sh1);
          const int wi = (r0 >> 5) * bw + j;
          if (j < bw && wi < lim) data[wi] = word;
        }
      }
    }
  }
  __syncwarp();
  return bp ? (kWide ? 16u : 8u) + 4u * (uint32_t)nwords : (uint32_t)(n * width);
}

struct Staged {
  int total;             // the chunk's bytes
  int head_words;        // metadata, RLE-count blobs, final blob's header: in the staging area
  const uint32_t* tail;  // the final blob's data (staged mode)
};

// One chunk (elements [e0, e0 + cn) of the row) through the op schedule by
// one warp.  The metadata, the RLE-count blobs and the final blob's header
// go to `stage` (its first `room` words are writable); the final blob's
// data to the dead working array (staged) or after them (direct, where
// `stage` is the chunk's place in the output row).
template <class U, bool kDirect>
__device__ Staged encode_chunk(const EncodeParams& p, const uint8_t* in, long long e0, int cn, U* A, U* B,
                               uint16_t* ends, uint32_t* stage, long long room) {
  constexpr bool kWide = sizeof(U) == 8;
  const int w = p.width, lane = lane_id();
  const U mask = unit_mask<U>(w);
  const uint8_t* src = in + e0 * w;
  Range<SignedOf<U>> range;  // of the units in cur, where they are the final blob's
  const int layers = max(p.nr, p.nd);
  if (((uintptr_t)src & 15) == 0 && (e0 + cn) * w <= p.row_bytes) {
    // 16 bytes a lane, kBatch loads in flight, then 16 / w elements each
    const int nv = cn * w / 16, per = 16 / w;
    const uint4* v = reinterpret_cast<const uint4*>(src);
    for (int b0 = 0; b0 < nv; b0 += 32 * kBatch) {
      uint4 r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = b0 + u * 32 + lane;
        if (j < nv) r[u] = v[j];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = b0 + u * 32 + lane;
        if (j >= nv) continue;
        const uint32_t words[4] = {r[u].x, r[u].y, r[u].z, r[u].w};
        for (int q = 0; q < per; ++q) {
          U x;
          if constexpr (kWide) x = (U)words[2 * q] | ((U)words[2 * q + 1] << 32);
          else x = (words[q * w >> 2] >> (8 * ((q * w) & 3))) & mask;
          A[j * per + q] = x;
          if (!layers) range.add(sext(x, w));
        }
      }
    }
    for (int i = nv * per + lane; i < cn; i += 32) {
      A[i] = load_elem<U>(in, p.row_bytes, e0 + i, w, true);
      if (!layers) range.add(sext(A[i], w));
    }
  } else {
    const bool aligned = ((uintptr_t)in % w) == 0;
    for (int i = lane; i < cn; i += 32) {
      A[i] = load_elem<U>(in, p.row_bytes, e0 + i, w, aligned);
      if (!layers) range.add(sext(A[i], w));
    }
  }
  range = range.reduced();
  const int dh_off = (int)round_up(4 + 4 * (p.nr + 1), kWide ? 8 : 4);
  const int meta_words = (dh_off + (int)round_up(w * p.nd, 4)) >> 2;
  for (int j = p.nr + 2 + lane; j < meta_words; j += 32)
    if (j < room) stage[j] = 0;  // delta headers are ORed in below
  __syncwarp();

  U* cur = A;
  U* alt = B;
  int n = cn, pos = meta_words;
  const int hw = p.bp ? 2 : 0;  // an RLE-count blob's header words
  for (int layer = 0; layer < layers; ++layer) {
    if (layer < p.nr) {
      Range<int> counts;
      const bool last = layer + 1 >= layers && layer >= p.nd;  // no Delta after it
      const int runs = team_rle(cur, n, w, last, alt, ends, range, counts);
      const uint32_t size = team_pack<uint32_t>(
          [&](int i) { return (uint32_t)ends[i] - (i ? (uint32_t)ends[i - 1] : 0u); }, runs, 2, p.bp, counts,
          stage + pos, room - pos, stage + pos + hw, room - pos - hw);
      if (lane == 0 && 1 + layer < room) stage[1 + layer] = size;
      pos += (int)(round_up(size, 4) >> 2);
      U* t = cur; cur = alt; alt = t;
      n = runs;
    }
    if (layer < p.nd) {
      const int byte = dh_off + layer * w;  // this layer's first value, w bytes
      if (lane == 0 && n > 0) {
        if constexpr (kWide) {
          if ((byte >> 2) < room) stage[byte >> 2] = (uint32_t)cur[0];
          if ((byte >> 2) + 1 < room) stage[(byte >> 2) + 1] = (uint32_t)(cur[0] >> 32);
        } else if ((byte >> 2) < room) {
          stage[byte >> 2] |= (cur[0] & mask) << (8 * (byte & 3));
        }
      }
      Range<SignedOf<U>> deltas;
      for (int i0 = lane; i0 < n - 1; i0 += 32 * kRounds) {
        U d[kRounds];  // every load of the batch before any store
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
          const int i = i0 + 32 * u;
          d[u] = i < n - 1 ? (cur[i + 1] - cur[i]) & mask : U(0);
        }
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
          const int i = i0 + 32 * u;
          if (i < n - 1) {
            alt[i] = d[u];
            if (layer + 1 >= layers) deltas.add(sext(d[u], w));
          }
        }
      }
      range = deltas.reduced();
      __syncwarp();
      U* t = cur; cur = alt; alt = t;
      n = max(n - 1, 0);
    }
  }
  // the final blob follows the counts blobs, aligned to w (to 8 for w = 8:
  // a zero word where the counts end on an odd word)
  const int fhw = p.bp ? (kWide ? 4 : 2) : 0;  // its header words
  if (kWide && (pos & 1)) {
    if (lane == 0 && pos < room) stage[pos] = 0;
    ++pos;
  }
  uint32_t* fdata = kDirect ? stage + pos + fhw : reinterpret_cast<uint32_t*>(alt);
  const uint32_t size = team_pack<U>([&](int i) { return cur[i]; }, n, w, p.bp, range, stage + pos, room - pos,
                                     fdata, kDirect ? room - pos - fhw : (long long)p.arr_words);
  const int end = 4 * pos + (int)round_up(size, 4);
  const int total = kWide ? (int)round_up(end, 8) : end;
  if (lane == 0) {
    if (room > 0) stage[0] = (uint32_t)total;
    if (1 + p.nr < room) stage[1 + p.nr] = size;
    // the trailing pad to 8: a zero word after the blob's data (an odd
    // word count, so below 2 * E words in the dead array)
    const int data_words = (end >> 2) - pos - fhw;
    if (total > end && (!kDirect || pos + fhw + data_words < room)) fdata[data_words] = 0;
  }
  __syncwarp();
  return {total, pos + fhw, fdata};
}

template <class U, bool kDirect>
__global__ void __launch_bounds__(32 * kMaxTeams) cascaded_encode_kernel(EncodeParams p) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ int totals[kMaxTeams];
  const int team = threadIdx.x >> 5, lane = lane_id();
  const int e = p.elems, w = p.width;
  uint32_t* ws = smem + (long long)team * (2 * p.arr_words + p.ends_words + p.stage_words);
  U* A = reinterpret_cast<U*>(ws);
  U* B = reinterpret_cast<U*>(ws + p.arr_words);
  uint16_t* ends = reinterpret_cast<uint16_t*>(ws + 2 * p.arr_words);
  uint32_t* stage = ws + 2 * p.arr_words + p.ends_words;

  // this team's partition, and its slot among the partition's teams
  const int q = team / p.slots, s = team % p.slots;
  const long long b = (long long)blockIdx.x * p.parts + q;
  const bool mine = q < p.parts && b < p.batch;
  const uint8_t* in = p.data + (mine ? b : 0) * p.row_bytes;
  uint8_t* o = p.out + (mine ? b : 0) * p.pmax;
  const long long length = mine ? p.lengths[b] : 0;
  const long long n_elems = length > 0 ? length / w : 0;
  const long long input_bytes = n_elems * w;
  const long long limit = kPartitionHeader + round_up(input_bytes, 4);
  const long long nchunks = min((long long)p.k, (n_elems + e - 1) / e);
  bool fallback = p.nr == 0 && p.nd == 0 && !p.bp;
  long long carry = kPartitionHeader;  // the running offset: 8 + the totals so far

  for (long long r = 0;; ++r) {
    const long long c = r * p.slots + s;
    const bool active = mine && !fallback && c < nchunks;
    if (!__syncthreads_or(active)) break;
    Staged st{0, 0, nullptr};
    if (active) {
      const int cn = (int)min((long long)e, n_elems - c * e);
      if (kDirect)  // one team per partition: the chunk's place is known
        st = encode_chunk<U, true>(p, in, c * e, cn, A, B, ends, reinterpret_cast<uint32_t*>(o + carry),
                                   (p.pmax - carry) >> 2);
      else
        st = encode_chunk<U, false>(p, in, c * e, cn, A, B, ends, stage, p.stage_words);
    }
    if (lane == 0) totals[team] = st.total;
    __syncthreads();
    if (!mine) continue;
    long long before = 0, round = 0;
    for (int j = 0; j < p.slots; ++j) {
      const int t = totals[q * p.slots + j];
      before += j < s ? t : 0;
      round += t;
    }
    const long long off = carry + before;
    carry += round;
    fallback = fallback || carry > limit;
    if (!kDirect && active && !fallback) {
      const long long room = p.pmax - off, head = 4LL * st.head_words;
      copy_bytes(o + off, reinterpret_cast<const uint8_t*>(stage), min(head, room), lane, 32);
      copy_bytes(o + off + head, reinterpret_cast<const uint8_t*>(st.tail), min(st.total - head, room - head),
                 lane, 32);
    }
  }

  // the partition's teams write the rest of its row: header, raw copy or
  // nothing, then zeros up to PMAX
  if (!mine) return;
  const int tid = s * 32 + lane, nth = p.slots * 32;
  if (length <= 0) {  // an empty partition: a zero row of size 0
    zero_bytes(o, p.pmax, tid, nth);
    if (tid == 0) p.sizes[b] = 0;
    return;
  }
  long long end = min(carry, p.pmax);
  if (fallback) {  // raw elements at byte 8
    const long long ncopy = min(input_bytes, p.row_bytes);
    copy_bytes(o + kPartitionHeader, in, ncopy, tid, nth);
    end = kPartitionHeader + ncopy;
    carry = kPartitionHeader + round_up(input_bytes, 4);
  }
  zero_bytes(o + end, p.pmax - end, tid, nth);
  if (tid == 0) {
    const uint32_t layers = fallback ? 0u : (uint32_t)p.nr | ((uint32_t)p.nd << 8) | ((uint32_t)p.bp << 16);
    reinterpret_cast<uint32_t*>(o)[0] = layers | ((uint32_t)p.dtype << 24);
    reinterpret_cast<uint32_t*>(o)[1] = (uint32_t)input_bytes;
    p.sizes[b] = (int32_t)carry;
  }
}

}  // namespace
}  // namespace tpucomp

// C interface, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
namespace tpucomp {
namespace {

template <class U, bool kDirect>
int launch_encode(const EncodeParams& p, const TeamPlan& plan, cudaStream_t st) {
  const size_t smem = (size_t)(plan.teams * plan.ws_bytes);
  const unsigned grid = (unsigned)((p.batch + plan.parts - 1) / plan.parts);
  const cudaError_t err = cudaFuncSetAttribute(cascaded_encode_kernel<U, kDirect>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cascaded_encode_kernel<U, kDirect><<<grid, 32 * plan.teams, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace tpucomp

extern "C" int tc_cascaded_encode(const void* data, const void* lengths, void* out, void* sizes,
                                  long long batch, long long row_bytes, long long pmax, int width,
                                  int dtype, int elems, int k, int nr, int nd, int bp, void* stream) {
  using namespace tpucomp;
  // a team's workspace: two element arrays (4-byte units, 8-byte for
  // w = 8), the u16 run ends, the staging area (metadata, nr count blobs
  // at their largest, the final blob's alignment word and header); 14,384
  // bytes at the default options, so eight teams fit twice on an SM
  const bool wide = width == 8;
  const long long arr_words = round_up(elems, 4) * (wide ? 2 : 1);
  const long long ends_words = round_up(elems, 8) / 2;
  const long long meta = round_up(4 + 4 * (nr + 1), wide ? 8 : 4) + round_up((long long)width * nd, 4);
  const long long counts_max = (bp ? 8 : 0) + round_up(2LL * elems, 4);
  const long long final_head = wide ? 4 + (bp ? 16 : 0) : (bp ? 8 : 0);
  long long stage_words = round_up(meta + nr * counts_max + final_head, 16) / 4;
  const long long arrays = 4 * (2 * arr_words + ends_words);
  const bool direct = arrays + 4 * stage_words > kSmemMax;
  if (direct) stage_words = 0;
  const TeamPlan plan = direct ? TeamPlan{1, 1, 1, arrays} : plan_teams(arrays + 4 * stage_words, k);
  const EncodeParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                       static_cast<uint8_t*>(out), static_cast<int32_t*>(sizes), batch, row_bytes, pmax,
                       width, dtype, elems, k, nr, nd, bp, plan.slots, plan.parts, (int)arr_words,
                       (int)ends_words, (int)stage_words};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) return direct ? launch_encode<unsigned long long, true>(p, plan, st)
                          : launch_encode<unsigned long long, false>(p, plan, st);
  return direct ? launch_encode<uint32_t, true>(p, plan, st) : launch_encode<uint32_t, false>(p, plan, st);
}
