// Cascaded decode kernel for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/cascaded_pallas.py::_decode_kernel
// (_decode_one, _unpack_blob_tile, _delta_decode_tile, _rle_decode_tile).
// Its plain PyTorch version is
// tpucomp_torch/codecs/cascaded.py::_decompress_plain; data, byte counts and
// statuses are equal, including on corrupt input.
//
// Design: one CTA per partition.  Thread 0 checks the partition header;
// the fallback raw copy is a vectorised row copy.  Otherwise the CTA walks
// the chunk pointers (each chunk total clamped to the row size + 8, the next
// chunk at roundUp(pos + max(total, 4), w)), and for each chunk thread 0
// parses the metadata and checks every blob against the compressed size
// before any blob is read.  The CTA then unpacks the final blob into shared
// memory, inverts the schedule (delta: a block prefix sum; RLE: a block
// scan of the run counts and a binary search per output element), and
// stores the chunk's elements at the running element offset.  Blob reads
// use the JAX reference's word addressing (offsets floored to a word, word
// indices clamped into the row), so corrupt streams decode identically.
// No write leaves the output row: the element count is checked against the
// header's count (which fits the capacity) before each store, and a failing
// partition zeroes what it wrote.
//
// What bounds it on the H100: for fallback partitions, device-memory bytes
// (one read and one write of the row); for pipeline partitions, the latency
// of the per-chunk scans and barriers of one 256-thread CTA walking its
// chunks in order.
//
// The chunk element counts are summed in 64 bits; the JAX reference sums
// them in int32, so the two could differ only on streams whose chunks claim
// more than 2**31 elements in total.
//
// Supported: element widths 1, 2 and 4; every validated option set.  The
// 8-byte element types are refused by the Python wrapper.

#include "cascaded_common.cuh"

namespace tpucomp {
namespace {

constexpr int kStatusSuccess = 0;
constexpr int kStatusCannotDecompress = 12;

struct DecodeParams {
  const uint8_t* comp;
  const int32_t* comp_sizes;
  uint8_t* out;
  int32_t* out_bytes;
  int32_t* status;
  long long row_bytes;  // CMAX
  long long out_capacity;
  int width, dtype, elems, k, nr, nd, bp;
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

  // unit `idx` of `width` bytes counted from byte offset `off` floored to a word
  __device__ uint32_t unit(long long off, long long idx, int width) const {
    const long long base = off >> 2;
    if (width == 4) return word(base + idx);
    if (width == 2) return (word(base + (idx >> 1)) >> (16 * (idx & 1))) & 0xffffu;
    return (word(base + (idx >> 2)) >> (8 * (idx & 3))) & 0xffu;
  }
};

// A chunk's metadata, parsed by thread 0.
struct ChunkInfo {
  long long next, base, final_off, rle_off[8], sizes[9];
  uint32_t firsts[8];
  int ok;
};

// Elements 0..e-1 of the blob at `off` (raw units or a bitpack blob) into
// dst; returns the blob's own element count, which may exceed e.
__device__ long long read_blob(const Row& row, long long off, long long size, int width, bool bp,
                               uint32_t* dst, int e) {
  const uint32_t mask = unit_mask(width);
  const int tbits = 8 * width;
  long long n;
  if (!bp) {
    n = size / width;
    for (int i = threadIdx.x; i < e; i += kThreads) dst[i] = i < n ? row.unit(off, i, width) : 0u;
  } else {
    const uint32_t frame = row.word(off >> 2) & mask;
    const uint32_t bw_word = row.word((off + 4) >> 2);
    n = bw_word & 0xffffu;
    const int bw = min((int)(bw_word >> 16), tbits);  // clamp corrupt widths
    const long long da = off + 8;
    const uint32_t vmask = bw >= tbits ? mask : ((1u << bw) - 1u);
    for (int i = threadIdx.x; i < e; i += kThreads) {
      uint32_t x = 0;
      if (i < n) {
        x = frame;
        if (bw > 0) {
          const long long bit0 = (long long)i * bw;
          const long long lo = bit0 / tbits, hi = (bit0 + bw - 1) / tbits;
          const int offs = (int)(bit0 - lo * tbits);
          uint64_t v = (uint64_t)row.unit(da, lo, width) >> offs;
          if (hi > lo && offs != 0) v |= (uint64_t)row.unit(da, hi, width) << (tbits - offs);
          x = (((uint32_t)v & vmask) + frame) & mask;
        }
      }
      dst[i] = x;
    }
  }
  __syncthreads();
  return n;
}

// In place: a[i] = first + sum(a[j] for j < i, j < n) for i <= n, else 0.
__device__ void delta_decode(uint32_t* a, long long n, uint32_t first, int e, uint32_t mask,
                             uint32_t* scratch) {
  int lo, hi;
  segment(e, lo, hi);
  uint32_t local = 0;
  for (int i = lo; i < hi; ++i) local += i < n ? a[i] : 0u;
  uint32_t total;
  uint32_t run = block_exclusive_scan<uint32_t>(local, scratch, total);
  for (int i = lo; i < hi; ++i) {
    const uint32_t v = i < n ? a[i] : 0u;
    a[i] = i <= n ? ((first + run) & mask) : 0u;
    run += v;
  }
  __syncthreads();
}

// Expands the first num_runs runs (vals, counts in z) into out[0, e); z is
// left holding the inclusive scan of the counts.  Returns the unclipped
// total of the counts.
__device__ long long rle_decode(const uint32_t* vals, uint32_t* z, long long num_runs, uint32_t* out,
                                int e, int* scratch) {
  int lo, hi;
  segment(e, lo, hi);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += i < num_runs ? (int)z[i] : 0;
  int total;
  int run = block_exclusive_scan<int>(local, scratch, total);
  for (int i = lo; i < hi; ++i) {
    run += i < num_runs ? (int)z[i] : 0;
    z[i] = (uint32_t)run;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < e; j += kThreads) {
    uint32_t x = 0;
    if (j < total) {  // the first run whose inclusive end is past j
      int a = 0, b = e - 1;
      while (a < b) {
        const int mid = (a + b) >> 1;
        if ((int)z[mid] > j) b = mid;
        else a = mid + 1;
      }
      x = vals[a];
    }
    out[j] = x;
  }
  __syncthreads();
  return total;
}

// Thread 0: parse the metadata of the chunk at `pos` and check every blob
// against the compressed size.
__device__ void parse_chunk(const Row& row, long long pos, long long end_words, const DecodeParams& p,
                            int meta_size, int dh_off, ChunkInfo& ci) {
  const int w = p.width;
  const long long clamp = p.row_bytes + 8;
  const long long total = min((long long)row.word(pos >> 2), clamp);
  ci.next = round_up(pos + max(total, 4LL), w);
  for (int j = 0; j < p.nr + 2; ++j) {
    uint32_t v = 0;
    for (int q = 0; q < 4; ++q) v |= (uint32_t)row.byte(pos + 4 * j + q) << (8 * q);
    ci.sizes[j] = min((long long)v, clamp);
  }
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

// The chunked pipeline of one partition.  Returns whether it decoded.
__device__ bool decode_pipeline(const Row& row, long long comp_size, long long n_elems,
                                const DecodeParams& p, uint8_t* o, uint32_t* smem, ChunkInfo& ci,
                                uint32_t* uscratch, int* iscratch) {
  const int e = p.elems, w = p.width, tid = threadIdx.x;
  const uint32_t mask = unit_mask(w);
  uint32_t* buf_a = smem;
  uint32_t* buf_b = smem + e;
  uint32_t* z = smem + 2 * e;
  const int dh_off = (int)round_up(4 + 4 * (p.nr + 1), w);
  const int meta_size = dh_off + (int)round_up(w * p.nd, 4);
  const long long end_words = comp_size / 4;  // comp_size > 0 here
  const long long end4 = end_words * 4;
  const long long cap_elems = p.out_capacity / w;

  long long pos = kPartitionHeader, cum = 0, placed_end = 0;
  bool ok = true;
  for (int step = 0; step < p.k && pos < end4; ++step) {  // past end4 no chunk is live
    if (tid == 0) parse_chunk(row, pos, end_words, p, meta_size, dh_off, ci);
    __syncthreads();
    if (!ci.ok) {
      ok = false;
      break;
    }
    uint32_t* cur = buf_a;
    uint32_t* alt = buf_b;
    long long n = read_blob(row, ci.base + ci.final_off, ci.sizes[p.nr + 1], w, p.bp, cur, e);
    int rle_rem = p.nr, delta_rem = p.nd;
    const int layers = max(p.nr, p.nd);
    for (int layer = 0; layer < layers; ++layer) {
      if (delta_rem > 0 && delta_rem >= rle_rem) {
        delta_decode(cur, n, ci.firsts[delta_rem - 1], e, mask, uscratch);
        n = min(n + 1, (long long)e);
        --delta_rem;
      }
      if (rle_rem > 0 && rle_rem >= delta_rem) {
        const int r = rle_rem - 1;
        read_blob(row, ci.base + ci.rle_off[r], ci.sizes[r + 1], 2, p.bp, z, e);
        n = rle_decode(cur, z, n, alt, e, iscratch);
        uint32_t* t = cur; cur = alt; alt = t;
        --rle_rem;
      }
    }
    cum += n;
    if (cum > n_elems) {
      ok = false;
      break;
    }
    // ragged concat: the chunk's first min(n, e) elements
    const long long placed = min(n, (long long)e);
    for (long long j = tid; j < placed; j += kThreads) {
      const long long at = placed_end + j;
      if (at >= cap_elems) break;
      const uint32_t v = cur[j];
      if (w == 4) reinterpret_cast<uint32_t*>(o)[at] = v;
      else if (w == 2) reinterpret_cast<uint16_t*>(o)[at] = (uint16_t)v;
      else o[at] = (uint8_t)v;
    }
    placed_end += placed;
    pos = ci.next;
    __syncthreads();  // ci and the buffers are rewritten by the next chunk
  }
  ok = ok && cum == n_elems && pos >= end4;  // every element, every chunk consumed
  if (!ok) {
    const long long written = min(placed_end, cap_elems) * w;
    for (long long i = tid; i < written; i += kThreads) o[i] = 0;
  }
  return ok;
}

__global__ void __launch_bounds__(kThreads) cascaded_decode_kernel(DecodeParams p) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t uscratch[kWarps];
  __shared__ int iscratch[kWarps];
  __shared__ ChunkInfo ci;
  const int w = p.width, b = blockIdx.x;
  const uint8_t* src = p.comp + (long long)b * p.row_bytes;
  const Row row{src, p.row_bytes, max(2LL, (p.row_bytes + 3) / 4), ((uintptr_t)src & 3) == 0};
  uint8_t* o = p.out + (long long)b * p.out_capacity;

  const long long comp_size = p.comp_sizes[b];
  const int nr = row.byte(0), nd = row.byte(1), ubp = row.byte(2), dt = row.byte(3);
  uint32_t nb = 0;
  for (int q = 0; q < 4; ++q) nb |= (uint32_t)row.byte(4 + q) << (8 * q);
  const long long n_bytes = (int32_t)nb;  // read as int32, as the JAX reference does
  const long long n_elems = floor_div(n_bytes, w);

  bool ok = comp_size >= kPartitionHeader && p.out_capacity >= n_bytes;
  if (ok && nr == 0 && nd == 0 && ubp == 0) {  // raw fallback
    ok = comp_size >= kPartitionHeader + n_elems * w;
    if (ok) copy_bytes(o, src + kPartitionHeader, min(n_elems * w, p.row_bytes - kPartitionHeader));
  } else if (ok) {
    ok = nr == p.nr && nd == p.nd && ubp == p.bp && dt == p.dtype &&
         decode_pipeline(row, comp_size, n_elems, p, o, smem, ci, uscratch, iscratch);
  }
  if (threadIdx.x == 0) {
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
  DecodeParams p{static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_sizes),
                 static_cast<uint8_t*>(out), static_cast<int32_t*>(out_bytes),
                 static_cast<int32_t*>(status), row_bytes, out_capacity, width, dtype, elems, k,
                 nr, nd, bp};
  const size_t smem = 3 * sizeof(uint32_t) * (size_t)elems;
  cudaError_t err = cudaFuncSetAttribute(cascaded_decode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cascaded_decode_kernel<<<(unsigned)batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
