// Cascaded encode kernel (RLE / Delta / FOR + bitpack) for NVIDIA Hopper.
//
// Replaces the TPU kernel tpucomp/kernels/cascaded_pallas.py::_encode_kernel
// (bodies _pipeline_body and _assembly_body).  Its plain PyTorch version is
// tpucomp_torch/codecs/cascaded.py::_compress_plain; the bytes are equal.
//
// Design: one CTA per partition.  The CTA walks the partition's scheme
// chunks in order: it loads a chunk's elements into shared memory, runs the
// static op schedule (RLE before Delta within each layer) with block scans
// and reductions, bit-packs each emitted array straight into the output row
// (each thread assembles whole u32 words, so no atomics), and writes the
// chunk metadata.  Chunk offsets are the running sum of chunk totals, which
// is sequential inside the CTA.  The raw-copy fallback is decided the way
// the format defines it: as soon as a blob would end past
// 8 + roundUp4(input_bytes), the pipeline stops, because the fallback is
// then certain; no classifier pass is needed.
//
// What bounds it on the H100: for fallback partitions, device-memory bytes
// (one read of the input row, one write of the output row, copied in
// 8- or 16-byte vectors where the rows are aligned); for pipeline
// partitions, the latency of the per-chunk block scans and barriers, since
// one CTA of 256 threads walks its chunks one after another.  Occupancy
// (up to 8 CTAs per SM at the default 4 KB chunks, 12 bytes of shared
// memory per element) hides part of that latency.
//
// Supported: element widths 1, 2 and 4; every validated option set.  The
// 8-byte element types are refused by the Python wrapper.

#include "cascaded_common.cuh"

namespace tpucomp {
namespace {

struct EncodeParams {
  const uint8_t* data;
  const int32_t* lengths;
  uint8_t* out;
  int32_t* sizes;
  long long row_bytes;  // C
  long long pmax;
  int width, dtype, elems, k, nr, nd, bp;
};

// Unsigned element at element index gi of an input row; bytes past the
// row's end read 0.
__device__ __forceinline__ uint32_t load_elem(const uint8_t* in, long long row_bytes, long long gi,
                                              int width, bool aligned) {
  const long long byte = gi * width;
  if (aligned && byte + width <= row_bytes) {
    if (width == 4) return *reinterpret_cast<const uint32_t*>(in + byte);
    if (width == 2) return *reinterpret_cast<const uint16_t*>(in + byte);
    return in[byte];
  }
  uint32_t v = 0;
  for (int j = 0; j < width; ++j)
    if (byte + j < row_bytes) v |= (uint32_t)in[byte + j] << (8 * j);
  return v;
}

// Frame of reference and bit width of v[0, n): signed min/max, the range in
// wrapping u32 math; both 0 for n == 0.
__device__ void for_bitwidth(const uint32_t* v, int n, int width, uint32_t& frame, int& bw,
                             int32_t* scratch) {
  int lo, hi;
  segment(n, lo, hi);
  int32_t mn = INT32_MAX, mx = INT32_MIN;
  for (int i = lo; i < hi; ++i) {
    const int32_t s = sext(v[i], width);
    mn = min(mn, s);
    mx = max(mx, s);
  }
  block_min_max(mn, mx, scratch);
  frame = n ? ((uint32_t)mn & unit_mask(width)) : 0u;
  bw = n ? bit_width32((uint32_t)mx - (uint32_t)mn) : 0;
}

__device__ __forceinline__ long long blob_size(bool bp, int n, int bw, int width) {
  return bp ? 8 + 4 * (((long long)n * bw + 31) >> 5) : (long long)n * width;
}

// Writes the blob of v[0, n) at dst (4-byte aligned): a bitpack blob
// (u32 frame, u32 (bw << 16) | n, then the little-endian bit stream) or the
// raw units, zero-padded to a word.  Each thread builds whole output words.
// Only the first `room` words are written: the row ends there (the plain
// version truncates its assembled row the same way).
__device__ void write_blob(uint32_t* dst, long long room, const uint32_t* v, int n, int width,
                           bool bp, uint32_t frame, int bw) {
  const uint32_t mask = unit_mask(width);
  if (bp) {
    if (threadIdx.x == 0) {
      if (room > 0) dst[0] = frame;
      if (room > 1) dst[1] = ((uint32_t)bw << 16) | (uint32_t)n;
    }
    const long long nwords = min(((long long)n * bw + 31) >> 5, room - 2);
    for (long long j = threadIdx.x; j < nwords; j += kThreads) {
      const long long bitlo = 32 * j;
      const int first = (int)(bitlo / bw);
      const int last = (int)min((long long)n - 1, (bitlo + 31) / bw);
      uint32_t acc = 0;
      for (int i = first; i <= last; ++i) {
        const uint32_t u = (v[i] - frame) & mask;
        const long long sh = (long long)i * bw - bitlo;  // in (-bw, 32)
        acc |= sh >= 0 ? (u << sh) : (u >> -sh);
      }
      dst[2 + j] = acc;
    }
  } else {
    const long long nbytes = (long long)n * width;
    const long long nwords = min((nbytes + 3) >> 2, room);
    for (long long j = threadIdx.x; j < nwords; j += kThreads) {
      uint32_t acc = 0;
      for (int q = 0; q < 4; ++q) {
        const long long byte = 4 * j + q;
        if (byte < nbytes) acc |= ((v[byte / width] >> (8 * (byte % width))) & 0xffu) << (8 * q);
      }
      dst[j] = acc;
    }
  }
}

// Runs of cur[0, n): values to vals[r], lengths to counts[r].  Returns the
// run count.
__device__ int rle_encode(const uint32_t* cur, int n, uint32_t* vals, uint32_t* counts,
                          int* scratch) {
  int lo, hi;
  segment(n, lo, hi);
  int local = 0;
  for (int i = lo; i < hi; ++i) local += (i == n - 1) || (cur[i] != cur[i + 1]);
  int runs;
  const int r0 = block_exclusive_scan<int>(local, scratch, runs);
  int r = r0;
  for (int i = lo; i < hi; ++i)
    if (i == n - 1 || cur[i] != cur[i + 1]) {
      vals[r] = cur[i];
      counts[r] = i + 1;  // run end + 1, turned into a length below
      ++r;
    }
  __syncthreads();
  uint32_t prev = (local && r0) ? counts[r0 - 1] : 0u;
  __syncthreads();
  for (int q = r0; q < r0 + local; ++q) {
    const uint32_t end = counts[q];
    counts[q] = end - prev;
    prev = end;
  }
  __syncthreads();
  return runs;
}

// out[i] = cur[i+1] - cur[i] (wrapping in the element width) for i < n - 1.
// Returns cur[0] (0 for n == 0).
__device__ uint32_t delta_encode(const uint32_t* cur, int n, uint32_t* out, uint32_t mask) {
  for (int i = threadIdx.x; i < n - 1; i += kThreads) out[i] = (cur[i + 1] - cur[i]) & mask;
  const uint32_t first = n > 0 ? cur[0] : 0u;
  __syncthreads();
  return first;
}

__global__ void __launch_bounds__(kThreads) cascaded_encode_kernel(EncodeParams p) {
  extern __shared__ uint32_t smem[];
  __shared__ int32_t scratch[2 * kWarps];
  __shared__ int iscratch[kWarps];
  const int e = p.elems, w = p.width, tid = threadIdx.x;
  uint32_t* buf_a = smem;
  uint32_t* buf_b = smem + e;
  uint32_t* counts = smem + 2 * e;

  const int b = blockIdx.x;
  const uint8_t* in = p.data + (long long)b * p.row_bytes;
  uint8_t* o = p.out + (long long)b * p.pmax;
  const long long length = p.lengths[b];
  if (length <= 0) {  // the row stays all zero
    if (tid == 0) p.sizes[b] = 0;
    return;
  }
  const long long n_elems = length / w;
  const long long input_bytes = n_elems * w;
  const long long limit = kPartitionHeader + round_up(input_bytes, 4);
  const uint32_t mask = unit_mask(w);
  const bool aligned = ((uintptr_t)in % w) == 0;
  const int dh_off = (int)round_up(4 + 4 * (p.nr + 1), w);
  const int meta_size = dh_off + (int)round_up(w * p.nd, 4);

  bool fallback = p.nr == 0 && p.nd == 0 && !p.bp;
  long long off = kPartitionHeader;  // chunk offset: running sum of totals
  const long long nchunks = min((long long)p.k, (n_elems + e - 1) / e);
  for (long long c = 0; c < nchunks && !fallback; ++c) {
    const int cn = (int)min((long long)e, n_elems - c * e);
    for (int i = tid; i < cn; i += kThreads) buf_a[i] = load_elem(in, p.row_bytes, c * e + i, w, aligned);
    __syncthreads();

    uint32_t* cur = buf_a;
    uint32_t* alt = buf_b;
    int n = cn;
    long long pos = meta_size;  // chunk-relative write position
    uint32_t rle_size[8], firsts[8];
    const int layers = max(p.nr, p.nd);
    for (int layer = 0; layer < layers; ++layer) {
      if (layer < p.nr) {
        const int runs = rle_encode(cur, n, alt, counts, iscratch);
        uint32_t frame = 0;
        int bw = 0;
        if (p.bp) for_bitwidth(counts, runs, 2, frame, bw, scratch);
        const long long size = blob_size(p.bp, runs, bw, 2);
        if (off + pos + round_up(size, 4) > limit) {
          fallback = true;
          break;
        }
        write_blob(reinterpret_cast<uint32_t*>(o + off + pos), (p.pmax - off - pos) / 4, counts,
                   runs, 2, p.bp, frame, bw);
        __syncthreads();  // the next RLE overwrites counts
        rle_size[layer] = (uint32_t)size;
        pos += round_up(size, 4);
        uint32_t* t = cur; cur = alt; alt = t;
        n = runs;
      }
      if (layer < p.nd) {
        firsts[layer] = delta_encode(cur, n, alt, mask);
        uint32_t* t = cur; cur = alt; alt = t;
        n = max(n - 1, 0);
      }
    }
    if (fallback) break;

    const long long fpos = round_up(pos, w);
    uint32_t frame = 0;
    int bw = 0;
    if (p.bp) for_bitwidth(cur, n, w, frame, bw, scratch);
    const long long size = blob_size(p.bp, n, bw, w);
    if (off + fpos + round_up(size, 4) > limit) {
      fallback = true;
      break;
    }
    write_blob(reinterpret_cast<uint32_t*>(o + off + fpos), (p.pmax - off - fpos) / 4, cur, n, w,
               p.bp, frame, bw);
    const long long total = round_up(fpos + round_up(size, 4), w);
    if (tid == 0 && off + meta_size <= p.pmax) {
      uint32_t* meta = reinterpret_cast<uint32_t*>(o + off);
      meta[0] = (uint32_t)total;
      for (int r = 0; r < p.nr; ++r) meta[1 + r] = rle_size[r];
      meta[1 + p.nr] = (uint32_t)size;
      for (int d = 0; d < p.nd; ++d)
        for (int j = 0; j < w; ++j) o[off + dh_off + d * w + j] = (uint8_t)(firsts[d] >> (8 * j));
    }
    __syncthreads();  // the next chunk reloads buf_a
    off += total;
  }

  if (fallback) {
    // raw elements at byte 8; zero whatever the pipeline wrote past them
    __syncthreads();
    const long long ncopy = min(input_bytes, p.row_bytes);
    copy_bytes(o + kPartitionHeader, in, ncopy);
    const long long zero_end = min(limit, p.pmax);
    for (long long i = kPartitionHeader + ncopy + tid; i < zero_end; i += kThreads) o[i] = 0;
    off = kPartitionHeader + round_up(input_bytes, 4);
  }
  if (tid == 0) {
    const uint32_t layers = fallback ? 0u : (uint32_t)p.nr | ((uint32_t)p.nd << 8) | ((uint32_t)p.bp << 16);
    reinterpret_cast<uint32_t*>(o)[0] = layers | ((uint32_t)p.dtype << 24);
    reinterpret_cast<uint32_t*>(o)[1] = (uint32_t)input_bytes;
    p.sizes[b] = (int32_t)off;
  }
}

}  // namespace
}  // namespace tpucomp

// C interface, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int tc_cascaded_encode(const void* data, const void* lengths, void* out, void* sizes,
                                  long long batch, long long row_bytes, long long pmax, int width,
                                  int dtype, int elems, int k, int nr, int nd, int bp, void* stream) {
  using namespace tpucomp;
  EncodeParams p{static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
                 static_cast<uint8_t*>(out), static_cast<int32_t*>(sizes), row_bytes, pmax,
                 width, dtype, elems, k, nr, nd, bp};
  const size_t smem = 3 * sizeof(uint32_t) * (size_t)elems;
  cudaError_t err = cudaFuncSetAttribute(cascaded_encode_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cascaded_encode_kernel<<<(unsigned)batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
