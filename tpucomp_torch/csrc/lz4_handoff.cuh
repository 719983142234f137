// The hand-off between the two warps of an LZ4 chunk (lz4_decode.cu):
// once an idle warp of the CTA has taken a chunk's copies, the chunk's own
// warp walks and checks batches of sequences and hands each over, and the
// helper writes them, through a ring of kSlots slots in shared memory.
//
// Each slot has two mbarriers, each completing a phase when a warp's 32
// lanes have arrived: the walker arrives on `full` once it has written
// the slot, the copier on `empty` once it has written that batch's bytes,
// and so is done with the slot and with the stream window the batch's
// literals are read from.  Batch n goes into slot n % kSlots; its
// barriers complete their phase n / kSlots, so a waiter asks for that
// phase's parity.  Every lane waits, and every lane arrives: each lane's
// arrival releases what it wrote or read before it, each lane's wait
// acquires what the other warp's lanes released.
//
// Snappy's decode (snappy_decode.cu) does not include this header.
#pragma once

#include <cstdint>

#include "lz_decode_common.cuh"

namespace tpucomp_lz4 {

#ifndef TPUCOMP_CUDA_EMU  // the host emulation (scripts/cuda_emu/include/emu.h) gives its own
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
// Whether the phase of this parity has completed, without waiting.
__device__ __forceinline__ bool mbar_test(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}
// The same, waiting a while (the hardware suspends the thread) first.
__device__ __forceinline__ bool mbar_try(unsigned long long* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done;
}
#endif

// Waits, with every lane, for the phase of this parity, then reconverges.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  while (!mbar_try(bar, parity)) {
  }
  __syncwarp();
}

constexpr int kBatch = 16;  // sequences a batch, at most
constexpr int kSlots = 2;   // batches in flight between the two warps

constexpr int kFinal = 1;   // Slot::head.w: the row's last slot
constexpr int kRowOk = 2;   // with kFinal: the row decodes

// One batch: sequence k's output start, literal length, match length and
// literal source in seq[k], its offset in off[k]; head = (sequences,
// output written so far, the last recorded match's offset, flags) and
// tail = the stream window's base, lo, hi, and the row's length when final.
struct Slot {
  int4 seq[kBatch];
  uint16_t off[kBatch];
  int4 head, tail;
};

// The walker's end of the ring.
struct Handoff {
  Slot* slot;
  unsigned long long* full;   // kSlots barriers: the walker filled the slot
  unsigned long long* empty;  // kSlots barriers: the copier is done with it
  int sent, waits;            // slots filled; fills that found the ring full

  // Waits until the copier is done with batch n.
  __device__ __forceinline__ void wait_copied(int n) { mbar_wait(&empty[n % kSlots], (n / kSlots) & 1); }

  // Waits until the copier is done with every batch sent: before the
  // window the batches read their literals from is staged anew.
  __device__ __forceinline__ void drain() {
    for (int n = sent > kSlots ? sent - kSlots : 0; n < sent; ++n) wait_copied(n);
  }

  // Fills the next slot: lane k < n gives sequence k; head and tail as in Slot.
  __device__ __forceinline__ void send(int lane, int n, int4 seq, int off, int4 head, int4 tail) {
    const int s = sent % kSlots;
    if (sent >= kSlots) {
      if (!mbar_test(&empty[s], ((sent - kSlots) / kSlots) & 1)) ++waits;
      wait_copied(sent - kSlots);
    }
    Slot& d = slot[s];
    if (lane < n) {
      d.seq[lane] = seq;
      d.off[lane] = (uint16_t)off;
    }
    if (lane == 0) {
      d.head = head;
      d.tail = tail;
    }
    mbar_arrive(&full[s]);
    ++sent;
  }
};

}  // namespace tpucomp_lz4
