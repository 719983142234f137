// The scheduler of the host emulation (include/emu.h): runs a launch's
// blocks one after another, each block's threads as coroutines.
#include "emu.h"

#include <ucontext.h>

#include <vector>

uint3e threadIdx, blockIdx, blockDim, gridDim;

namespace {

enum State { RUN, WAIT_WARP, WAIT_BLOCK, DONE };
struct Thread {
  ucontext_t ctx;
  std::vector<char> stack;
  State st;
};
ucontext_t sched;
std::vector<Thread> threads;
std::vector<unsigned long long> slots, result;  // each thread's deposit, and the last exchange's
int cur;
std::function<void()>* body;

void entry() {
  (*body)();
  threads[cur].st = DONE;
}

}  // namespace

const unsigned long long* emu_exchange(unsigned long long v, bool block) {
  slots[cur] = v;
  threads[cur].st = block ? WAIT_BLOCK : WAIT_WARP;
  swapcontext(&threads[cur].ctx, &sched);
  return result.data();
}

void emu_run(unsigned grid, unsigned block, std::function<void()> fn) {
  body = &fn;
  gridDim = {grid, 1, 1};
  blockDim = {block, 1, 1};
  for (unsigned g = 0; g < grid; ++g) {
    blockIdx = {g, 0, 0};
    memset(emu_dynamic_smem(), 0xA5, 256 << 10);  // a block finds no zeros it did not write
    threads.assign(block, Thread{});
    slots.assign(block, 0);
    result.assign(block, 0);
    for (unsigned i = 0; i < block; ++i) {
      Thread& t = threads[i];
      t.stack.resize(1 << 18);
      getcontext(&t.ctx);
      t.ctx.uc_stack.ss_sp = t.stack.data();
      t.ctx.uc_stack.ss_size = t.stack.size();
      t.ctx.uc_link = &sched;
      makecontext(&t.ctx, entry, 0);
      t.st = RUN;
    }
    while (true) {
      for (unsigned i = 0; i < block; ++i) {  // run every thread to its next exchange or its end
        while (threads[i].st == RUN) {
          cur = i;
          threadIdx = {i, 0, 0};
          swapcontext(&sched, &threads[i].ctx);
        }
      }
      bool all_done = true, any_block = false;
      for (const Thread& t : threads) {
        all_done &= t.st == DONE;
        any_block |= t.st == WAIT_BLOCK;
      }
      if (all_done) break;
      bool released = false;
      for (unsigned w = 0; w * 32 < block; ++w) {  // a warp whose lanes all wait at a warp exchange
        int waiting = 0, other = 0;
        for (unsigned i = w * 32; i < w * 32 + 32 && i < block; ++i) {
          waiting += threads[i].st == WAIT_WARP;
          other += threads[i].st == DONE || threads[i].st == WAIT_BLOCK;
        }
        if (waiting == 0) continue;
        if (other) {
          fprintf(stderr, "emu: block %u warp %u: lanes diverged at a warp exchange\n", g, w);
          abort();
        }
        for (unsigned i = w * 32; i < w * 32 + 32; ++i) {
          result[i] = slots[i];
          threads[i].st = RUN;
        }
        released = true;
      }
      if (!released && any_block) {  // every live thread at __syncthreads
        for (unsigned i = 0; i < block; ++i)
          if (threads[i].st == WAIT_BLOCK) {
            result[i] = slots[i];
            threads[i].st = RUN;
          }
        released = true;
      }
      if (!released) {
        fprintf(stderr, "emu: block %u: deadlock\n", g);
        abort();
      }
    }
  }
}
