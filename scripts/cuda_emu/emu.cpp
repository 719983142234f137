// The scheduler of the host emulation (include/emu.h): runs a launch's
// blocks one after another, each block's threads as coroutines.  A round
// runs every thread to its next exchange, yield or end; then it releases
// each warp whose 32 lanes all wait at an exchange, or else the block's
// __syncthreads, and lets the yielding threads run again.
#include "emu.h"

#include <ucontext.h>

#include <vector>

uint3e threadIdx, blockIdx, blockDim, gridDim;
unsigned long long emu_arrivals;

namespace {

enum State { RUN, WAIT_WARP, WAIT_BLOCK, YIELD, DONE };
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

void emu_yield() {
  threads[cur].st = YIELD;
  swapcontext(&threads[cur].ctx, &sched);
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
      const unsigned long long arrivals = emu_arrivals;
      for (unsigned i = 0; i < block; ++i) {  // run every thread to its next exchange, yield or end
        while (threads[i].st == RUN) {
          cur = i;
          threadIdx = {i, 0, 0};
          swapcontext(&sched, &threads[i].ctx);
        }
      }
      bool all_done = true, any_block = false, any_yield = false;
      for (const Thread& t : threads) {
        all_done &= t.st == DONE;
        any_block |= t.st == WAIT_BLOCK;
        any_yield |= t.st == YIELD;
      }
      if (all_done) break;
      bool released = false;
      for (unsigned w = 0; w * 32 < block; ++w) {  // a warp whose lanes all wait at a warp exchange
        int waiting = 0, other = 0, yielding = 0;
        for (unsigned i = w * 32; i < w * 32 + 32 && i < block; ++i) {
          waiting += threads[i].st == WAIT_WARP;
          other += threads[i].st == DONE || threads[i].st == WAIT_BLOCK;
          yielding += threads[i].st == YIELD;
        }
        if (waiting == 0) continue;
        if (other) {
          fprintf(stderr, "emu: block %u warp %u: lanes diverged at a warp exchange\n", g, w);
          abort();
        }
        if (yielding) continue;  // the others are still waiting on a barrier
        for (unsigned i = w * 32; i < w * 32 + 32; ++i) {
          result[i] = slots[i];
          threads[i].st = RUN;
        }
        released = true;
      }
      if (!released && any_block && !any_yield) {  // every live thread at __syncthreads
        for (unsigned i = 0; i < block; ++i)
          if (threads[i].st == WAIT_BLOCK) {
            result[i] = slots[i];
            threads[i].st = RUN;
          }
        released = true;
      }
      if (!released && (!any_yield || emu_arrivals == arrivals)) {
        fprintf(stderr, "emu: block %u: deadlock\n", g);
        abort();
      }
      for (Thread& t : threads)
        if (t.st == YIELD) t.st = RUN;
    }
  }
}
