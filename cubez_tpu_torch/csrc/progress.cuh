// Progress counters between the CTAs of one cooperative launch, for the
// lagged sweeps of P1 (psor.cu) and P2 (pcr_gs.cu).  A CTA publishes that
// a task is done by adding to a counter after a barrier over its threads
// (thread 0's add, a release at gpu scope); a CTA waits for a
// task by spinning its thread 0 on the counter (acquire), then releases its
// threads with a barrier.  Data written before the writer's barrier is
// then visible to loads through L2 (__ldcg) after the reader's.  Every CTA
// is co-resident (a cooperative launch), so a spin ends once the tasks it
// waits for have run.

#pragma once

#include <cuda_runtime.h>

namespace cz {

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
  return t;
}

// A wait longer than this is a fault of the schedule (a launch's waits
// last microseconds): the kernel traps, so the launch fails and its
// wrapper raises, where a deadlock would hang the card.
constexpr unsigned long long kWaitLimitNs = 10'000'000'000ull;

// Thread 0 only: spin until *p >= v.
__device__ __forceinline__ void wait_at_least(const unsigned* p, unsigned v) {
  if (ld_acquire(p) >= v) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(p) < v)
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

// Thread 0 only, after a barrier over the CTA: the CTA's writes happen
// before *p + 1 is seen.
__device__ __forceinline__ void release_add(unsigned* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(p), "r"(1u) : "memory");
}

}  // namespace cz
