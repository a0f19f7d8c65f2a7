// stage_ring.cuh: the pieces of a ring of shared-memory stages filled with
// cp.async, which kernel A (warp_march.cu) walks its slab steps through.
// The 16-byte copy and the commit are the staging probes'
// (probe_common.cuh); here the wait for a ring of 2-4 stages.
//
// A ring of D stages keeps D - 1 groups in flight: before it consumes step
// q, a thread waits until at most D - 2 of its groups are pending, then a
// block barrier makes every thread's copies of step q visible.

#pragma once

#include "probe_common.cuh"

constexpr int kMaxStages = 4;

// wait until at most n (0 to kMaxStages - 2) of this thread's groups are
// pending
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
