// probe_common.cuh: the asynchronous-copy primitives the staging probes
// (probe_stage.cu, probe_window.cu) are about: one 16-byte cp.async per
// thread from device memory into shared memory, bypassing L1 (.cg), grouped
// and waited for with commit_group / wait_group.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until every committed group has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
