// hopper.cuh: the Hopper (sm_90a) mechanisms the probes price, as inline
// PTX: mbarriers (arrival counts plus expected transaction bytes, waited on
// by phase parity), the Tensor Memory Accelerator (TMA: tensor-map tile
// loads and 1-D bulk copies from device memory into shared memory, each
// completing on an mbarrier, and tensor-map tile stores back, waited for by
// bulk async-group), the proxy fences between them and ordinary loads and
// stores, and the warpgroup matrix multiply's fences, groups and
// shared-memory matrix descriptors (the instructions themselves are in
// wgmma.cuh).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers (64-bit objects in shared memory)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA) and to
// the other threads (a __syncthreads follows)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive and add ``bytes`` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// spin until the phase of parity ``parity`` has completed; a wait longer
// than 2^32 SM clocks (about 2 s) traps -- a launch error, not a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = -1;
  for (;;) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 < 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 32)) __trap();
  }
}

// ---- TMA

// ``bytes`` (a multiple of 16; both addresses 16-byte aligned) from device
// memory into shared memory, counted on ``bar``'s transaction bytes
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// one box of a 2-D / 3-D tensor map at element coordinates (innermost
// first) into shared memory; elements outside the tensor arrive as zeros.
// The innermost coordinate must be a multiple of 16 bytes: an H100 raises
// an illegal instruction (error 715) at a 4- or 8-byte offset
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// one box of a 2-D tensor map from shared memory into device memory at
// element coordinates (innermost first, a multiple of 16 bytes, as for the
// loads), in the thread's bulk async-group
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"((uint64_t)map),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// close the thread's bulk async-group (the stores issued since the last)
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's latest bulk groups are pending:
// the older ones complete, their writes performed
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// the same, but only until their reads of shared memory are done (the
// source may then be overwritten; the writes may still be in flight)
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory before it are visible to the async
// proxy (a TMA store reading that memory) after it
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the same between the proxies' accesses to device memory
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda);
// nullptr if the driver does not give it
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = (EncodeTiled)f;
  }
  return fn;
}

// ---- warpgroup matrix multiply: ordering

// the accumulators and shared operands written before are visible to the
// wgmma instructions that follow
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups are still running
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator register
// across the wgmma ordering instructions around it
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// A shared-memory matrix descriptor for a 128-byte-swizzled operand (the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B into 1024-byte-aligned
// tiles): start address, leading and stride byte offsets, each in 16-byte
// units, and the layout type 1 (128-byte swizzle) in bits 62-63.  K-major:
// rows of 128 bytes (64 bf16 along K), 8-row groups ``sbo`` = 1024 bytes
// apart, ``lbo`` unused; a k16 step inside the 128-byte row adds 32 bytes
// to the start.  MN-major: rows of 128 bytes along M or N, one per k, so an
// 8-k group is ``sbo`` = 1024 bytes and a k16 step 2048; ``lbo`` is the
// distance between 64-element chunks along M or N.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// named barrier among the first ``threads`` threads of the block
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
