// probe_stage: what one step of a staged sequential loop costs on Hopper
// (sm_90a).
//
// Replaces: bench/specs_probe.py:run -- a Pallas grid of G sequential steps
// in which K per-step-indexed [1, 8, 128] fp32 blocks (plus ``smem``-kind
// [1, 1, 16] blocks and ``const`` blocks whose index never changes) are
// fetched on every step while the body only adds block 0 into the output:
// out[8, 128] = sum over n < G of X_0[n % M], in step order.  It priced the
// TPU's per-grid-step machinery.  The card's version of the question: a
// block that walks a sequence (kernel A's slab stack, a particle list) and
// stages each step's tiles from device memory into shared memory pays a
// fixed price per step -- issue, wait, barrier -- however little it computes.
//
// Two arms.  ``cp_async``, the Ampere-era staging: one block of 256
// threads loops over the G steps.  A step's K tiles are 4 KB each: one
// 16-byte cp.async per thread and tile, into a two-deep ring in shared
// memory.  Per step: wait for this step's group, fetch the ``smem``-kind
// blocks (64 bytes each) with plain loads into shared memory, barrier, issue
// the next step's copies into the other slot (every thread is past its reads
// of that slot: one barrier per step is enough), add tile 0 of this step's
// slot into a register accumulator.  The ``const`` tiles are copied once,
// before the loop.  With two slots one step's copies are in flight while the
// previous step is consumed, so a step cannot be shorter than the latency of
// a copy from L2: that latency, and what K adds to it, is what it reads.
//
// ``tma``, Hopper's staging: a ring of D slots (D = ``depth``, 2 to 8) with
// a ``full`` and an ``empty`` mbarrier each, two producer warps taking
// alternate steps and 256 consumer threads.  Each of a step's K tiles (4
// KB, contiguous in [M, 8, 128]) and ``smem``-kind blocks (64 bytes) comes
// in by a 1-D bulk copy (cp.async.bulk, no tensor map), one producer lane
// each, completing on the slot's ``full`` barrier, whose phase expects the
// step's bytes; the producer's lane 0 refills a slot once the consumers'
// arrivals on its ``empty`` barrier say they have read it, so D - 1 steps
// of copies are in flight beyond the one being read.  A consumer thread waits on ``full`` by phase parity
// (mbarrier.try_wait.parity), reads its float4 of tile 0, adds it, and its
// warp arrives once on ``empty``: no block-wide barrier in the step loop.
// The ``const`` tiles come in by bulk copy too, once, on a barrier of their
// own.  The wrapper checks that every source is 16-byte aligned.
//
// Bound on this card: the sum is a serial chain -- G dependent fp32 adds
// per element, which bit-equality with the plain loop requires -- so the
// least time is the largest of: the bytes (the min(G, M) distinct blocks of
// each of the K stacks read once, 4 KB each, and the 4 KB of output written
// once), the operations (one add per element and step), and G times the
// latency of a dependent fp32 add at the SM clock (``fadd_chain_kernel``
// below times that latency on the card).  The chain dominates.
//
// The sum runs in step order in fp32, one add per element and step, so both
// arms are bit-equal to the plain PyTorch loop.

#include "hopper.cuh"
#include "probe_common.cuh"

constexpr int kThreads = 256;              // one float4 of a tile per thread
constexpr int kMaxK = 16, kMaxSmall = 4, kMaxConst = 4;

// mirrors StageParams in volq_torch/probe/stage.py
struct StageParams {
  const float* xs[kMaxK];          // K stacks [M, 8, 128]
  const float* small[kMaxSmall];   // n_small stacks [M, 1, 16]
  const float* cst[kMaxConst];     // n_const stacks [M, 8, 128], block 0 used
  int K, n_small, n_const, M, G;
};

__global__ void __launch_bounds__(kThreads)
probe_stage_kernel(StageParams p, float* __restrict__ out) {
  extern __shared__ float4 smem[];
  // the stacks' base pointers, indexed by a loop variable below
  __shared__ const float* xs[kMaxK];
  __shared__ const float* small[kMaxSmall];
  const int tid = threadIdx.x;
  if (tid < kMaxK) xs[tid] = p.xs[tid];
  if (tid < kMaxSmall) small[tid] = p.small[tid];
  __syncthreads();
  float4* ring = smem;                              // [2][K][256]
  float4* cst = ring + 2 * p.K * kThreads;          // [n_const][256]
  volatile float* sm =
      reinterpret_cast<volatile float*>(cst + p.n_const * kThreads);

  for (int c = 0; c < p.n_const; ++c)
    cp_async16(&cst[c * kThreads + tid], p.cst[c] + tid * 4);
  for (int k = 0; k < p.K; ++k)               // step 0 into slot 0
    cp_async16(&ring[k * kThreads + tid], xs[k] + tid * 4);
  cp_async_commit();

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  int blk = 0;                                      // n % M
  for (int n = 0; n < p.G; ++n) {
    cp_async_wait_all();
    if (tid < 16 * p.n_small)
      sm[tid] = small[tid >> 4][blk * 16 + (tid & 15)];
    __syncthreads();
    const int nblk = blk + 1 == p.M ? 0 : blk + 1;
    if (n + 1 < p.G) {
      float4* slot = ring + ((n + 1) & 1) * p.K * kThreads;
      const size_t off = (size_t)nblk * 1024 + tid * 4;
      for (int k = 0; k < p.K; ++k)
        cp_async16(&slot[k * kThreads + tid], xs[k] + off);
      cp_async_commit();
    }
    const float4 v = ring[(n & 1) * p.K * kThreads + tid];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    blk = nblk;
  }
  reinterpret_cast<float4*>(out)[tid] = acc;
}

extern "C" int probe_stage_launch(StageParams p, float* out, void* stream) {
  if (p.K < 1 || p.K > kMaxK || p.n_small > kMaxSmall ||
      p.n_const > kMaxConst || p.M < 1 || p.G < 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (2 * p.K + p.n_const) * kThreads * (int)sizeof(float4) +
                   kMaxSmall * 16 * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      probe_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  probe_stage_kernel<<<1, kThreads, smem, (cudaStream_t)stream>>>(p, out);
  return (int)cudaGetLastError();
}

// ======================================================================
// tma arm

constexpr int kProducers = 2;                // producer warps
constexpr int kTmaThreads = kThreads + 32 * kProducers;
constexpr int kMaxDepth = 8;

__global__ void __launch_bounds__(kTmaThreads)
probe_stage_tma_kernel(StageParams p, int depth, int slot_bytes,
                       float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char tsmem[];
  // the ring: depth slots of [K][4 KB] + [n_small][64 B]; then the const
  // tiles; then the mbarriers (full[depth], empty[depth], const)
  const uint32_t ring = smem_u32(tsmem);
  const uint32_t cst = ring + depth * slot_bytes;
  const uint32_t full0 = cst + p.n_const * 4096;
  const uint32_t empty0 = full0 + 8 * kMaxDepth;
  const uint32_t cbar = empty0 + 8 * kMaxDepth;
  // the stacks' base pointers, indexed by a loop variable below
  __shared__ const float* xs[kMaxK];
  __shared__ const float* small[kMaxSmall];
  const int tid = threadIdx.x;
  if (tid < kMaxK) xs[tid] = p.xs[tid];
  if (tid < kMaxSmall) small[tid] = p.small[tid];
  if (tid == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kThreads / 32);   // one arrival a warp
    }
    mbar_init(cbar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kThreads) {
    // ---- producer warps: warp w takes steps n = w, w + kProducers, ...
    // (one warp's serial work a step -- the empty wait, arming the full
    // barrier, the copies -- took longer than the consumers' step).  Its
    // lane 0 waits for the slot and arms the slot's full barrier, then lane
    // k copies tile k and lane K + j small block j.
    const int w = (tid - kThreads) >> 5, lane = tid & 31;
    if (p.n_const && w == 0 && lane == 0) {
      mbar_arrive_tx(cbar, p.n_const * 4096);
      for (int c = 0; c < p.n_const; ++c)
        bulk_load(cst + c * 4096, p.cst[c], 4096, cbar);
    }
    const uint32_t step_bytes = p.K * 4096 + p.n_small * 64;
    const bool tile = lane < p.K, blkcp = !tile && lane < p.K + p.n_small;
    const float* src = tile ? xs[lane] : blkcp ? small[lane - p.K] : nullptr;
    const int src_step = tile ? 1024 : 16;           // floats a block
    const uint32_t dst_off = tile ? lane * 4096
                                  : p.K * 4096 + (lane - p.K) * 64;
    const uint32_t nbytes = tile ? 4096 : 64;
    int blk = w % p.M, s = w, use = 0;               // n % M, n % depth,
    for (int n = w; n < p.G; n += kProducers) {      // n / depth
      const uint32_t full = full0 + 8 * s;
      if (lane == 0) {
        if (use > 0) mbar_wait(empty0 + 8 * s, (use - 1) & 1);
        mbar_arrive_tx(full, step_bytes);
      }
      __syncwarp();
      if (tile || blkcp)
        bulk_load(ring + s * slot_bytes + dst_off,
                  src + (size_t)blk * src_step, nbytes, full);
      blk += kProducers;
      if (blk >= p.M) blk %= p.M;
      s += kProducers;
      if (s >= depth) {
        s -= depth;
        ++use;
      }
    }
    return;
  }

  // ---- consumers: thread tid owns float4 tid of tile 0
  const float4* ring_p = reinterpret_cast<const float4*>(tsmem);
  const int slot4 = slot_bytes / 16;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.n_const) mbar_wait(cbar, 0);
  int s = 0;
  uint32_t parity = 0;
  for (int n = 0; n < p.G; ++n) {
    mbar_wait(full0 + 8 * s, parity);
    const float4 v = ring_p[s * slot4 + tid];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == depth) {
      s = 0;
      parity ^= 1;
    }
  }
  reinterpret_cast<float4*>(out)[tid] = acc;
}

// shared memory of the tma arm: the ring, the const tiles, the barriers
static int tma_smem(const StageParams& p, int depth, int slot_bytes) {
  return depth * slot_bytes + p.n_const * 4096 + 8 * (2 * kMaxDepth + 1);
}

// ``slot_bytes`` = K * 4096 + n_small * 64 rounded up to 128 (the wrapper's
// plan); every source 16-byte aligned (the wrapper checks).
extern "C" int probe_stage_tma_launch(StageParams p, int depth,
                                      int slot_bytes, float* out,
                                      void* stream) {
  if (p.K < 1 || p.K > kMaxK || p.n_small > kMaxSmall ||
      p.n_const > kMaxConst || p.M < 1 || p.G < 0 || depth < 2 ||
      depth > kMaxDepth || slot_bytes < p.K * 4096 + p.n_small * 64 ||
      slot_bytes % 128)
    return (int)cudaErrorInvalidValue;
  const int smem = tma_smem(p, depth, slot_bytes);
  cudaError_t e = cudaFuncSetAttribute(
      probe_stage_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  probe_stage_tma_kernel<<<1, kTmaThreads, smem, (cudaStream_t)stream>>>(
      p, depth, slot_bytes, out);
  return (int)cudaGetLastError();
}

// ======================================================================
// The chain term of the bound: the latency of a dependent fp32 add, in SM
// clocks.  One thread times kChain adds, each on the previous one's result,
// between two reads of clock64; the chain runs twice so that the second,
// timed, pass finds its instructions in the cache.  ``sink`` keeps the sum.

constexpr int kChain = 256;

__global__ void fadd_chain_kernel(float x, float y, long long* clocks,
                                  float* sink) {
  long long t0 = 0, t1 = 0;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0)::"memory");
#pragma unroll
    for (int i = 0; i < kChain; ++i)
      asm volatile("add.f32 %0, %0, %1;" : "+f"(x) : "f"(y));
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1)::"memory");
  }
  clocks[0] = t1 - t0;
  clocks[1] = kChain;
  *sink = x;
}

// clocks[0]: SM clocks of the timed chain, clocks[1]: its length.
extern "C" int fadd_chain_launch(long long* clocks, float* sink,
                                 void* stream) {
  fadd_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(1.0f, 1e-7f, clocks,
                                                       sink);
  return (int)cudaGetLastError();
}
