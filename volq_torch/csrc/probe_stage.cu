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
// Design.  One block of 256 threads loops over the G steps.  A step's K
// tiles are 4 KB each: one 16-byte cp.async per thread and tile, into a
// two-deep ring in shared memory.  Per step: wait for this step's group,
// fetch the ``smem``-kind blocks (64 bytes each) with plain loads into
// shared memory, barrier, issue the next step's copies into the other slot
// (every thread is past its reads of that slot: one barrier per step is
// enough), add tile 0 of this step's slot into a register accumulator.  The
// ``const`` tiles are copied once, before the loop.  With two slots one
// step's copies are in flight while the previous step is consumed, so a step
// cannot be shorter than the latency of a copy from L2: that latency, and
// what K adds to it, is what the probe reads.
//
// Bound on this card: bytes -- the min(G, M) distinct blocks of each of the K
// stacks read once (4 KB each; later steps fetch them again, from L2) and
// the 4 KB of output written once.  The timed loop sits some three orders
// of magnitude above that: a single block reads latency, not bandwidth.
//
// The sum runs in step order in fp32, one add per element and step, so the
// result is bit-equal to the plain PyTorch loop.

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
