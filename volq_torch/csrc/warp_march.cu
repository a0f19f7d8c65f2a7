// warp_march: the march half of the fused warp kernel, for Hopper (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas (fused mode, every
// lighting mode, slab banks, perspective or orthographic camera -- the
// persp = False branches at :651-655, :680-687, :791-792, :986-988 and the
// constant-ratio fan at :1250-1253, :1312-1315 are the ORTHO instantiation of
// march_fan_exp) -- the per-particle part of its grid step: the
// ray/AABB `scale*dt` (_init_one), the telescoped optical depth
// od = sum_s (Wy_s . slab_s) . WxT_s, center-lit the one light sample at step
// S/2 (_tau_mid), the fan shift at march resolution and the exps
// P2 = 1 - exp(-od*geo), P1 = exp(-tau') * P2; per-step lit
// (light_mode="march") the OVER recurrence over density and light slabs at
// every step, in each particle's own front-to-back step order, with both
// planes (P1, P2 = 1 - T) through the fan.  The TPU kernel then upsampled
// and composited in the same grid step; here that is kernel B
// (warp_composite.cu), because GPU blocks run in no order and OVER needs
// depth order per pixel.  The TPU's particle pairing and grid packing
// (warp_pair, warp_pack) are MXU-tile and grid-step devices with the same
// per-particle arithmetic; a block per particle needs neither.
//
// Design.  One block per depth-ordered particle; threads over the RM x RM
// march grid (ray r = (j, i), row j, column i).  The TPU spelled the
// trilinear sampling as two MXU matmuls per step, Wy[RM,V] @ slab[V,VX] and
// t1 @ WxT[VX,RM]; each hat row / column has at most two non-zeros, so here
// each ray gathers the 4 slab taps it needs and forms the same two 2-term
// sums.  The rounding points of the reference are kept: hat weights rounded
// to the working type, t1 = fp32 sum of two exact products rounded to the
// working type, od = fp32 sum over steps in the matmul's K order (step, then
// x tap).  Masked rows/columns (hat position -2) contribute exact zeros and
// are skipped.  The fan shift reads neighbouring columns/rows, so the q plane
// goes through shared memory (RM*RM fp32); the tau plane bypasses the fan and
// stays in registers; the per-step lit planes take turns in that buffer.
// The device code is march_fan_exp in warp_common.cuh,
// shared with the unfused path's kernel (warp_images.cu).
//
// Bound on this card: bytes where every particle has a slab stack of its own
// (c3: 1024 x 20 x 64 x 128 bf16 = 335 MB/frame, the only large input),
// operations where a small shared bank stays in L2 (c4, c5).  Each particle's
// stack is read once from HBM into L2/L1, then gathered from cache.  The
// first version keeps the gathers simple (no TMA, no shared-memory staging of
// the stack); PERF.md holds its time against the bound.
//
// Built with --fmad=false: the reference rounds every product before its add,
// and contraction into FMA would change the fp32 results.

#include "warp_common.cuh"

// writes the march-resolution planes: [N, RM, RM] (P2) unlit,
// [N, 2, RM, RM] (P1, P2) lit
template <bool LIT> struct PlaneSink {
  float* out;
  int RR;
  __device__ __forceinline__ void operator()(int r, float P1, float P2) const {
    if (LIT) {
      out[r] = P1;
      out[RR + r] = P2;
    } else {
      out[r] = P2;
    }
  }
};

template <typename T, int MODE, bool ORTHO>
__global__ void __launch_bounds__(kMarchThreads)
warp_march_kernel(const T* __restrict__ bank, const T* __restrict__ lbank,
                  const int* __restrict__ vidx,
                  const float* __restrict__ pgeom,
                  const float* __restrict__ rxu, const float* __restrict__ ryw,
                  const float* __restrict__ camf, float* __restrict__ pm,
                  int* __restrict__ clamp_out, MarchParams p) {
  extern __shared__ float plane[];      // [RM, RM]
  __shared__ int blk_clamp;
  const int n = blockIdx.x;
  constexpr bool LIT = MODE != kUnlit;
  const int RR = p.RM * p.RM, NPL = LIT ? 2 : 1;
  float* out = pm + (size_t)n * NPL * RR;
  if (pgeom[(size_t)n * PG_N + PG_VALID] <= 0.f) {   // invalid: P = 0 (OVER
    for (int r = threadIdx.x; r < NPL * RR; r += blockDim.x)   // identity)
      out[r] = 0.f;
    return;
  }
  march_fan_exp<T, MODE, ORTHO>(bank, lbank, vidx, pgeom, rxu, ryw, camf, p,
                                n, plane, &blk_clamp, PlaneSink<LIT>{out, RR});
  __syncthreads();
  if (threadIdx.x == 0 && blk_clamp) atomicAdd(clamp_out, blk_clamp);
}

template <typename T, int MODE, bool ORTHO>
static int launch_mo(const void* bank, const void* lbank, const int* vidx,
                     const float* pgeom, const float* rxu, const float* ryw,
                     const float* camf, float* pm, int* clamp_out,
                     MarchParams p, cudaStream_t st) {
  // the fan's [RM, RM] plane: 64 KB at RM = 128, above the 48 KB default
  const size_t smem = (size_t)p.RM * p.RM * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      warp_march_kernel<T, MODE, ORTHO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  warp_march_kernel<T, MODE, ORTHO><<<p.N, kMarchThreads, smem, st>>>(
      (const T*)bank, MODE == kUnlit ? nullptr : (const T*)lbank, vidx, pgeom,
      rxu, ryw, camf, pm, clamp_out, p);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
static int launch_mode(const void* bank, const void* lbank, const int* vidx,
                       const float* pgeom, const float* rxu, const float* ryw,
                       const float* camf, float* pm, int* clamp_out,
                       MarchParams p, cudaStream_t st) {
  if (p.ortho)
    return launch_mo<T, MODE, true>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                    pm, clamp_out, p, st);
  return launch_mo<T, MODE, false>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                   pm, clamp_out, p, st);
}

template <typename T>
static int launch_m(const void* bank, const void* lbank, const int* vidx,
                    const float* pgeom, const float* rxu, const float* ryw,
                    const float* camf, float* pm, int* clamp_out,
                    MarchParams p, cudaStream_t st) {
  if (p.lit == kPerStep)
    return launch_mode<T, kPerStep>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                    pm, clamp_out, p, st);
  if (p.lit == kCenter)
    return launch_mode<T, kCenter>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                   pm, clamp_out, p, st);
  return launch_mode<T, kUnlit>(bank, lbank, vidx, pgeom, rxu, ryw, camf, pm,
                                clamp_out, p, st);
}

extern "C" int warp_march_launch(const void* bank, const void* lbank,
                                 int bank_bf16, const int* vidx,
                                 const float* pgeom, const float* rxu,
                                 const float* ryw, const float* camf,
                                 float* pm, int* clamp_out, MarchParams p,
                                 void* stream) {
  if (p.RM * p.RM > kMarchThreads * kMaxPerThread || (p.lit && !lbank) ||
      p.lit < kUnlit || p.lit > kPerStep)
    return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (bank_bf16)
    return launch_m<__nv_bfloat16>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                   pm, clamp_out, p, st);
  return launch_m<float>(bank, lbank, vidx, pgeom, rxu, ryw, camf, pm,
                         clamp_out, p, st);
}
