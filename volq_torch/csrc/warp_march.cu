// warp_march: the march half of the fused warp kernel, for Hopper (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas (fused mode, every
// lighting mode, slab banks, perspective or orthographic camera -- the
// persp = False branches at :651-655, :680-687, :791-792, :986-988 and the
// constant-ratio fan at :1250-1253, :1312-1315 are the ORTHO instantiation)
// -- the per-particle part of its grid step: the ray/AABB `scale*dt`
// (_init_one), the telescoped optical depth od = sum_s (Wy_s . slab_s) .
// WxT_s, center-lit the one light sample at step S/2 (_tau_mid), the fan
// shift at march resolution and the exps P2 = 1 - exp(-od*geo),
// P1 = exp(-tau') * P2; per-step lit (light_mode="march") the OVER
// recurrence over density and light slabs at every step, in each
// particle's own front-to-back step order, with both planes (P1, P2 = 1 - T)
// through the fan.  The TPU kernel then upsampled and composited in the same
// grid step; here that is kernel B (warp_composite.cu), because GPU blocks
// run in no order and OVER needs depth order per pixel.  The TPU's particle
// pairing and grid packing (warp_pair, warp_pack) are MXU-tile and grid-step
// devices with the same per-particle arithmetic; a block per particle needs
// neither.
//
// Design: the step-major march of march.cuh (a block per depth-ordered
// particle, the slab steps staged through a shared-memory ring), whose
// finished planes this kernel stores, coalesced, through the shared plane
// to pm [N, NPL, RM, RM] fp32.
//
// Bound on this card: bytes where every particle has a slab stack of its own
// (c3: 1024 x 20 x 64 x 128 bf16 = 335 MB/frame), operations where a small
// shared bank stays in L2 (c4, c5).  Each stack is read from device memory
// once per particle, as whole slabs; the taps then cost shared-memory reads.
//
// Built with --fmad=false (march.cuh).

#include "march.cuh"

// one plane from registers to out[RM, RM], through ``plane`` so that the
// stores of neighbouring threads are neighbouring
__device__ __forceinline__ void store_plane(const float (&v)[kCap],
                                            float* plane, float* out, int RM,
                                            int j, int g0, int G, int nr) {
  const int P = RM | 1;
  #pragma unroll
  for (int c = 0; c < kCap; ++c)
    if (c < nr) plane[j * P + g0 + c * G] = v[c];
  __syncthreads();
  for (int r = threadIdx.x; r < RM * RM; r += blockDim.x)
    out[r] = plane[(r / RM) * P + r % RM];
  __syncthreads();
}

// kernel A's epilogue: the planes to out [NPL, RM, RM] (P1 then P2 lit),
// through the plane right after the column tables, at an offset the
// compiler knows (with the offset read at run time A measured up to 4%
// slower; PERF.md section 6)
template <bool LIT>
struct PlanesOut {
  static constexpr bool kPlaneAfterTables = true;
  float* out;
  __device__ __forceinline__ void operator()(
      const float (&P1)[kCap], const float (&P2)[kCap], float* plane, int j,
      int g0, int G, int nr, const MarchParams& p) const {
    if (LIT) {
      store_plane(P1, plane, out, p.RM, j, g0, G, nr);
      store_plane(P2, plane, out + p.RM * p.RM, p.RM, j, g0, G, nr);
    } else {
      store_plane(P2, plane, out, p.RM, j, g0, G, nr);
    }
  }
};

template <typename T, int MODE, bool ORTHO, bool STAGED>
__global__ void __launch_bounds__(kMaxBlock)
warp_march_kernel(const T* __restrict__ bank, const T* __restrict__ lbank,
                  const int* __restrict__ vidx,
                  const float* __restrict__ pgeom,
                  const float* __restrict__ rxu, const float* __restrict__ ryw,
                  const float* __restrict__ camf, float* __restrict__ pm,
                  int* __restrict__ clamp_out, MarchParams p, MarchPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool LIT = MODE != kUnlit;
  const int RR = p.RM * p.RM;
  float* out = pm + (size_t)blockIdx.x * (LIT ? 2 : 1) * RR;
  if (pgeom[(size_t)blockIdx.x * PG_N + PG_VALID] <= 0.f) {
    // invalid: P = 0 (the OVER identity)
    for (int r = threadIdx.x; r < (LIT ? 2 : 1) * RR; r += blockDim.x)
      out[r] = 0.f;
    return;
  }
  march_particle<T, MODE, ORTHO, STAGED>(
      bank, lbank, vidx, pgeom, rxu, ryw, camf, clamp_out, p, pl, smem,
      /*plane_off=*/0, PlanesOut<LIT>{out});
}

template <typename T, int MODE, bool ORTHO, bool STAGED>
struct LaunchA {
  static int run(const MarchParams& p, const MarchPlan& pl, const void* bank,
                 const void* lbank, const int* vidx, const float* pgeom,
                 const float* rxu, const float* ryw, const float* camf,
                 float* pm, int* clamp_out, cudaStream_t st) {
    auto kern = warp_march_kernel<T, MODE, ORTHO, STAGED>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<p.N, p.RM * pl.G, pl.smem, st>>>(
        (const T*)bank, (const T*)lbank, vidx, pgeom, rxu, ryw, camf, pm,
        clamp_out, p, pl);
    return (int)cudaGetLastError();
  }
};

extern "C" int warp_march_launch(const void* bank, const void* lbank,
                                 int bank_bf16, const int* vidx,
                                 const float* pgeom, const float* rxu,
                                 const float* ryw, const float* camf,
                                 float* pm, int* clamp_out, MarchParams p,
                                 MarchPlan pl, void* stream) {
  const int itemsize = bank_bf16 ? 2 : 4;
  const int smem = march_prefix(p, pl.stages, itemsize) + march_tail(p);
  if (!march_plan_ok(p, pl, bank, lbank, itemsize, smem) || pl.band != 0)
    return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  return march_dispatch<LaunchA>(bank_bf16, p, pl, bank,
                                 p.lit ? lbank : nullptr, vidx, pgeom, rxu,
                                 ryw, camf, pm, clamp_out,
                                 (cudaStream_t)stream);
}
