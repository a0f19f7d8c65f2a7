// warp_images: the unfused warp march, for Hopper (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas in unfused mode
// (warp_fused=False, the pallas_call that writes per-particle image blocks),
// under a perspective or an orthographic camera, every lighting mode
// -- per particle: the march, the fan shift and the exps at march resolution
// (the step-major march of march.cuh that the fused path's kernel A runs),
// then its epilogue: the RM -> RP hat upsample of the planes (plane rounded
// to the working type, y pass summed in fp32 and rounded to the working
// type, x pass summed in fp32; identity when RM == RP) and the RGB
// expansion
//   img[ch] = wdt(alb_ch * (lcol_ch * P1 + amb_ch * P2)),  img[3] = wdt(1 - P2)
// into images [N, 4, RP, RP] in the working type, plus the shift-clamp
// count.  Unlit (P1 == P2), center-lit and per-step lit.  The composite is
// kernel D (composite_chunk.cu).
//
// Design.  One block per particle, in whatever order the caller marches
// them (the composite fixes the depth order), marching as kernel A does:
// the plan (volq_torch/render/kernel.py:images_plan) has A's block widths
// and ring depths.  The epilogue then puts P2 in the march's shared plane
// and P1 (lit) beside the ring; the upsample's two matmuls have two
// non-zeros per weight row, so they become 2-tap sums: a y pass into
// [band, RM] shared rows per plane, then the x pass fused with the RGB
// expansion and the store, coalesced along x, one band of output rows at a
// time.  The ring is dead after the march's last step, so the P1 plane and
// the y-pass rows alias it: the plan takes the most rows a band (up to RP)
// that keep C's shared bytes within the SM share of the blocks A's plan
// holds, so C keeps A's blocks per SM.  Invalid particles write the OVER
// identity (C = 0, T = 1).
//
// Bound on this card: operations on c4 (the march's taps of a shared bank
// that stays in L2); the N * 4 * RP^2 image write (c4: 2048 x 4 x 96 x 96
// bf16 = 151 MB per megachunk) is the bytes side.
//
// Built with --fmad=false (march.cuh).

#include <algorithm>

#include "march.cuh"

// shared bytes of the epilogue before the plane (they alias the ring): the
// P1 plane [RM][RM | 1] (lit) and NPL y-pass rows [band][RM]
__host__ __device__ inline int images_epi(const MarchParams& p, int band) {
  const int npl = p.lit ? 2 : 1;
  return ((p.lit ? p.RM * (p.RM | 1) : 0) + npl * band * p.RM) * 4;
}

// kernel C's epilogue: the upsample and RGB expansion of one particle's
// planes into its image img [4, RP, RP]
template <typename T, bool LIT>
struct ImagesOut {
  static constexpr bool kPlaneAfterTables = false;   // at plane_off
  T* img;
  float* p1;           // the P1 plane [RM][RM | 1] (lit)
  float* t2;           // y-pass rows [band][RM] of P2, then (lit) of P1
  const float* alb;    // this particle's albedo [3]
  const float* lightf; // light colour [3], ambient [3]
  int band;

  // the four channels of pixel e from its planes' values
  __device__ __forceinline__ void put(int e, int PP, float P1, float P2,
                                     const float (&a)[3],
                                     const float (&lc)[3],
                                     const float (&am)[3]) const {
    #pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      img[ch * PP + e] = cvt<T>(__fmul_rn(
          a[ch], __fadd_rn(__fmul_rn(lc[ch], P1), __fmul_rn(am[ch], P2))));
    img[3 * PP + e] = cvt<T>(__fsub_rn(1.f, P2));
  }

  __device__ __forceinline__ void operator()(
      const float (&P1)[kCap], const float (&P2)[kCap], float* plane, int j,
      int g0, int G, int nr, const MarchParams& p) const {
    const int RM = p.RM, RP = p.RP, P = RM | 1, PP = RP * RP;
    #pragma unroll
    for (int c = 0; c < kCap; ++c) {
      if (c < nr) {
        plane[j * P + g0 + c * G] = P2[c];
        if (LIT) p1[j * P + g0 + c * G] = P1[c];
      }
    }
    float a[3], lc[3], am[3];
    #pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      a[ch] = alb[ch];
      lc[ch] = lightf[ch];
      am[ch] = lightf[3 + ch];
    }
    __syncthreads();
    const float* P1s = LIT ? p1 : plane;
    if (RM == RP) {
      for (int e = threadIdx.x; e < PP; e += blockDim.x) {
        const int at = (e / RP) * P + e % RP;
        put(e, PP, P1s[at], plane[at], a, lc, am);
      }
      return;
    }
    float* t1 = t2 + band * RM;
    for (int i0 = 0; i0 < RP; i0 += band) {
      const int nb = min(band, RP - i0);
      // y pass, rows i0 + r: t[r, m] = rnd(wy0 * rnd(P[k0, m]) +
      // wy1 * rnd(P[k0 + 1, m]))
      for (int e = threadIdx.x; e < nb * RM; e += blockDim.x) {
        const int r = e / RM, m = e - r * RM;
        int k0;
        float wy0, wy1;
        taps<T>((float)(i0 + r) * p.ratio_m, RM, &k0, &wy0, &wy1);
        t2[e] = up_y<T>(plane, P, RM, k0, wy0, wy1, m);
        if (LIT) t1[e] = up_y<T>(p1, P, RM, k0, wy0, wy1, m);
      }
      __syncthreads();
      // x pass and the RGB expansion, coalesced along x
      for (int e = threadIdx.x; e < nb * RP; e += blockDim.x) {
        const int r = e / RP, x = e - r * RP;
        int m0;
        float wx0, wx1;
        taps<T>((float)x * p.ratio_m, RM, &m0, &wx0, &wx1);
        const bool in1 = m0 + 1 < RM;
        const float* r2 = t2 + r * RM;
        const float v2 = __fadd_rn(__fmul_rn(r2[m0], wx0),
                                   __fmul_rn(in1 ? r2[m0 + 1] : 0.f, wx1));
        float v1 = v2;
        if (LIT) {
          const float* r1 = t1 + r * RM;
          v1 = __fadd_rn(__fmul_rn(r1[m0], wx0),
                         __fmul_rn(in1 ? r1[m0 + 1] : 0.f, wx1));
        }
        put(i0 * RP + e, PP, v1, v2, a, lc, am);
      }
      __syncthreads();
    }
  }
};

template <typename T, int MODE, bool ORTHO, bool STAGED>
__global__ void __launch_bounds__(kMaxBlock)
warp_images_kernel(const T* __restrict__ bank, const T* __restrict__ lbank,
                   const int* __restrict__ vidx,
                   const float* __restrict__ pgeom,
                   const float* __restrict__ rxu,
                   const float* __restrict__ ryw,
                   const float* __restrict__ camf,
                   const float* __restrict__ alb,
                   const float* __restrict__ lightf, T* __restrict__ images,
                   int* __restrict__ clamp_out, MarchParams p,
                   MarchPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool LIT = MODE != kUnlit;
  const int PP = p.RP * p.RP;
  T* img = images + (size_t)blockIdx.x * 4 * PP;
  if (pgeom[(size_t)blockIdx.x * PG_N + PG_VALID] <= 0.f) {
    // invalid: the OVER identity
    for (int e = threadIdx.x; e < 4 * PP; e += blockDim.x)
      img[e] = cvt<T>(e >= 3 * PP ? 1.f : 0.f);
    return;
  }
  float* p1 = reinterpret_cast<float*>(smem);
  const ImagesOut<T, LIT> epi{img, p1,
                              p1 + (LIT ? p.RM * (p.RM | 1) : 0),
                              alb + (size_t)blockIdx.x * 3, lightf, pl.band};
  const int off = max(march_prefix(p, pl.stages, sizeof(T)),
                      images_epi(p, pl.band));
  march_particle<T, MODE, ORTHO, STAGED>(bank, lbank, vidx, pgeom, rxu, ryw,
                                         camf, clamp_out, p, pl, smem, off,
                                         epi);
}

template <typename T, int MODE, bool ORTHO, bool STAGED>
struct LaunchC {
  static int run(const MarchParams& p, const MarchPlan& pl, const void* bank,
                 const void* lbank, const int* vidx, const float* pgeom,
                 const float* rxu, const float* ryw, const float* camf,
                 const float* alb, const float* lightf, void* images,
                 int* clamp_out, cudaStream_t st) {
    auto kern = warp_images_kernel<T, MODE, ORTHO, STAGED>;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
    if (e != cudaSuccess) return (int)e;
    kern<<<p.N, p.RM * pl.G, pl.smem, st>>>(
        (const T*)bank, (const T*)lbank, vidx, pgeom, rxu, ryw, camf, alb,
        lightf, (T*)images, clamp_out, p, pl);
    return (int)cudaGetLastError();
  }
};

extern "C" int warp_images_launch(const void* bank, const void* lbank,
                                  int bank_bf16, const int* vidx,
                                  const float* pgeom, const float* rxu,
                                  const float* ryw, const float* camf,
                                  const float* alb, const float* lightf,
                                  void* images, int* clamp_out, MarchParams p,
                                  MarchPlan pl, void* stream) {
  const int itemsize = bank_bf16 ? 2 : 4;
  const int smem = std::max(march_prefix(p, pl.stages, itemsize),
                            images_epi(p, pl.band)) + march_tail(p);
  const bool band_ok = p.RP >= 1 && (p.RM == p.RP
                                     ? pl.band == 0
                                     : pl.band >= 1 && pl.band <= p.RP);
  if (!march_plan_ok(p, pl, bank, lbank, itemsize, smem) || !band_ok)
    return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  return march_dispatch<LaunchC>(bank_bf16, p, pl, bank,
                                 p.lit ? lbank : nullptr, vidx, pgeom, rxu,
                                 ryw, camf, alb, lightf, images, clamp_out,
                                 (cudaStream_t)stream);
}
