// warp_images: the unfused warp march, for Hopper (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas in unfused mode
// (warp_fused=False, the pallas_call that writes per-particle image blocks),
// under a perspective or an orthographic camera (march_fan_exp's ORTHO
// instantiation)
// -- per particle: the march, the fan shift and the exps at march resolution
// (the same device code as the fused path's kernel A, march_fan_exp in
// warp_common.cuh), then its epilogue: the RM -> RP hat upsample of the
// planes (plane rounded to the working type, y pass summed in fp32 and
// rounded to the working type, x pass summed in fp32; identity when
// RM == RP) and the RGB expansion
//   img[ch] = wdt(alb_ch * (lcol_ch * P1 + amb_ch * P2)),  img[3] = wdt(1 - P2)
// into images [N, 4, RP, RP] in the working type, plus the shift-clamp
// count.  Unlit (P1 == P2), center-lit and per-step lit (the march's
// lighting modes, warp_common.cuh).  The composite is kernel D
// (composite_chunk.cu).
//
// Design.  One block per particle, in whatever order the caller marches
// them (the composite fixes the depth order).  The march-resolution planes
// P1, P2 land in shared memory; the upsample's two matmuls have two
// non-zeros per weight row, so they become 2-tap sums: a y pass into a
// [RP, RM] shared buffer per plane, then the x pass fused with the RGB
// expansion and the store, coalesced along x.  Invalid particles write the
// OVER identity (C = 0, T = 1).
//
// Bound on this card: bytes -- the N * 4 * RP^2 image write dominates (c4:
// 2048 x 4 x 96 x 96 bf16 = 151 MB per megachunk); the slab stacks of a
// shared bank come from L2.
//
// Built with --fmad=false (the reference rounds every product before its
// add).

#include "warp_common.cuh"

// march-resolution planes into shared memory
struct SmemSink {
  float* P1s;
  float* P2s;
  __device__ __forceinline__ void operator()(int r, float P1, float P2) const {
    P2s[r] = P2;
    if (P1s != P2s) P1s[r] = P1;
  }
};

template <typename T, int MODE, bool ORTHO>
__global__ void __launch_bounds__(kMarchThreads)
warp_images_kernel(const T* __restrict__ bank, const T* __restrict__ lbank,
                   const int* __restrict__ vidx,
                   const float* __restrict__ pgeom,
                   const float* __restrict__ rxu,
                   const float* __restrict__ ryw,
                   const float* __restrict__ camf,
                   const float* __restrict__ alb,
                   const float* __restrict__ lightf, T* __restrict__ images,
                   int* __restrict__ clamp_out, MarchParams p) {
  extern __shared__ float sm[];
  __shared__ int blk_clamp;
  const int n = blockIdx.x;
  const int RM = p.RM, RP = p.RP, RR = RM * RM, PP = RP * RP;
  constexpr bool LIT = MODE != kUnlit;
  constexpr int NPL = LIT ? 2 : 1;
  float* plane = sm;                       // [RM, RM] fan scratch
  float* P2s = sm + RR;                    // [RM, RM]
  float* P1s = LIT ? sm + 2 * RR : P2s;    // [RM, RM]
  float* t2 = sm + (1 + NPL) * RR;         // [RP, RM] y-pass of P2
  float* t1 = LIT ? t2 + RP * RM : t2;     // [RP, RM] y-pass of P1
  T* img = images + (size_t)n * 4 * PP;
  if (pgeom[(size_t)n * PG_N + PG_VALID] <= 0.f) {   // OVER identity
    for (int e = threadIdx.x; e < 4 * PP; e += blockDim.x)
      img[e] = cvt<T>(e >= 3 * PP ? 1.f : 0.f);
    return;
  }
  march_fan_exp<T, MODE, ORTHO>(bank, lbank, vidx, pgeom, rxu, ryw, camf, p,
                                n, plane, &blk_clamp, SmemSink{P1s, P2s});
  __syncthreads();
  if (threadIdx.x == 0 && blk_clamp) atomicAdd(clamp_out, blk_clamp);

  const bool up = RM != RP;
  if (up) {
    // y pass: t[i, m] = rnd(wy0 * rnd(P[k0, m]) + wy1 * rnd(P[k0 + 1, m]))
    for (int e = threadIdx.x; e < RP * RM; e += blockDim.x) {
      const int i = e / RM, m = e - (e / RM) * RM;
      int k0;
      float wy0, wy1;
      taps<T>((float)i * p.ratio_m, RM, &k0, &wy0, &wy1);
      t2[e] = up_y<T>(P2s, RM, k0, wy0, wy1, m);
      if (LIT) t1[e] = up_y<T>(P1s, RM, k0, wy0, wy1, m);
    }
    __syncthreads();
  }

  float a[3], lc[3], am[3];
  #pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    a[ch] = alb[(size_t)n * 3 + ch];
    lc[ch] = lightf[ch];
    am[ch] = lightf[3 + ch];
  }
  for (int e = threadIdx.x; e < PP; e += blockDim.x) {
    float P1, P2;
    if (up) {
      const int i = e / RP, j = e - (e / RP) * RP;
      int m0;
      float wx0, wx1;
      taps<T>((float)j * p.ratio_m, RM, &m0, &wx0, &wx1);
      const bool in1 = m0 + 1 < RM;
      const float* r2 = t2 + i * RM;
      P2 = __fadd_rn(__fmul_rn(r2[m0], wx0),
                     __fmul_rn(in1 ? r2[m0 + 1] : 0.f, wx1));
      if (LIT) {
        const float* r1 = t1 + i * RM;
        P1 = __fadd_rn(__fmul_rn(r1[m0], wx0),
                       __fmul_rn(in1 ? r1[m0 + 1] : 0.f, wx1));
      } else {
        P1 = P2;
      }
    } else {
      P2 = P2s[e];
      P1 = P1s[e];
    }
    #pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      img[ch * PP + e] = cvt<T>(__fmul_rn(
          a[ch], __fadd_rn(__fmul_rn(lc[ch], P1), __fmul_rn(am[ch], P2))));
    img[3 * PP + e] = cvt<T>(__fsub_rn(1.f, P2));
  }
}

static size_t images_smem(const MarchParams& p) {
  const int npl = p.lit ? 2 : 1;
  return ((size_t)(1 + npl) * p.RM * p.RM
          + (p.RM != p.RP ? (size_t)npl * p.RP * p.RM : 0)) * sizeof(float);
}

template <typename T, int MODE, bool ORTHO>
static int launch_io(const void* bank, const void* lbank, const int* vidx,
                    const float* pgeom, const float* rxu, const float* ryw,
                    const float* camf, const float* alb, const float* lightf,
                    void* images, int* clamp_out, MarchParams p,
                    cudaStream_t st) {
  const size_t smem = images_smem(p);
  cudaError_t e = cudaFuncSetAttribute(
      warp_images_kernel<T, MODE, ORTHO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  warp_images_kernel<T, MODE, ORTHO><<<p.N, kMarchThreads, smem, st>>>(
      (const T*)bank, (const T*)lbank, vidx, pgeom, rxu, ryw, camf, alb,
      lightf, (T*)images, clamp_out, p);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
static int launch_i(const void* bank, const void* lbank, const int* vidx,
                    const float* pgeom, const float* rxu, const float* ryw,
                    const float* camf, const float* alb, const float* lightf,
                    void* images, int* clamp_out, MarchParams p,
                    cudaStream_t st) {
  if (p.ortho)
    return launch_io<T, MODE, true>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                    alb, lightf, images, clamp_out, p, st);
  return launch_io<T, MODE, false>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                   alb, lightf, images, clamp_out, p, st);
}

template <typename T>
static int launch_t(const void* bank, const void* lbank, const int* vidx,
                    const float* pgeom, const float* rxu, const float* ryw,
                    const float* camf, const float* alb, const float* lightf,
                    void* images, int* clamp_out, MarchParams p,
                    cudaStream_t st) {
  if (p.lit == kPerStep)
    return launch_i<T, kPerStep>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                 alb, lightf, images, clamp_out, p, st);
  if (p.lit == kCenter)
    return launch_i<T, kCenter>(bank, lbank, vidx, pgeom, rxu, ryw, camf, alb,
                                lightf, images, clamp_out, p, st);
  return launch_i<T, kUnlit>(bank, nullptr, vidx, pgeom, rxu, ryw, camf, alb,
                             lightf, images, clamp_out, p, st);
}

extern "C" int warp_images_launch(const void* bank, const void* lbank,
                                  int bank_bf16, const int* vidx,
                                  const float* pgeom, const float* rxu,
                                  const float* ryw, const float* camf,
                                  const float* alb, const float* lightf,
                                  void* images, int* clamp_out, MarchParams p,
                                  void* stream) {
  if (p.RM * p.RM > kMarchThreads * kMaxPerThread || (p.lit && !lbank) ||
      p.lit < kUnlit || p.lit > kPerStep || images_smem(p) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (bank_bf16)
    return launch_t<__nv_bfloat16>(bank, lbank, vidx, pgeom, rxu, ryw, camf,
                                   alb, lightf, images, clamp_out, p, st);
  return launch_t<float>(bank, lbank, vidx, pgeom, rxu, ryw, camf, alb,
                         lightf, images, clamp_out, p, st);
}
