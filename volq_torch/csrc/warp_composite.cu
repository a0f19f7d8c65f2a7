// warp_composite: the composite half of the fused warp kernel, for Hopper
// (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas (fused mode, unlit,
// unpaired) -- its epilogue's placement and canvas read-modify-write: the
// hat upsample of each particle's march-resolution P2 plane straight into
// canvas coordinates (Uyp, rounded to the working type, then Uxp) and the
// front-to-back OVER  T2 = Tw*P2; C_ch += cc_ch*T2; T = Tw - T2, rounded to
// the canvas type after every particle, in depth order.
//
// Design.  The TPU ran one sequential grid over the depth-ordered particles
// and carried each particle's canvas window through double-buffered DMAs
// with hazard flags.  GPU blocks run in no order, so the order moves inside
// the block: one block per 16 x 64 canvas tile, the tile held in registers
// for the whole walk, and the block walks the depth-ordered particle list
// in order, skipping particles whose RP x RP rect misses the tile (warp 0
// compacts each chunk of the list with ballots, keeping the order).  Each
// canvas pixel is read once and written once, and per-pixel depth order is
// exact.  Pixels of a rect outside the particle's footprint get P2 = 0,
// the OVER identity, exactly as the TPU window ring did.  Each Uyp/Uxp row
// has two non-zeros, so the two matmuls become 2 x 2-tap sums per pixel,
// with the reference's rounding points (the Uyp sum is rounded to the
// placement type before the Uxp sum).
//
// Bound on this card: bytes (canvas read + write, P2m read once: ~80 MB
// per c3 frame).  P2m is re-read per covering tile from L2.
//
// Built with --fmad=false; the RMW spells its roundings out with
// __fmul_rn / __fadd_rn as well, so the canvas is bit-equal to the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

struct CompositeParams {
  int N, RM, RP, Hc, Wc;
  float ratio_m;   // f32(RM - 1) / f32(RP - 1)
};

template <typename T> __device__ __forceinline__ float ldf(const T* p);
template <> __device__ __forceinline__ float ldf<float>(const float* p) {
  return *p;
}
template <> __device__ __forceinline__ float ldf<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <typename T> __device__ __forceinline__ T cvt(float x);
template <> __device__ __forceinline__ float cvt<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 cvt<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}

// the two hat taps of position g on [0, n): floor(g) and floor(g) + 1
template <typename PT>
__device__ __forceinline__ void taps(float g, int n, int* k0, float* w0,
                                     float* w1) {
  const int k = (int)floorf(g);
  *k0 = k;
  *w0 = (k >= 0 && k < n) ? rnd<PT>(fmaxf(0.f, 1.f - fabsf(g - (float)k)))
                          : 0.f;
  *w1 = (k + 1 >= 0 && k + 1 < n)
            ? rnd<PT>(fmaxf(0.f, 1.f - fabsf(g - (float)(k + 1))))
            : 0.f;
}

constexpr int kTileW = 64, kTileH = 16, kRowsPerThread = 4;
constexpr int kChunk = 1024;

template <typename CT, typename PT>
__global__ void __launch_bounds__(kTileW * (kTileH / kRowsPerThread))
warp_composite_kernel(CT* __restrict__ canvas, const float* __restrict__ p2m,
                      const float* __restrict__ ayf,
                      const float* __restrict__ axf,
                      const float* __restrict__ cc,
                      const int* __restrict__ valid, CompositeParams p) {
  __shared__ int list[kChunk];
  __shared__ int list_n;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int X = blockIdx.x * kTileW + tx;
  const int Ybase = blockIdx.y * kTileH + ty * kRowsPerThread;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const size_t plane = (size_t)p.Hc * p.Wc;
  const bool colin = X < p.Wc;

  float C[kRowsPerThread][3], T[kRowsPerThread];
  #pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int Y = Ybase + r;
    const bool in = colin && Y < p.Hc;
    const size_t o = (size_t)Y * p.Wc + X;
    #pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      C[r][ch] = in ? ldf<CT>(canvas + ch * plane + o) : 0.f;
    T[r] = in ? ldf<CT>(canvas + 3 * plane + o) : 1.f;
  }

  const int RP = p.RP, RM = p.RM;
  const int lane = threadIdx.x & 31;
  const bool warp0 = ty == 0 && tx < 32;
  for (int base = 0; base < p.N; base += kChunk) {
    // ordered compaction of the particles whose rect meets this tile
    if (warp0) {
      int cnt = 0;
      for (int kb = base; kb < min(base + kChunk, p.N); kb += 32) {
        const int k = kb + lane;
        bool hit = false;
        if (k < p.N && valid[k]) {
          const int y0 = (int)ayf[k], x0 = (int)axf[k];
          hit = y0 < ty0 + kTileH && y0 + RP > ty0 &&
                x0 < tx0 + kTileW && x0 + RP > tx0;
        }
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (hit) list[cnt + __popc(m & ((1u << lane) - 1u))] = k;
        cnt += __popc(m);
      }
      if (lane == 0) list_n = cnt;
    }
    __syncthreads();
    const int cnt = list_n;
    for (int q = 0; q < cnt; ++q) {
      const int k = list[q];
      const int x0 = (int)axf[k];
      const int xo = X - x0;
      if (!colin || xo < 0 || xo >= RP) continue;
      const int y0 = (int)ayf[k];
      const float* P = p2m + (size_t)k * RM * RM;
      int m0;
      float wx0, wx1;
      taps<PT>((float)xo * p.ratio_m, RM, &m0, &wx0, &wx1);
      const float cc0 = cc[3 * k], cc1 = cc[3 * k + 1], cc2 = cc[3 * k + 2];
      #pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int yo = Ybase + r - y0;
        if (yo < 0 || yo >= RP || Ybase + r >= p.Hc) continue;
        int k0;
        float wy0, wy1;
        taps<PT>((float)yo * p.ratio_m, RM, &k0, &wy0, &wy1);
        // t[m] = rnd(wy0 * P[k0, m] + wy1 * P[k0+1, m]) for m = m0, m0+1
        float t[2];
        #pragma unroll
        for (int dm = 0; dm < 2; ++dm) {
          const int m = m0 + dm;    // m0, k0 >= 0: xo, yo >= 0
          float s = 0.f;
          if (m < RM) {
            if (k0 < RM) s = __fmul_rn(wy0, rnd<PT>(P[k0 * RM + m]));
            if (k0 + 1 < RM)
              s = __fadd_rn(s, __fmul_rn(wy1, rnd<PT>(P[(k0 + 1) * RM + m])));
          }
          t[dm] = rnd<PT>(s);
        }
        const float placed = __fadd_rn(__fmul_rn(t[0], wx0),
                                       __fmul_rn(t[1], wx1));
        const float Tw = T[r];
        const float T2 = __fmul_rn(Tw, placed);
        C[r][0] = rnd<CT>(__fadd_rn(C[r][0], __fmul_rn(cc0, T2)));
        C[r][1] = rnd<CT>(__fadd_rn(C[r][1], __fmul_rn(cc1, T2)));
        C[r][2] = rnd<CT>(__fadd_rn(C[r][2], __fmul_rn(cc2, T2)));
        T[r] = rnd<CT>(__fsub_rn(Tw, T2));
      }
    }
    __syncthreads();
  }

  #pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int Y = Ybase + r;
    if (!colin || Y >= p.Hc) continue;
    const size_t o = (size_t)Y * p.Wc + X;
    #pragma unroll
    for (int ch = 0; ch < 3; ++ch) canvas[ch * plane + o] = cvt<CT>(C[r][ch]);
    canvas[3 * plane + o] = cvt<CT>(T[r]);
  }
}

template <typename CT>
static void launch_c(void* canvas, const float* p2m, int place_bf16,
                     const float* ayf, const float* axf, const float* cc,
                     const int* valid, CompositeParams p, cudaStream_t st) {
  dim3 block(kTileW, kTileH / kRowsPerThread);
  dim3 grid((p.Wc + kTileW - 1) / kTileW, (p.Hc + kTileH - 1) / kTileH);
  if (place_bf16)
    warp_composite_kernel<CT, __nv_bfloat16><<<grid, block, 0, st>>>(
        (CT*)canvas, p2m, ayf, axf, cc, valid, p);
  else
    warp_composite_kernel<CT, float><<<grid, block, 0, st>>>(
        (CT*)canvas, p2m, ayf, axf, cc, valid, p);
}

extern "C" int warp_composite_launch(void* canvas, int canvas_bf16,
                                     const float* p2m, int place_bf16,
                                     const float* ayf, const float* axf,
                                     const float* cc, const int* valid,
                                     CompositeParams p, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (canvas_bf16)
    launch_c<__nv_bfloat16>(canvas, p2m, place_bf16, ayf, axf, cc, valid, p,
                            st);
  else
    launch_c<float>(canvas, p2m, place_bf16, ayf, axf, cc, valid, p, st);
  return (int)cudaGetLastError();
}
