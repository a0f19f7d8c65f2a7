// warp_common.cuh: device code shared by the warp engine's kernels for
// Hopper (sm_90a): the per-particle march + fan + exp (every lighting mode) of
// volq/render/kernel.py:march_warp_pallas, used by warp_march.cu (fused
// path, kernel A) and warp_images.cu (unfused path, kernel C), and the
// rounding / hat-tap helpers the composite kernels use too.
//
// Everything here keeps the reference's rounding points: hat weights
// rounded to the working type, fp32 sums of exact products in the
// matmul's K order, and every translation unit that includes this file
// is built with --fmad=false so no product is contracted into its add.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

// Scalar parameters of the march (mirrors MarchParams in
// volq_torch/render/kernel.py).  lit: kUnlit, kCenter (one light sample at
// step mid) or kPerStep (density and light sampled at every step, OVER
// recurrence); RP / ratio_m: the rect the unfused path upsamples to.
struct MarchParams {
  int N, S, VX, V, RM, row_fan, lit, mid, RP;
  float gsc, gscx, Sf, ratio, Kc, Kc_hi, rm_hi, W, H, two_over_W, two_over_H,
      ratio_m;
};

enum { kUnlit = 0, kCenter = 1, kPerStep = 2 };   // MarchParams.lit

// per-particle geometry columns (volq_torch/render/kernel.py: PG_*)
enum { PG_LOX, PG_LOY, PG_LOZ, PG_EXT, PG_SCALE, PG_SZN, PG_VALID,
       PG_SX0, PG_SY0, PG_PXC, PG_PYC, PG_N };

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

__device__ __forceinline__ float safe_div(float num, float den) {
  float sgn = den >= 0.f ? 1.f : -1.f;
  return num / (sgn * fmaxf(fabsf(den), 1e-12f));
}

// hat weight of integer tap k at position g, 0 outside [0, n)
template <typename T>
__device__ __forceinline__ float hat(float g, int k, int n) {
  if (k < 0 || k >= n) return 0.f;
  return rnd<T>(fmaxf(0.f, 1.f - fabsf(g - (float)k)));
}

// the two hat taps of position g on [0, n): floor(g) and floor(g) + 1
template <typename PT>
__device__ __forceinline__ void taps(float g, int n, int* k0, float* w0,
                                     float* w1) {
  const int k = (int)floorf(g);
  *k0 = k;
  *w0 = hat<PT>(g, k, n);
  *w1 = hat<PT>(g, k + 1, n);
}

// rnd(wy0 * rnd(P[k0, m]) + wy1 * rnd(P[k0 + 1, m])): one element of the
// y pass of the hat upsample / placement (rows and columns outside the
// plane contribute 0: their hat weight is 0)
template <typename PT>
__device__ __forceinline__ float up_y(const float* P, int RM, int k0,
                                      float wy0, float wy1, int m) {
  float s = 0.f;
  if (m >= 0 && m < RM) {
    if (k0 >= 0 && k0 < RM) s = __fmul_rn(wy0, rnd<PT>(P[k0 * RM + m]));
    if (k0 + 1 >= 0 && k0 + 1 < RM)
      s = __fadd_rn(s, __fmul_rn(wy1, rnd<PT>(P[(k0 + 1) * RM + m])));
  }
  return rnd<PT>(s);
}

__device__ __forceinline__ void axis_seg(float o, float d, float lo, float hi,
                                         float* t0, float* t1) {
  float sgn = d >= 0.f ? 1.f : -1.f;
  float dsafe = fabsf(d) < 1e-12f ? sgn * 1e-12f : d;
  float inv = 1.f / dsafe;
  float ta = (lo - o) * inv;
  float tb = (hi - o) * inv;
  *t0 = fminf(ta, tb);
  *t1 = fmaxf(ta, tb);
}

constexpr int kMarchThreads = 256;
constexpr int kMaxPerThread = 32;   // RM * RM <= 8192

// One slab sample of ray (gx, gy): sum over the two x taps of
// rnd(wy0 * slab[a, b0] + wy1 * slab[a, b0 + 1]) * wx.
template <typename T>
__device__ __forceinline__ float slab_sample(const T* slab, int VX, int V,
                                             int a0, int b0, float wy0,
                                             float wy1, float wx0, float wx1,
                                             float acc) {
  #pragma unroll
  for (int da = 0; da < 2; ++da) {
    const int a = a0 + da;
    if (a >= VX) break;
    const T* row = slab + (size_t)a * V;
    float t1v = wy0 * ldf<T>(row + b0);
    if (b0 + 1 < V) t1v = t1v + wy1 * ldf<T>(row + b0 + 1);
    t1v = rnd<T>(t1v);
    acc = acc + t1v * (da ? wx1 : wx0);
  }
  return acc;
}

// The closed-form fan shift of one particle (render/warp.fan_shifts) at
// march resolution: the column shift du(j, i) and, for yawed / rolled
// cameras, the row shift dw(j, i), clamped to +-Kc cells and to the plane.
struct Fan {
  float sx0, sy0, pxc, pyc, rxc, ryc, rzc, uxc, uyc, uzc, fwd_x, fwd_y, fwd_z,
      sxs, sys, dox_step, doy_step, dyk, dxk;
  __device__ __forceinline__ Fan(const float* g, const float* camf,
                                 const MarchParams& p) {
    sx0 = g[PG_SX0]; sy0 = g[PG_SY0]; pxc = g[PG_PXC]; pyc = g[PG_PYC];
    rxc = camf[3]; ryc = camf[4]; rzc = camf[5];
    uxc = camf[6]; uyc = camf[7]; uzc = camf[8];
    fwd_x = camf[9]; fwd_y = camf[10]; fwd_z = camf[11];
    sxs = camf[12]; sys = camf[13];
    dox_step = 2.f * sxs / p.W * p.ratio;
    doy_step = -2.f * sys / p.H * p.ratio;
    dyk = 2.f * sys / p.H;
    dxk = 2.f * sxs / p.W;
  }
  // column shift of ray (j, i); *clamped counts a shift the +-Kc clamp cut
  __device__ __forceinline__ float du(int j, int i, const MarchParams& p,
                                      int* clamped) const {
    const float iv = (float)i * p.ratio, jv = (float)j * p.ratio;
    const float doy_j = (pyc - (sy0 + jv + 0.5f)) * dyk;
    const float ox_i = ((sx0 + iv + 0.5f) * p.two_over_W - 1.f) * sxs;
    const float oy_c = (1.f - pyc * p.two_over_H) * sys;
    const float D_ic = fwd_z + ox_i * rzc + oy_c * uzc;
    const float Nx_ic = fwd_x + ox_i * rxc + oy_c * uxc;
    const float Fy_i = uxc * D_ic - Nx_ic * uzc;
    const float Gx_i = rxc * D_ic - Nx_ic * rzc;
    const float D_ip1 = D_ic + dox_step * rzc;
    const float D_ij = D_ic + doy_j * uzc;
    const float A_i = safe_div(Fy_i * D_ip1, dox_step * Gx_i);
    float d = safe_div(doy_j * A_i, D_ij);
    *clamped += (d < -p.Kc) | (d > p.Kc_hi);
    d = fminf(fmaxf(d, -p.Kc), p.Kc_hi);
    d = fmaxf(d, -(float)i);
    return fminf(d, p.rm_hi - (float)i);
  }
  // row shift of ray (j, i)
  __device__ __forceinline__ float dw(int j, int i, const MarchParams& p,
                                      int* clamped) const {
    const float iv = (float)i * p.ratio, jv = (float)j * p.ratio;
    const float dox_i = ((sx0 + iv + 0.5f) - pxc) * dxk;
    const float oy_j = (1.f - (sy0 + jv + 0.5f) * p.two_over_H) * sys;
    const float ox_c = (pxc * p.two_over_W - 1.f) * sxs;
    const float D_cj = fwd_z + oy_j * uzc + ox_c * rzc;
    const float Ny_cj = fwd_y + oy_j * uyc + ox_c * ryc;
    const float Fx_j = ryc * D_cj - Ny_cj * rzc;
    const float Gy_j = uyc * D_cj - Ny_cj * uzc;
    const float D_jp1 = D_cj + doy_step * uzc;
    const float D_ij2 = D_cj + dox_i * rzc;
    const float B_j = safe_div(Fx_j * D_jp1, doy_step * Gy_j);
    float d = safe_div(dox_i * B_j, D_ij2);
    *clamped += (d < -p.Kc) | (d > p.Kc_hi);
    d = fminf(fmaxf(d, -p.Kc), p.Kc_hi);
    d = fmaxf(d, -(float)j);
    return fminf(d, p.rm_hi - (float)j);
  }
};

// The fan shift of one plane held in registers (vals[c] = ray
// threadIdx.x + c * blockDim.x): linear interpolation along the columns at
// i + du, then (row_fan) along the rows at j + dw, each pass through the
// shared ``plane``.  Clamped shifts are added to *my_clamp when it is given
// (once per particle, whatever the number of planes).
__device__ __forceinline__ void fan_shift(float* vals, float* plane,
                                          const Fan& fan,
                                          const MarchParams& p,
                                          int* my_clamp) {
  const int RM = p.RM, RR = RM * RM;
  int c = 0, unused = 0;
  int* cl = my_clamp ? my_clamp : &unused;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) plane[r] = vals[c];
  __syncthreads();
  c = 0;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) {
    const int j = r / RM, i = r - (r / RM) * RM;
    const float du = fan.du(j, i, p, cl);
    const float d0 = floorf(du), fr = du - d0;
    const int ic = i + (int)d0;
    vals[c] = (1.f - fr) * plane[j * RM + ic] + fr * plane[j * RM + ic + 1];
  }
  __syncthreads();
  if (!p.row_fan) return;
  c = 0;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) plane[r] = vals[c];
  __syncthreads();
  c = 0;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) {
    const int j = r / RM, i = r - (r / RM) * RM;
    const float dw = fan.dw(j, i, p, cl);
    const float d0 = floorf(dw), fr = dw - d0;
    const int jc = j + (int)d0;
    vals[c] = (1.f - fr) * plane[jc * RM + i] + fr * plane[(jc + 1) * RM + i];
  }
  __syncthreads();
}

// The per-particle part of march_warp_pallas for one block (= one valid
// particle n): the ray/AABB scale*dt, the march, the fan shift at march
// resolution and the exps.  Each thread hands its rays to
// sink(r, P1, P2) (P1 == P2 when unlit).
//
//   kUnlit:   telescoped optical depth od = sum_s (Wy_s . slab_s) . WxT_s,
//             fan of q = od*geo, P2 = 1 - exp(-q).
//   kCenter:  the same, plus one sample of the light slab at step p.mid with
//             that step's own weights; the tau plane bypasses the fan;
//             P1 = exp(-tau') * P2.
//   kPerStep: at every step both stacks sampled with that step's weights
//             (sig, tau), alpha = 1 - exp(-sig*geo),
//             atten = exp(-(scale*ext) * max(tau, 0)), fa = T*alpha,
//             P1 += fa*atten, T -= fa from (P1, T) = (0, 1); the steps are
//             walked front to back, i.e. descending for particles with
//             szn < 0; P2 = 1 - T, and both planes go through the fan.
//
// Threads over the RM x RM march grid (ray r = (j, i), row j, column i);
// ``plane`` is RM*RM floats of shared memory (the fan reads neighbouring
// columns / rows); ``blk_clamp`` a shared counter the caller adds to the
// global clamp count after a __syncthreads().
template <typename T, int MODE, typename Sink>
__device__ __forceinline__ void march_fan_exp(
    const T* __restrict__ bank, const T* __restrict__ lbank,
    const int* __restrict__ vidx, const float* __restrict__ pgeom,
    const float* __restrict__ rxu, const float* __restrict__ ryw,
    const float* __restrict__ camf, const MarchParams& p, int n, float* plane,
    int* blk_clamp, Sink sink) {
  const int RM = p.RM, RR = RM * RM;
  const float* g = pgeom + (size_t)n * PG_N;
  if (threadIdx.x == 0) *blk_clamp = 0;

  const float lo_x = g[PG_LOX], lo_y = g[PG_LOY], lo_z = g[PG_LOZ];
  const float ext = g[PG_EXT], scale = g[PG_SCALE], szn = g[PG_SZN];
  const float eye_x = camf[0], eye_y = camf[1], eye_z = camf[2];
  const size_t slab_elems = (size_t)p.VX * p.V;
  const T* stack = bank + (size_t)vidx[n] * p.S * slab_elems;
  const T* lstack =
      MODE != kUnlit ? lbank + (size_t)vidx[n] * p.S * slab_elems : nullptr;
  const float kx2 = p.gscx / ext, ky2 = p.gsc / ext;
  const float bx_h = (eye_x - lo_x) * kx2, by_h = (eye_y - lo_y) * ky2;
  const float hi_x = lo_x + ext, hi_y = lo_y + ext, hi_z = lo_z + ext;
  const float se = scale * ext;
  const bool flip = MODE == kPerStep && szn < 0.f;

  // plane 0 and plane 1 of each of this thread's rays, before the fan:
  // (q, tau') telescoped, (P1, P2) per-step lit
  float va[kMaxPerThread];
  float vb[MODE != kUnlit ? kMaxPerThread : 1];
  int c = 0;

  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) {
    const int j = r / RM, i = r - (r / RM) * RM;
    const float rx = rxu[(size_t)n * RM + i], ry = ryw[(size_t)n * RM + j];
    // ray/AABB: geo = scale * min(dt_raw, seg)  (perspective)
    const float rnorm = sqrtf(rx * rx + ry * ry + 1.f);
    const float inv_n = 1.f / rnorm;
    const float d_x = rx * inv_n * szn, d_y = ry * inv_n * szn;
    const float d_z = inv_n * szn;
    const float dt_raw = (ext / p.Sf) * rnorm;
    float t0x, t1x, t0y, t1y, t0z, t1z;
    axis_seg(eye_x, d_x, lo_x, hi_x, &t0x, &t1x);
    axis_seg(eye_y, d_y, lo_y, hi_y, &t0y, &t1y);
    axis_seg(eye_z, d_z, lo_z, hi_z, &t0z, &t1z);
    const float t0 = fmaxf(fmaxf(t0x, t0y), fmaxf(t0z, 0.f));
    const float t1 = fminf(fminf(t1x, t1y), t1z);
    const float seg = fmaxf(t1 - t0, 0.f);
    const float geo = scale * fminf(dt_raw, seg);

    float od = 0.f, tau = 0.f, P1 = 0.f, Tr = 1.f;
    for (int si = 0; si < p.S; ++si) {
      const int s = flip ? p.S - 1 - si : si;
      const float zeta = ((float)s + 0.5f) / p.Sf;
      const float zw = lo_z + zeta * ext;
      const float c1 = zw - eye_z;
      const float gx = bx_h + (c1 * kx2) * rx;
      const float gy = by_h + (c1 * ky2) * ry;
      const bool tpos = (zw - eye_z) * szn > 0.f;
      // a masked row / column has hat position -2: every weight is 0, the
      // sample is +0, and (per-step) alpha = 0 leaves (P1, T) as they are
      if (!(gy >= 0.f && gy <= p.gsc && tpos)) continue;
      if (!(gx >= 0.f && gx <= p.gscx)) continue;
      const int b0 = (int)floorf(gy), a0 = (int)floorf(gx);
      const float wy0 = hat<T>(gy, b0, p.V), wy1 = hat<T>(gy, b0 + 1, p.V);
      const float wx0 = hat<T>(gx, a0, p.VX);
      const float wx1 = hat<T>(gx, a0 + 1, p.VX);
      if (MODE == kPerStep) {
        const float sig = slab_sample<T>(stack + (size_t)s * slab_elems, p.VX,
                                         p.V, a0, b0, wy0, wy1, wx0, wx1, 0.f);
        const float tau_s =
            slab_sample<T>(lstack + (size_t)s * slab_elems, p.VX, p.V, a0, b0,
                           wy0, wy1, wx0, wx1, 0.f);
        const float alpha = 1.f - expf(-sig * geo);
        const float atten = expf(-se * fmaxf(tau_s, 0.f));
        const float fa = Tr * alpha;
        P1 = P1 + fa * atten;
        Tr = Tr - fa;
      } else {
        od = slab_sample<T>(stack + (size_t)s * slab_elems, p.VX, p.V, a0, b0,
                            wy0, wy1, wx0, wx1, od);
        if (MODE == kCenter && s == p.mid)
          tau = slab_sample<T>(lstack + (size_t)s * slab_elems, p.VX, p.V, a0,
                               b0, wy0, wy1, wx0, wx1, 0.f);
      }
    }
    if (MODE == kPerStep) {
      va[c] = P1;
      vb[c] = 1.f - Tr;
    } else {
      va[c] = od * geo;
      if (MODE == kCenter) vb[c] = se * fmaxf(tau, 0.f);
    }
  }

  // ---- fan shift: q (telescoped) or both planes (per-step lit)
  const Fan fan(g, camf, p);
  int my_clamp = 0;
  fan_shift(va, plane, fan, p, &my_clamp);
  if (MODE == kPerStep) fan_shift(vb, plane, fan, p, nullptr);

  // ---- exps
  c = 0;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) {
    if (MODE == kPerStep) {
      sink(r, va[c], vb[c]);
    } else {
      const float P2 = 1.f - expf(-va[c]);
      sink(r, MODE == kCenter ? expf(-vb[c]) * P2 : P2, P2);
    }
  }
  if (my_clamp) atomicAdd(blk_clamp, my_clamp);
}
