// warp_common.cuh: device code shared by the warp engine's kernels for
// Hopper (sm_90a): the march's parameters, the closed-form fan shift and
// the ray helpers of volq/render/kernel.py:march_warp_pallas (march.cuh,
// which kernels A and C run), and the rounding / hat-tap helpers the
// composite kernels use too.
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
// recurrence); RP / ratio_m: the rect the unfused path upsamples to; ortho:
// an orthographic camera (the launch picks the ORTHO instantiation).
struct MarchParams {
  int N, S, VX, V, RM, row_fan, lit, mid, RP, ortho;
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

// rnd(wy0 * rnd(P[k0, m]) + wy1 * rnd(P[k0 + 1, m])) over a plane P whose
// rows are rs apart: one element of the y pass of the hat upsample /
// placement (rows and columns outside the plane contribute 0: their hat
// weight is 0, and they are not read)
template <typename PT>
__device__ __forceinline__ float up_y(const float* P, int rs, int RM, int k0,
                                      float wy0, float wy1, int m) {
  float s = 0.f;
  if (m >= 0 && m < RM) {
    const int at = k0 * rs + m;
    if (k0 >= 0 && k0 < RM) s = __fmul_rn(wy0, rnd<PT>(P[at]));
    if (k0 + 1 >= 0 && k0 + 1 < RM)
      s = __fadd_rn(s, __fmul_rn(wy1, rnd<PT>(P[at + rs])));
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

// The orthographic ray slopes kx = fwd_x / fz_s, ky = fwd_y / fz_s, with
// fz_s = fwd_z kept at least 1e-6 (the reference's _EPS) away from 0.
struct OrthoSlopes {
  float fz_s, kx, ky;
  __device__ __forceinline__ explicit OrthoSlopes(const float* camf) {
    const float fz = camf[11];
    fz_s = fabsf(fz) < 1e-6f ? (fz >= 0.f ? 1e-6f : -1e-6f) : fz;
    kx = camf[9] / fz_s;
    ky = camf[10] / fz_s;
  }
};

// The closed-form fan shift of one particle (render/warp.fan_shifts) at
// march resolution: the column shift du(j, i) and, for yawed / rolled
// cameras, the row shift dw(j, i), clamped to +-Kc cells and to the plane.
// Perspective: the rational form; orthographic (ORTHO): rx is affine in the
// pixel, so du = doy_j * Bx / (dox_step * Ax) is constant along a row and
// dw = dox_i * Ay / (doy_step * By) along a column.
template <bool ORTHO>
struct Fan {
  float sx0, sy0, pxc, pyc, rxc, ryc, rzc, uxc, uyc, uzc, fwd_x, fwd_y, fwd_z,
      sxs, sys, dox_step, doy_step, dyk, dxk, Ax, Bx, Ay, By;
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
    if constexpr (ORTHO) {
      const OrthoSlopes o(camf);
      Ax = rxc - rzc * o.kx;
      Bx = uxc - uzc * o.kx;
      Ay = ryc - rzc * o.ky;
      By = uyc - uzc * o.ky;
    }
  }
  // column shift of ray (j, i); *clamped counts a shift the +-Kc clamp cut
  __device__ __forceinline__ float du(int j, int i, const MarchParams& p,
                                      int* clamped) const {
    const float iv = (float)i * p.ratio, jv = (float)j * p.ratio;
    const float doy_j = (pyc - (sy0 + jv + 0.5f)) * dyk;
    float d;
    if constexpr (ORTHO) {
      d = safe_div(doy_j * Bx, dox_step * Ax);
    } else {
      const float ox_i = ((sx0 + iv + 0.5f) * p.two_over_W - 1.f) * sxs;
      const float oy_c = (1.f - pyc * p.two_over_H) * sys;
      const float D_ic = fwd_z + ox_i * rzc + oy_c * uzc;
      const float Nx_ic = fwd_x + ox_i * rxc + oy_c * uxc;
      const float Fy_i = uxc * D_ic - Nx_ic * uzc;
      const float Gx_i = rxc * D_ic - Nx_ic * rzc;
      const float D_ip1 = D_ic + dox_step * rzc;
      const float D_ij = D_ic + doy_j * uzc;
      const float A_i = safe_div(Fy_i * D_ip1, dox_step * Gx_i);
      d = safe_div(doy_j * A_i, D_ij);
    }
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
    float d;
    if constexpr (ORTHO) {
      d = safe_div(dox_i * Ay, doy_step * By);
    } else {
      const float oy_j = (1.f - (sy0 + jv + 0.5f) * p.two_over_H) * sys;
      const float ox_c = (pxc * p.two_over_W - 1.f) * sxs;
      const float D_cj = fwd_z + oy_j * uzc + ox_c * rzc;
      const float Ny_cj = fwd_y + oy_j * uyc + ox_c * ryc;
      const float Fx_j = ryc * D_cj - Ny_cj * rzc;
      const float Gy_j = uyc * D_cj - Ny_cj * uzc;
      const float D_jp1 = D_cj + doy_step * uzc;
      const float D_ij2 = D_cj + dox_i * rzc;
      const float B_j = safe_div(Fx_j * D_jp1, doy_step * Gy_j);
      d = safe_div(dox_i * B_j, D_ij2);
    }
    *clamped += (d < -p.Kc) | (d > p.Kc_hi);
    d = fminf(fmaxf(d, -p.Kc), p.Kc_hi);
    d = fmaxf(d, -(float)j);
    return fminf(d, p.rm_hi - (float)j);
  }
};
