// warp_march: the march half of the fused warp kernel, for Hopper (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas (fused mode, unlit,
// unpaired, slab banks) -- the per-particle part of its grid step: the
// ray/AABB `scale*dt` (_init_one), the telescoped optical depth
// od = sum_s (Wy_s . slab_s) . WxT_s, the fan shift at march resolution and
// P2 = 1 - exp(-od*geo).  The TPU kernel then upsampled and composited in the
// same grid step; here that is kernel B (warp_composite.cu), because GPU
// blocks run in no order and OVER needs depth order per pixel.
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
// goes through shared memory (RM*RM fp32).
//
// Bound on this card: bytes.  The slab bank [M, S, VX, V] is the only large
// input (c3: 1024 x 20 x 64 x 128 bf16 = 335 MB/frame); each particle's
// stack is read once from HBM into L2/L1, then gathered from cache.  The
// first version keeps the gathers simple (no TMA, no shared-memory staging of
// the stack); PERF.md holds its time against the bound.
//
// Built with --fmad=false: the reference rounds every product before its add,
// and contraction into FMA would change the fp32 results.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

struct MarchParams {
  int N, S, VX, V, RM, row_fan;
  float gsc, gscx, Sf, ratio, Kc, Kc_hi, rm_hi, W, H, two_over_W, two_over_H;
};

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

constexpr int kThreads = 256;
constexpr int kMaxPerThread = 32;   // RM * RM <= 8192

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_march_kernel(const T* __restrict__ bank, const int* __restrict__ vidx,
                  const float* __restrict__ pgeom,
                  const float* __restrict__ rxu, const float* __restrict__ ryw,
                  const float* __restrict__ camf, float* __restrict__ p2m,
                  int* __restrict__ clamp_out, MarchParams p) {
  extern __shared__ float plane[];      // [RM, RM]
  __shared__ int blk_clamp;
  const int n = blockIdx.x;
  const int RM = p.RM, RR = RM * RM;
  const float* g = pgeom + (size_t)n * PG_N;
  float* out = p2m + (size_t)n * RR;
  if (g[PG_VALID] <= 0.f) {             // invalid: P2 = 0 (OVER identity)
    for (int r = threadIdx.x; r < RR; r += blockDim.x) out[r] = 0.f;
    return;
  }
  if (threadIdx.x == 0) blk_clamp = 0;

  const float lo_x = g[PG_LOX], lo_y = g[PG_LOY], lo_z = g[PG_LOZ];
  const float ext = g[PG_EXT], scale = g[PG_SCALE], szn = g[PG_SZN];
  const float eye_x = camf[0], eye_y = camf[1], eye_z = camf[2];
  const size_t slab_elems = (size_t)p.VX * p.V;
  const T* stack = bank + (size_t)vidx[n] * p.S * slab_elems;
  const float kx2 = p.gscx / ext, ky2 = p.gsc / ext;
  const float bx_h = (eye_x - lo_x) * kx2, by_h = (eye_y - lo_y) * ky2;
  const float hi_x = lo_x + ext, hi_y = lo_y + ext, hi_z = lo_z + ext;

  // ---- march: q = od * geo per ray -> plane
  for (int r = threadIdx.x; r < RR; r += blockDim.x) {
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

    float od = 0.f;
    for (int s = 0; s < p.S; ++s) {
      const float zeta = ((float)s + 0.5f) / p.Sf;
      const float zw = lo_z + zeta * ext;
      const float c1 = zw - eye_z;
      const float gx = bx_h + (c1 * kx2) * rx;
      const float gy = by_h + (c1 * ky2) * ry;
      const bool tpos = (zw - eye_z) * szn > 0.f;
      if (!(gy >= 0.f && gy <= p.gsc && tpos)) continue;   // row masked
      if (!(gx >= 0.f && gx <= p.gscx)) continue;          // column masked
      const int b0 = (int)floorf(gy), a0 = (int)floorf(gx);
      const float wy0 = hat<T>(gy, b0, p.V), wy1 = hat<T>(gy, b0 + 1, p.V);
      const float wx0 = hat<T>(gx, a0, p.VX);
      const float wx1 = hat<T>(gx, a0 + 1, p.VX);
      const T* slab = stack + (size_t)s * slab_elems;
      #pragma unroll
      for (int da = 0; da < 2; ++da) {
        const int a = a0 + da;
        if (a >= p.VX) break;
        const T* row = slab + (size_t)a * p.V;
        float t1v = wy0 * ldf<T>(row + b0);
        if (b0 + 1 < p.V) t1v = t1v + wy1 * ldf<T>(row + b0 + 1);
        t1v = rnd<T>(t1v);
        od = od + t1v * (da ? wx1 : wx0);
      }
    }
    plane[r] = od * geo;
  }
  __syncthreads();

  // ---- fan shift, column pass (closed-form du of render/warp.fan_shifts)
  const float sx0 = g[PG_SX0], sy0 = g[PG_SY0], pxc = g[PG_PXC],
              pyc = g[PG_PYC];
  const float rxc = camf[3], ryc = camf[4], rzc = camf[5];
  const float uxc = camf[6], uyc = camf[7], uzc = camf[8];
  const float fwd_x = camf[9], fwd_y = camf[10], fwd_z = camf[11];
  const float sxs = camf[12], sys = camf[13];
  const float dox_step = 2.f * sxs / p.W * p.ratio;
  const float doy_step = -2.f * sys / p.H * p.ratio;
  const float dyk = 2.f * sys / p.H, dxk = 2.f * sxs / p.W;
  int my_clamp = 0;
  float vals[kMaxPerThread];
  int c = 0;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) {
    const int j = r / RM, i = r - (r / RM) * RM;
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
    float du = safe_div(doy_j * A_i, D_ij);
    my_clamp += (du < -p.Kc) | (du > p.Kc_hi);
    du = fminf(fmaxf(du, -p.Kc), p.Kc_hi);
    du = fmaxf(du, -(float)i);
    du = fminf(du, p.rm_hi - (float)i);
    const float d0 = floorf(du), fr = du - d0;
    const int ic = i + (int)d0;
    vals[c] = (1.f - fr) * plane[j * RM + ic] + fr * plane[j * RM + ic + 1];
  }
  __syncthreads();
  c = 0;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) plane[r] = vals[c];
  __syncthreads();

  // ---- row pass (yawed/rolled cameras), then P2 = 1 - exp(-q)
  c = 0;
  for (int r = threadIdx.x; r < RR; r += blockDim.x, ++c) {
    const int j = r / RM, i = r - (r / RM) * RM;
    float x = vals[c];
    if (p.row_fan) {
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
      float dw = safe_div(dox_i * B_j, D_ij2);
      my_clamp += (dw < -p.Kc) | (dw > p.Kc_hi);
      dw = fminf(fmaxf(dw, -p.Kc), p.Kc_hi);
      dw = fmaxf(dw, -(float)j);
      dw = fminf(dw, p.rm_hi - (float)j);
      const float d0 = floorf(dw), fr = dw - d0;
      const int jc = j + (int)d0;
      x = (1.f - fr) * plane[jc * RM + i] + fr * plane[(jc + 1) * RM + i];
    }
    out[r] = 1.f - expf(-x);
  }
  if (my_clamp) atomicAdd(&blk_clamp, my_clamp);
  __syncthreads();
  if (threadIdx.x == 0 && blk_clamp) atomicAdd(clamp_out, blk_clamp);
}

extern "C" int warp_march_launch(const void* bank, int bank_bf16,
                                 const int* vidx, const float* pgeom,
                                 const float* rxu, const float* ryw,
                                 const float* camf, float* p2m,
                                 int* clamp_out, MarchParams p,
                                 void* stream) {
  if (p.RM * p.RM > kThreads * kMaxPerThread) return (int)cudaErrorInvalidValue;
  if (p.N == 0) return 0;
  const size_t smem = (size_t)p.RM * p.RM * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (bank_bf16)
    warp_march_kernel<__nv_bfloat16><<<p.N, kThreads, smem, st>>>(
        (const __nv_bfloat16*)bank, vidx, pgeom, rxu, ryw, camf, p2m,
        clamp_out, p);
  else
    warp_march_kernel<float><<<p.N, kThreads, smem, st>>>(
        (const float*)bank, vidx, pgeom, rxu, ryw, camf, p2m, clamp_out, p);
  return (int)cudaGetLastError();
}
