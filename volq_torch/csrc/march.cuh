// march.cuh: the step-major march of the warp engine for Hopper (sm_90a),
// one device function that both march kernels run: kernel A
// (warp_march.cu, fused path) stores its finished planes to device memory,
// kernel C (warp_images.cu, unfused path) upsamples them and expands them
// to RGB images.  Each passes its epilogue to march_particle.
//
// What it computes, per particle (volq/render/kernel.py:march_warp_pallas):
// the ray/AABB `scale*dt` (_init_one), the telescoped optical depth od =
// sum_s (Wy_s . slab_s) . WxT_s, center-lit the one light sample at step
// S/2 (_tau_mid), the fan shift at march resolution and the exps
// P2 = 1 - exp(-od*geo), P1 = exp(-tau') * P2; per-step lit
// (light_mode="march") the OVER recurrence over density and light slabs at
// every step, in each particle's own front-to-back step order, with both
// planes (P1, P2 = 1 - T) through the fan.  Perspective or orthographic
// camera (the reference's persp = False branches are the ORTHO
// instantiation: parallel rays along fwd from (rx + eye_z*kx, ry +
// eye_z*ky, eye_z), rx / ry the z = 0 intercepts, dt_raw = ext / S /
// |fz_s|, per step gx = (zw*kx - lo_x)*kx2 + kx2*rx, the constant-ratio
// fan of Fan<true>).
//
// Design.  One block per particle, RM * G threads over its RM x RM march
// grid (ray (j, i), row j, column i): thread t owns row j = t % RM and the
// columns i = t / RM + c * G, at most kCap of them, so every per-ray value
// lives in registers (the loops over c are unrolled).  The march runs
// step-major, as the TPU's did: the block stages step s's slab [VX, V]
// (per-step lit: density and light slab; center-lit: the one light slab,
// once) from device memory into a ring of 2-4 shared-memory stages with
// 16-byte cp.async, keeping the next steps' copies in flight while it
// samples this one, so no tap waits on device memory.  Per step the block
// tabulates each column's x taps and hat weights in shared memory (the
// TPU's WxT), each thread forms its row's y taps once (the TPU's Wy), and
// each ray gathers its 2-4 taps from the staged slab.  Every ray's sum
// keeps the reference's order and rounding points -- hat weights rounded to
// the working type, t1 = fp32 sum of two exact products rounded to the
// working type, od = fp32 sum over steps in the matmul's K order (step,
// then x tap) -- so the planes are bit-equal to the plain version.  Masked
// rows / columns (hat position -2) contribute exact zeros and are skipped.
// The fan shift reads neighbouring columns / rows, so each plane goes
// through a shared [RM, RM | 1] buffer (the odd row stride keeps both
// directions free of bank conflicts); the same buffer holds per-step lit's
// per-ray geo and center-lit's tau during the march.
//
// Shared memory, in bytes from the start: the ring [stages][stage] and
// center-lit's light slab (staged arm only), the column tables [2][RM]
// float4 (march_prefix); then the plane [RM][RM | 1] and the rays' rx / ry
// [2][RM] fp32 (march_tail).  The prefix is dead once the march's last step
// has been sampled, so an epilogue may use it: kernel A's takes nothing
// there, and its plane follows the column tables at an offset the compiler
// knows (Epi::kPlaneAfterTables); kernel C's planes and y-pass rows alias
// the ring, and its plane lies at the larger of the prefix and what its
// epilogue takes there.
//
// The plan (volq_torch/render/kernel.py:march_plan / images_plan, from the
// shapes) names the block width -- the fewest threads kCap allows, since
// more, smaller blocks an SM wait less on each other's step barriers -- and
// the arm: "staged" (the ring, 2-4 stages, as many as leave the SM the
// blocks its registers allow) or "global" (the same step-major loop with
// the taps read from device memory), for a slab stage that does not fit or
// is not 16-byte aligned.  No arm falls back to another silently: a plan
// the kernel cannot take is an error (march_plan_ok).
//
// Every translation unit that includes this file is built with
// --fmad=false: the reference rounds every product before its add, and
// contraction into FMA would change the fp32 results.

#pragma once

#include "warp_common.cuh"
#include "stage_ring.cuh"

constexpr int kCap = 20;              // rays a thread at most (registers)
constexpr int kMaxBlock = 1024;
constexpr int kSmemOptin = 232448;    // dynamic shared bytes a block may use

// mirrors MarchPlan in volq_torch/render/kernel.py: G column groups (RM * G
// threads), stages of the ring (0: the global arm), dynamic shared bytes,
// and kernel C's y-pass rows a round (0 for A, and for C where RM == RP)
struct MarchPlan {
  int G, stages, smem, band;
};

// shared bytes before the plane: the ring of ``stages`` slab stages (per-
// step lit: density and light slab) and center-lit's light slab (staged
// arm only), then the column tables [2][RM] float4
__host__ __device__ inline int march_prefix(const MarchParams& p, int stages,
                                            int itemsize) {
  const int slab = p.VX * p.V * itemsize;
  int b = 2 * p.RM * 16;
  if (stages) {
    b += stages * slab * (p.lit == kPerStep ? 2 : 1);
    if (p.lit == kCenter) b += slab;
  }
  return b;
}

// shared bytes from the plane on: the plane [RM][RM | 1], rx / ry [2][RM]
__host__ __device__ inline int march_tail(const MarchParams& p) {
  return (p.RM * (p.RM | 1) + 2 * p.RM) * 4;
}

// Whether the march kernels can take plan ``pl`` for these shapes and banks
// (``smem``: the dynamic shared bytes the kernel's layout needs).
static bool march_plan_ok(const MarchParams& p, const MarchPlan& pl,
                          const void* bank, const void* lbank, int itemsize,
                          int smem) {
  const int slab = p.VX * p.V * itemsize;
  const bool ring_ok =
      !pl.stages ||
      (pl.stages >= 2 && pl.stages <= kMaxStages && slab % 16 == 0 &&
       !((uintptr_t)bank & 15) && !(p.lit && ((uintptr_t)lbank & 15)));
  return p.RM >= 1 && pl.G >= 1 && p.RM * pl.G <= kMaxBlock &&
         (p.RM + pl.G - 1) / pl.G <= kCap && ring_ok && pl.smem == smem &&
         smem <= kSmemOptin && p.lit >= kUnlit && p.lit <= kPerStep &&
         (!p.lit || lbank);
}

// ray/AABB: geo = scale * min(dt_raw, seg) of ray (rx, ry)
template <bool ORTHO>
__device__ __forceinline__ float ray_geo(float rx, float ry, const float* camf,
                                         const OrthoSlopes& os, float lo_x,
                                         float lo_y, float lo_z, float ext,
                                         float scale, float szn,
                                         const MarchParams& p) {
  const float eye_x = camf[0], eye_y = camf[1], eye_z = camf[2];
  const float hi_x = lo_x + ext, hi_y = lo_y + ext, hi_z = lo_z + ext;
  float dt_raw, t0x, t1x, t0y, t1y, t0z, t1z;
  if constexpr (ORTHO) {
    dt_raw = ext / p.Sf / fabsf(os.fz_s);
    axis_seg(rx + eye_z * os.kx, camf[9], lo_x, hi_x, &t0x, &t1x);
    axis_seg(ry + eye_z * os.ky, camf[10], lo_y, hi_y, &t0y, &t1y);
    axis_seg(eye_z, camf[11], lo_z, hi_z, &t0z, &t1z);
  } else {
    const float rnorm = sqrtf(rx * rx + ry * ry + 1.f);
    const float inv_n = 1.f / rnorm;
    const float d_x = rx * inv_n * szn, d_y = ry * inv_n * szn;
    const float d_z = inv_n * szn;
    dt_raw = (ext / p.Sf) * rnorm;
    axis_seg(eye_x, d_x, lo_x, hi_x, &t0x, &t1x);
    axis_seg(eye_y, d_y, lo_y, hi_y, &t0y, &t1y);
    axis_seg(eye_z, d_z, lo_z, hi_z, &t0z, &t1z);
  }
  const float t0 = fmaxf(fmaxf(t0x, t0y), fmaxf(t0z, 0.f));
  const float t1 = fminf(fminf(t1x, t1y), t1z);
  const float seg = fmaxf(t1 - t0, 0.f);
  return scale * fminf(dt_raw, seg);
}

// The fan shift of one plane held in registers (v[c] = ray (j, g0 + c*G)):
// linear interpolation along the columns at i + du, then (row_fan) along
// the rows at j + dw, each pass through the shared ``plane`` (row stride
// P).  Shifts the clamp cut are added to *cl.
template <bool ORTHO>
__device__ __forceinline__ void fan_pass(float (&v)[kCap], float* plane,
                                         const Fan<ORTHO>& fan,
                                         const MarchParams& p, int j, int g0,
                                         int G, int nr, int* cl) {
  const int P = p.RM | 1;
  #pragma unroll
  for (int c = 0; c < kCap; ++c)
    if (c < nr) plane[j * P + g0 + c * G] = v[c];
  __syncthreads();
  #pragma unroll
  for (int c = 0; c < kCap; ++c) {
    if (c < nr) {
      const int i = g0 + c * G;
      const float du = fan.du(j, i, p, cl);
      const float d0 = floorf(du), fr = du - d0;
      const int ic = i + (int)d0;
      v[c] = (1.f - fr) * plane[j * P + ic] + fr * plane[j * P + ic + 1];
    }
  }
  __syncthreads();
  if (!p.row_fan) return;
  #pragma unroll
  for (int c = 0; c < kCap; ++c)
    if (c < nr) plane[j * P + g0 + c * G] = v[c];
  __syncthreads();
  #pragma unroll
  for (int c = 0; c < kCap; ++c) {
    if (c < nr) {
      const int i = g0 + c * G;
      const float dw = fan.dw(j, i, p, cl);
      const float d0 = floorf(dw), fr = dw - d0;
      const int jc = j + (int)d0;
      v[c] = (1.f - fr) * plane[jc * P + i] + fr * plane[(jc + 1) * P + i];
    }
  }
  __syncthreads();
}

// One slab sample of a ray: sum over the x rows off0, off1 (element
// offsets a0 * V, min(a0 + 1, VX - 1) * V) of rnd(wy0 * slab[b0] + wy1 *
// slab[b1]) * wx, b1 = min(b0 + 1, V - 1).  Where the reference has no
// second tap (a0 + 1 == VX, b0 + 1 == V) its weight is 0 and the clamped
// tap is a finite in-slab value, so the product adds a signed zero to a sum
// that is never -0: the same bits as a sample that skips the missing tap.
template <typename T>
__device__ __forceinline__ float tap_sum(const T* slab, int off0, int off1,
                                         int b0, int b1, float wy0, float wy1,
                                         float wx0, float wx1, float acc) {
  const float t1a =
      rnd<T>(wy0 * ldf<T>(slab + off0 + b0) + wy1 * ldf<T>(slab + off0 + b1));
  acc = acc + t1a * wx0;
  const float t1b =
      rnd<T>(wy0 * ldf<T>(slab + off1 + b0) + wy1 * ldf<T>(slab + off1 + b1));
  return acc + t1b * wx1;
}

// The march of particle n = blockIdx.x (valid: the caller handles an
// invalid one) over the slab banks (lbank when lit) with the particle's
// bank entry vidx[n], geometry pgeom[n], ray vectors rxu[n] / ryw[n] and
// the camera camf, from its slab stack to the finished planes, which it
// hands to epi(P1, P2, plane, j, g0, G, nr, p): per thread the rays
// (j, g0 + c*G), c < nr, of P1 and P2 (the same array when unlit), and
// the shared plane [RM][RM | 1], free for the epilogue's use.  ``smem``:
// the block's dynamic shared memory, the plane right after the column
// tables where Epi::kPlaneAfterTables, else at byte ``plane_off`` (>=
// march_prefix).  Adds the particle's clamped shifts to *clamp_out.
// The pointers are __restrict__ (as the kernels' parameters are), so that
// the camera and ray loads need not be repeated around shared stores.
template <typename T, int MODE, bool ORTHO, bool STAGED, typename Epi>
__device__ __forceinline__ void march_particle(
    const T* __restrict__ bank, const T* __restrict__ lbank,
    const int* __restrict__ vidx, const float* __restrict__ pgeom,
    const float* __restrict__ rxu, const float* __restrict__ ryw,
    const float* __restrict__ camf, int* __restrict__ clamp_out,
    const MarchParams& p, const MarchPlan& pl, unsigned char* smem,
    int plane_off, const Epi& epi) {
  __shared__ int blk_clamp;
  const int n = blockIdx.x, tid = threadIdx.x;
  const int RM = p.RM, P = RM | 1, G = pl.G, D = pl.stages;
  const float* g = pgeom + (size_t)n * PG_N;

  const int slab = p.VX * p.V;
  const int stage = (MODE == kPerStep ? 2 : 1) * slab;
  T* ring = reinterpret_cast<T*>(smem);
  T* lslab = ring + (STAGED ? D * stage : 0);
  float4* ctab = reinterpret_cast<float4*>(
      lslab + (STAGED && MODE == kCenter ? slab : 0));
  float* plane = Epi::kPlaneAfterTables
                     ? reinterpret_cast<float*>(ctab + 2 * RM)
                     : reinterpret_cast<float*>(smem + plane_off);
  float* rxs = plane + RM * P;
  float* rys = rxs + RM;

  const float lo_x = g[PG_LOX], lo_y = g[PG_LOY], lo_z = g[PG_LOZ];
  const float ext = g[PG_EXT], scale = g[PG_SCALE], szn = g[PG_SZN];
  const float eye_x = camf[0], eye_y = camf[1], eye_z = camf[2];
  const T* stack = bank + (size_t)vidx[n] * p.S * slab;
  const T* lstack =
      MODE != kUnlit ? lbank + (size_t)vidx[n] * p.S * slab : nullptr;
  const float kx2 = p.gscx / ext, ky2 = p.gsc / ext;
  const float bx_h = (eye_x - lo_x) * kx2, by_h = (eye_y - lo_y) * ky2;
  const OrthoSlopes os(camf);   // used by ORTHO only
  const float se = scale * ext;
  const bool flip = MODE == kPerStep && szn < 0.f;

  // step si's copies into ring slot si % D (every thread takes a share)
  auto stage_step = [&](int si) {
    if (si < p.S) {
      const int s = flip ? p.S - 1 - si : si;
      const int n16 = slab * (int)sizeof(T) / 16;
      char* dst = reinterpret_cast<char*>(ring + (si % D) * stage);
      const char* src = reinterpret_cast<const char*>(stack + (size_t)s * slab);
      for (int q = tid; q < n16; q += blockDim.x)
        cp_async16(dst + 16 * q, src + 16 * q);
      if (MODE == kPerStep) {
        const char* lsrc =
            reinterpret_cast<const char*>(lstack + (size_t)s * slab);
        char* ldst = dst + slab * sizeof(T);
        for (int q = tid; q < n16; q += blockDim.x)
          cp_async16(ldst + 16 * q, lsrc + 16 * q);
      }
    }
    cp_async_commit();
  };
  if constexpr (STAGED) {
    if (MODE == kCenter) {   // the light slab rides with step 0's group
      const int n16 = slab * (int)sizeof(T) / 16;
      const char* src =
          reinterpret_cast<const char*>(lstack + (size_t)p.mid * slab);
      for (int q = tid; q < n16; q += blockDim.x)
        cp_async16(reinterpret_cast<char*>(lslab) + 16 * q, src + 16 * q);
    }
    for (int d = 0; d < D - 1; ++d) stage_step(d);
  }

  if (tid == 0) blk_clamp = 0;
  for (int q = tid; q < RM; q += blockDim.x) {
    rxs[q] = rxu[(size_t)n * RM + q];
    rys[q] = ryw[(size_t)n * RM + q];
  }
  __syncthreads();

  // this thread's rays: row j, columns g0 + c * G (c < nr)
  const int j = tid % RM, g0 = tid / RM;
  const int nr = (RM - g0 + G - 1) / G;
  const float ry = rys[j];
  float acc[kCap], trn[kCap];   // od (P1 per-step lit), T per-step lit
  #pragma unroll
  for (int c = 0; c < kCap; ++c) {
    acc[c] = 0.f;
    trn[c] = 1.f;
    if (MODE == kPerStep && c < nr) {   // per-step lit needs geo per step
      const int i = g0 + c * G;
      plane[j * P + i] = ray_geo<ORTHO>(rxs[i], ry, camf, os, lo_x, lo_y,
                                        lo_z, ext, scale, szn, p);
    }
  }

  for (int si = 0; si < p.S; ++si) {
    const int s = flip ? p.S - 1 - si : si;
    const float zeta = ((float)s + 0.5f) / p.Sf;
    const float zw = lo_z + zeta * ext;
    const bool tpos = (zw - eye_z) * szn > 0.f;
    // this step's column table: the element offsets of the x taps' rows
    // (-1 where the column is masked) and their hat weights
    float4* ct = ctab + (si & 1) * RM;
    for (int i = tid; i < RM; i += blockDim.x) {
      const float rx = rxs[i];
      float gx;
      if constexpr (ORTHO) {
        gx = (zw * os.kx - lo_x) * kx2 + kx2 * rx;
      } else {
        const float c1 = zw - eye_z;
        gx = bx_h + (c1 * kx2) * rx;
      }
      float4 e = make_float4(__int_as_float(-1), 0.f, 0.f, 0.f);
      if (gx >= 0.f && gx <= p.gscx) {
        const int a0 = (int)floorf(gx);
        e = make_float4(__int_as_float(a0 * p.V),
                        __int_as_float(min(a0 + 1, p.VX - 1) * p.V),
                        hat<T>(gx, a0, p.VX), hat<T>(gx, a0 + 1, p.VX));
      }
      ct[i] = e;
    }
    if constexpr (STAGED) cp_async_wait_pending(D - 2);
    __syncthreads();
    if constexpr (STAGED) stage_step(si + D - 1);   // the slot si-1 left
    const T* sl = STAGED ? ring + (si % D) * stage : stack + (size_t)s * slab;
    const T* ll = nullptr;
    if (MODE == kPerStep) ll = STAGED ? sl + slab : lstack + (size_t)s * slab;
    if (MODE == kCenter)
      ll = STAGED ? lslab : lstack + (size_t)p.mid * slab;
    const bool mid = MODE == kCenter && s == p.mid;

    float gy;
    if constexpr (ORTHO) {
      gy = (zw * os.ky - lo_y) * ky2 + ky2 * ry;
    } else {
      const float c1 = zw - eye_z;
      gy = by_h + (c1 * ky2) * ry;
    }
    // a masked row / column has hat position -2: every weight is 0, the
    // sample is +0, and (per-step) alpha = 0 leaves (P1, T) as they are
    const bool row_ok = gy >= 0.f && gy <= p.gsc && tpos;
    int b0 = 0, b1 = 0;
    float wy0 = 0.f, wy1 = 0.f;
    if (row_ok) {
      b0 = (int)floorf(gy);
      b1 = min(b0 + 1, p.V - 1);
      wy0 = hat<T>(gy, b0, p.V);
      wy1 = hat<T>(gy, b0 + 1, p.V);
    }
    #pragma unroll
    for (int c = 0; c < kCap; ++c) {
      if (c >= nr) continue;
      const int i = g0 + c * G;
      const float4 e = ct[i];
      const int off0 = __float_as_int(e.x), off1 = __float_as_int(e.y);
      const bool on = row_ok && off0 >= 0;
      if (MODE == kPerStep) {
        if (!on) continue;
        const float geo = plane[j * P + i];
        const float sig = tap_sum<T>(sl, off0, off1, b0, b1, wy0, wy1, e.z,
                                     e.w, 0.f);
        const float tau_s = tap_sum<T>(ll, off0, off1, b0, b1, wy0, wy1,
                                       e.z, e.w, 0.f);
        const float alpha = 1.f - expf(-sig * geo);
        const float atten = expf(-se * fmaxf(tau_s, 0.f));
        const float fa = trn[c] * alpha;
        acc[c] = acc[c] + fa * atten;
        trn[c] = trn[c] - fa;
      } else {
        if (on)
          acc[c] = tap_sum<T>(sl, off0, off1, b0, b1, wy0, wy1, e.z, e.w,
                              acc[c]);
        if (mid)   // center-lit: tau parked in the plane until the fan
          plane[j * P + i] =
              on ? tap_sum<T>(ll, off0, off1, b0, b1, wy0, wy1, e.z, e.w,
                              0.f)
                 : 0.f;
      }
    }
  }
  // every copy into the ring has landed (the last step's wait covered
  // every group that copies; the later ones are empty), so the prefix is
  // free for the epilogue once every thread is past this barrier
  __syncthreads();

  // ---- the planes before the fan: (q, tau') telescoped, (P1, P2) per-step
  #pragma unroll
  for (int c = 0; c < kCap; ++c) {
    if (c >= nr) continue;
    const int i = g0 + c * G;
    if (MODE == kPerStep) {
      trn[c] = 1.f - trn[c];
    } else {
      const float geo = ray_geo<ORTHO>(rxs[i], ry, camf, os, lo_x, lo_y,
                                       lo_z, ext, scale, szn, p);
      acc[c] = acc[c] * geo;
      if (MODE == kCenter) trn[c] = se * fmaxf(plane[j * P + i], 0.f);
    }
  }
  __syncthreads();

  // ---- fan shift: q (telescoped) or both planes (per-step lit)
  const Fan<ORTHO> fan(g, camf, p);
  int my_clamp = 0, unused = 0;
  fan_pass<ORTHO>(acc, plane, fan, p, j, g0, G, nr, &my_clamp);
  if (MODE == kPerStep)
    fan_pass<ORTHO>(trn, plane, fan, p, j, g0, G, nr, &unused);

  // ---- exps, then the planes to the epilogue: P2 unlit, (P1, P2) lit
  #pragma unroll
  for (int c = 0; c < kCap; ++c) {
    if (c >= nr || MODE == kPerStep) continue;
    const float P2 = 1.f - expf(-acc[c]);
    if (MODE == kCenter) trn[c] = expf(-trn[c]) * P2;
    acc[c] = P2;
  }
  if constexpr (MODE == kPerStep)
    epi(acc, trn, plane, j, g0, G, nr, p);
  else if constexpr (MODE == kCenter)
    epi(trn, acc, plane, j, g0, G, nr, p);
  else
    epi(acc, acc, plane, j, g0, G, nr, p);
  if (my_clamp) atomicAdd(&blk_clamp, my_clamp);
  __syncthreads();
  if (tid == 0 && blk_clamp) atomicAdd(clamp_out, blk_clamp);
}

// The launch of instantiation L<T, MODE, ORTHO, STAGED>::run(p, pl, a...)
// that the bank's type (bank_bf16), p.lit, p.ortho and pl.stages name.
template <template <typename, int, bool, bool> class L, typename T, int MODE,
          bool ORTHO, typename... A>
static int march_arm(const MarchParams& p, const MarchPlan& pl, A... a) {
  if (pl.stages) return L<T, MODE, ORTHO, true>::run(p, pl, a...);
  return L<T, MODE, ORTHO, false>::run(p, pl, a...);
}

template <template <typename, int, bool, bool> class L, typename T, int MODE,
          typename... A>
static int march_proj(const MarchParams& p, const MarchPlan& pl, A... a) {
  if (p.ortho) return march_arm<L, T, MODE, true>(p, pl, a...);
  return march_arm<L, T, MODE, false>(p, pl, a...);
}

template <template <typename, int, bool, bool> class L, typename T,
          typename... A>
static int march_mode(const MarchParams& p, const MarchPlan& pl, A... a) {
  if (p.lit == kPerStep) return march_proj<L, T, kPerStep>(p, pl, a...);
  if (p.lit == kCenter) return march_proj<L, T, kCenter>(p, pl, a...);
  return march_proj<L, T, kUnlit>(p, pl, a...);
}

template <template <typename, int, bool, bool> class L, typename... A>
static int march_dispatch(int bank_bf16, const MarchParams& p,
                          const MarchPlan& pl, A... a) {
  if (bank_bf16) return march_mode<L, __nv_bfloat16>(p, pl, a...);
  return march_mode<L, float>(p, pl, a...);
}
