// warp_composite: the composite half of the fused warp kernel, for Hopper
// (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas (fused mode, every canvas
// layout) -- its epilogue's placement and canvas read-modify-write: the hat
// placement of each particle's march-resolution plane(s) straight into
// canvas coordinates (Uyp, rounded to the placement type, then Uxp) and the
// front-to-back OVER, rounded to the canvas type after every particle, in
// depth order.  Unlit (one plane P2, colour folded to cc = alb*(lcol+amb)):
//   T2 = Tw*P2;  C_ch += cc_ch*T2;  T = Tw - T2.
// Lit (planes P1, P2; cc = alb*lcol, cc2 = alb*amb):
//   T2 = Tw*P2;  T1 = Tw*P1;  C_ch += cc_ch*T1 + cc2_ch*T2;  T = Tw - T2.
//
// Canvas cell (y, x) samples particle k's planes at the march position
//   gy = (f32(y) - ayf[k]) * gscale,  gx = (f32(x) - axf[k]) * gscale
// with hat weights max(0, 1 - |g - m|) on the two taps floor(g), floor(g)+1.
// On a pixel canvas ayf/axf are integers, gscale = (RM-1)/(RP-1) and the
// particle's box is its RP x RP rect; on a cell canvas (warp_coarse,
// warp_canvas_scale) the origin is fractional, gscale is the reference's
// cell -> march factor C2M, the tent itself is the support and the box only
// bounds it (cut to the window the TPU kernel updates, box[k] =
// (y0, y1, x0, x1), computed on the host).
//
// ILV (warp_interleave): the TPU stores four channels on neighbouring lanes
// and folds the per-channel colour coefficients into the x weights so that
// one matmul yields all four updates.  The layout is not carried over, the
// association is: W[m, c] = rnd(hat_x[m] * A[c]) with the hat unrounded,
// A = (cc, 0) for the P1 taps and (cc2, -1) for the P2 taps (unlit:
// (cc, -1)); U[c] = sum over the P1 taps, then the P2 taps, of t[m]*W[m, c]
// in fp32 (the K order of the TPU's concatenated operands), and every
// channel, T included, updates as  c = rnd(c + Tw*U[c]).
//
// The reference's pair and hazard reorders (warp_pair, warp_hazard_passes)
// only swap depth-adjacent particles whose canvas windows are disjoint, so
// no pixel's order changes and the per-pixel depth walk here needs no
// reorder.
//
// Design.  The TPU ran one sequential grid over the depth-ordered particles
// and carried each particle's canvas window through double-buffered DMAs
// with hazard flags.  GPU blocks run in no order, so the order moves inside
// the block: one block per 16 x 64 canvas tile, the tile held in registers
// for the whole walk, and the block walks the depth-ordered particle list
// in order, skipping particles whose box misses the tile (warp 0 compacts
// each chunk of the list with ballots, keeping the order).  Each canvas
// cell is read once and written once, and per-cell depth order is exact.
// Cells of a box outside the particle's footprint get P = 0, the OVER
// identity, exactly as the TPU window ring did.  Each Uyp/Uxp row has two
// non-zeros, so the two matmuls become 2 x 2-tap sums per cell, with the
// reference's rounding points (the Uyp sum is rounded to the placement type
// before the Uxp sum).
//
// Bound on this card: bytes (canvas read + write, planes read once: c5's
// 16384 x 2 x 80 x 80 fp32 planes are 839 MB per frame).  The planes are
// re-read per covering tile from L2.
//
// Built with --fmad=false; the RMW spells its roundings out with
// __fmul_rn / __fadd_rn as well, so the canvas is bit-equal to the plain
// PyTorch version.

#include "warp_common.cuh"

struct CompositeParams {
  int N, RM, Hc, Wc, lit, ilv;
  float gscale;   // canvas offset -> march cells
};

constexpr int kTileW = 64, kTileH = 16, kRowsPerThread = 4;
constexpr int kChunk = 1024;

// unrounded hat weight of tap k at position g, 0 outside [0, n)
__device__ __forceinline__ float hat_raw(float g, int k, int n) {
  if (k < 0 || k >= n) return 0.f;
  return fmaxf(0.f, 1.f - fabsf(g - (float)k));
}

template <typename CT, typename PT, bool LIT, bool ILV>
__global__ void __launch_bounds__(kTileW * (kTileH / kRowsPerThread))
warp_composite_kernel(CT* __restrict__ canvas, const float* __restrict__ pm,
                      const float* __restrict__ ayf,
                      const float* __restrict__ axf,
                      const int4* __restrict__ box,
                      const float* __restrict__ cc,
                      const float* __restrict__ cc2,
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

  const int RM = p.RM, RR = RM * RM;
  const int lane = threadIdx.x & 31;
  const bool warp0 = ty == 0 && tx < 32;
  for (int base = 0; base < p.N; base += kChunk) {
    // ordered compaction of the particles whose box meets this tile
    if (warp0) {
      int cnt = 0;
      for (int kb = base; kb < min(base + kChunk, p.N); kb += 32) {
        const int k = kb + lane;
        bool hit = false;
        if (k < p.N && valid[k]) {
          const int4 b = box[k];   // (y0, y1, x0, x1)
          hit = b.x < ty0 + kTileH && b.y > ty0 &&
                b.z < tx0 + kTileW && b.w > tx0;
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
      const int4 b = box[k];
      if (!colin || X < b.z || X >= b.w) continue;
      // planes of particle k: [P2] unlit, [P1, P2] lit
      const float* P2p = pm + ((size_t)k * (LIT ? 2 : 1) + (LIT ? 1 : 0)) * RR;
      const float* P1p = pm + (size_t)k * (LIT ? 2 : 1) * RR;
      const float gx = __fmul_rn(__fsub_rn((float)X, axf[k]), p.gscale);
      const float ay = ayf[k];
      const int m0 = (int)floorf(gx);
      float ca[3], cb[3];
      #pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        ca[ch] = cc[3 * k + ch];
        cb[ch] = LIT ? cc2[3 * k + ch] : 0.f;
      }
      // x weights: rounded hats, or (ILV) the coefficient-folded W[m, c]
      float wx0 = 0.f, wx1 = 0.f, Wa[2][4], Wb[2][4];
      if (ILV) {
        const float h0 = hat_raw(gx, m0, RM), h1 = hat_raw(gx, m0 + 1, RM);
        #pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
          const float A1 = ch < 3 ? ca[ch] : (LIT ? 0.f : -1.f);
          Wa[0][ch] = rnd<PT>(__fmul_rn(h0, A1));
          Wa[1][ch] = rnd<PT>(__fmul_rn(h1, A1));
          if (LIT) {
            const float A2 = ch < 3 ? cb[ch] : -1.f;
            Wb[0][ch] = rnd<PT>(__fmul_rn(h0, A2));
            Wb[1][ch] = rnd<PT>(__fmul_rn(h1, A2));
          }
        }
      } else {
        wx0 = hat<PT>(gx, m0, RM);
        wx1 = hat<PT>(gx, m0 + 1, RM);
      }
      #pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int Y = Ybase + r;
        if (Y < b.x || Y >= b.y || Y >= p.Hc) continue;
        const float gy = __fmul_rn(__fsub_rn((float)Y, ay), p.gscale);
        int k0;
        float wy0, wy1;
        taps<PT>(gy, RM, &k0, &wy0, &wy1);
        // y pass at the two x taps: t[m] = rnd(wy0*P[k0, m] + wy1*P[k0+1, m])
        const float t2a = up_y<PT>(P2p, RM, k0, wy0, wy1, m0);
        const float t2b = up_y<PT>(P2p, RM, k0, wy0, wy1, m0 + 1);
        float t1a = 0.f, t1b = 0.f;
        if (LIT) {
          t1a = up_y<PT>(P1p, RM, k0, wy0, wy1, m0);
          t1b = up_y<PT>(P1p, RM, k0, wy0, wy1, m0 + 1);
        }
        const float Tw = T[r];
        if (ILV) {
          float U[4];
          #pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            if (LIT)
              U[ch] = __fadd_rn(
                  __fadd_rn(__fadd_rn(__fmul_rn(t1a, Wa[0][ch]),
                                      __fmul_rn(t1b, Wa[1][ch])),
                            __fmul_rn(t2a, Wb[0][ch])),
                  __fmul_rn(t2b, Wb[1][ch]));
            else
              U[ch] = __fadd_rn(__fmul_rn(t2a, Wa[0][ch]),
                                __fmul_rn(t2b, Wa[1][ch]));
          }
          #pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            C[r][ch] = rnd<CT>(__fadd_rn(C[r][ch], __fmul_rn(Tw, U[ch])));
          T[r] = rnd<CT>(__fadd_rn(Tw, __fmul_rn(Tw, U[3])));
          continue;
        }
        const float placed2 =
            __fadd_rn(__fmul_rn(t2a, wx0), __fmul_rn(t2b, wx1));
        const float T2 = __fmul_rn(Tw, placed2);
        if (LIT) {
          const float placed1 =
              __fadd_rn(__fmul_rn(t1a, wx0), __fmul_rn(t1b, wx1));
          const float T1 = __fmul_rn(Tw, placed1);
          #pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            C[r][ch] = rnd<CT>(__fadd_rn(
                C[r][ch], __fadd_rn(__fmul_rn(ca[ch], T1),
                                    __fmul_rn(cb[ch], T2))));
        } else {
          #pragma unroll
          for (int ch = 0; ch < 3; ++ch)
            C[r][ch] = rnd<CT>(__fadd_rn(C[r][ch], __fmul_rn(ca[ch], T2)));
        }
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

template <typename CT, typename PT, bool LIT>
static void launch_l(void* canvas, const float* pm, const float* ayf,
                     const float* axf, const int* box, const float* cc,
                     const float* cc2, const int* valid, CompositeParams p,
                     cudaStream_t st) {
  dim3 block(kTileW, kTileH / kRowsPerThread);
  dim3 grid((p.Wc + kTileW - 1) / kTileW, (p.Hc + kTileH - 1) / kTileH);
  if (p.ilv)
    warp_composite_kernel<CT, PT, LIT, true><<<grid, block, 0, st>>>(
        (CT*)canvas, pm, ayf, axf, (const int4*)box, cc, cc2, valid, p);
  else
    warp_composite_kernel<CT, PT, LIT, false><<<grid, block, 0, st>>>(
        (CT*)canvas, pm, ayf, axf, (const int4*)box, cc, cc2, valid, p);
}

template <typename CT, typename PT>
static void launch_p(void* canvas, const float* pm, const float* ayf,
                     const float* axf, const int* box, const float* cc,
                     const float* cc2, const int* valid, CompositeParams p,
                     cudaStream_t st) {
  if (p.lit)
    launch_l<CT, PT, true>(canvas, pm, ayf, axf, box, cc, cc2, valid, p, st);
  else
    launch_l<CT, PT, false>(canvas, pm, ayf, axf, box, cc, nullptr, valid, p,
                            st);
}

template <typename CT>
static void launch_c(void* canvas, const float* pm, int place_bf16,
                     const float* ayf, const float* axf, const int* box,
                     const float* cc, const float* cc2, const int* valid,
                     CompositeParams p, cudaStream_t st) {
  if (place_bf16)
    launch_p<CT, __nv_bfloat16>(canvas, pm, ayf, axf, box, cc, cc2, valid, p,
                                st);
  else
    launch_p<CT, float>(canvas, pm, ayf, axf, box, cc, cc2, valid, p, st);
}

extern "C" int warp_composite_launch(void* canvas, int canvas_bf16,
                                     const float* pm, int place_bf16,
                                     const float* ayf, const float* axf,
                                     const int* box, const float* cc,
                                     const float* cc2, const int* valid,
                                     CompositeParams p, void* stream) {
  if ((p.lit && !cc2) || ((uintptr_t)box & 15))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (canvas_bf16)
    launch_c<__nv_bfloat16>(canvas, pm, place_bf16, ayf, axf, box, cc, cc2,
                            valid, p, st);
  else
    launch_c<float>(canvas, pm, place_bf16, ayf, axf, box, cc, cc2, valid, p,
                    st);
  return (int)cudaGetLastError();
}
