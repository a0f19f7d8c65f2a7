// warp_composite: the composite half of the fused warp kernel, for Hopper
// (sm_90a).
//
// Replaces: volq/render/kernel.py:march_warp_pallas (fused mode, unlit or
// center-lit) -- its epilogue's placement and canvas read-modify-write: the
// hat upsample of each particle's march-resolution plane(s) straight into
// canvas coordinates (Uyp, rounded to the working type, then Uxp) and the
// front-to-back OVER, rounded to the canvas type after every particle, in
// depth order.  Unlit (one plane P2, colour folded to cc = alb*(lcol+amb)):
//   T2 = Tw*P2;  C_ch += cc_ch*T2;  T = Tw - T2.
// Center-lit (planes P1, P2; cc = alb*lcol, cc2 = alb*amb):
//   T2 = Tw*P2;  T1 = Tw*P1;  C_ch += cc_ch*T1 + cc2_ch*T2;  T = Tw - T2.
// The reference's pair reorder (warp_pair) only swaps depth-adjacent
// particles whose canvas windows are disjoint, so no pixel's order changes
// and the per-pixel depth walk here needs no reorder.
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

#include "warp_common.cuh"

struct CompositeParams {
  int N, RM, RP, Hc, Wc, lit;
  float ratio_m;   // f32(RM - 1) / f32(RP - 1)
};

constexpr int kTileW = 64, kTileH = 16, kRowsPerThread = 4;
constexpr int kChunk = 1024;

template <typename CT, typename PT, bool LIT>
__global__ void __launch_bounds__(kTileW * (kTileH / kRowsPerThread))
warp_composite_kernel(CT* __restrict__ canvas, const float* __restrict__ pm,
                      const float* __restrict__ ayf,
                      const float* __restrict__ axf,
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

  const int RP = p.RP, RM = p.RM, RR = RM * RM;
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
      // planes of particle k: [P2] unlit, [P1, P2] center-lit
      const float* P2p = pm + ((size_t)k * (LIT ? 2 : 1) + (LIT ? 1 : 0)) * RR;
      const float* P1p = pm + (size_t)k * (LIT ? 2 : 1) * RR;
      int m0;
      float wx0, wx1;
      taps<PT>((float)xo * p.ratio_m, RM, &m0, &wx0, &wx1);
      float ca[3], cb[3];
      #pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        ca[ch] = cc[3 * k + ch];
        cb[ch] = LIT ? cc2[3 * k + ch] : 0.f;
      }
      #pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int yo = Ybase + r - y0;
        if (yo < 0 || yo >= RP || Ybase + r >= p.Hc) continue;
        int k0;
        float wy0, wy1;
        taps<PT>((float)yo * p.ratio_m, RM, &k0, &wy0, &wy1);
        // placed = sum_m rnd(wy0*P[k0, m] + wy1*P[k0+1, m]) * wx_m over
        // m = m0, m0 + 1  (m0, k0 >= 0: xo, yo >= 0)
        const float placed2 = __fadd_rn(
            __fmul_rn(up_y<PT>(P2p, RM, k0, wy0, wy1, m0), wx0),
            __fmul_rn(up_y<PT>(P2p, RM, k0, wy0, wy1, m0 + 1), wx1));
        const float Tw = T[r];
        const float T2 = __fmul_rn(Tw, placed2);
        if (LIT) {
          const float placed1 = __fadd_rn(
              __fmul_rn(up_y<PT>(P1p, RM, k0, wy0, wy1, m0), wx0),
              __fmul_rn(up_y<PT>(P1p, RM, k0, wy0, wy1, m0 + 1), wx1));
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

template <typename CT, typename PT>
static void launch_p(void* canvas, const float* pm, const float* ayf,
                     const float* axf, const float* cc, const float* cc2,
                     const int* valid, CompositeParams p, cudaStream_t st) {
  dim3 block(kTileW, kTileH / kRowsPerThread);
  dim3 grid((p.Wc + kTileW - 1) / kTileW, (p.Hc + kTileH - 1) / kTileH);
  if (p.lit)
    warp_composite_kernel<CT, PT, true><<<grid, block, 0, st>>>(
        (CT*)canvas, pm, ayf, axf, cc, cc2, valid, p);
  else
    warp_composite_kernel<CT, PT, false><<<grid, block, 0, st>>>(
        (CT*)canvas, pm, ayf, axf, cc, nullptr, valid, p);
}

template <typename CT>
static void launch_c(void* canvas, const float* pm, int place_bf16,
                     const float* ayf, const float* axf, const float* cc,
                     const float* cc2, const int* valid, CompositeParams p,
                     cudaStream_t st) {
  if (place_bf16)
    launch_p<CT, __nv_bfloat16>(canvas, pm, ayf, axf, cc, cc2, valid, p, st);
  else
    launch_p<CT, float>(canvas, pm, ayf, axf, cc, cc2, valid, p, st);
}

extern "C" int warp_composite_launch(void* canvas, int canvas_bf16,
                                     const float* pm, int place_bf16,
                                     const float* ayf, const float* axf,
                                     const float* cc, const float* cc2,
                                     const int* valid, CompositeParams p,
                                     void* stream) {
  if (p.lit && !cc2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (canvas_bf16)
    launch_c<__nv_bfloat16>(canvas, pm, place_bf16, ayf, axf, cc, cc2, valid,
                            p, st);
  else
    launch_c<float>(canvas, pm, place_bf16, ayf, axf, cc, cc2, valid, p, st);
  return (int)cudaGetLastError();
}
