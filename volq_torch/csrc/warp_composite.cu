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
// the block: one block per 16 x 64 canvas tile, the tile held in registers,
// walking in depth order only the particles whose box meets it: the
// per-tile lists of tile_lists.cuh, built in the launch (the fill, then
// each tile's block puts its list in depth order; a tile whose list did not
// fit its slots has every particle tested instead).  Each warp then
// walks the list alone over its 4 x 32 sub-tile, taking the particles whose
// box meets it 32 list entries at a time, and reads their plane taps from
// device memory (L2); the warps of a block do not wait for each other.
// (Staging each particle's plane window through a shared-memory ring was
// measured slower on every preset: the planes stay in the 50 MB L2.)  Each
// canvas cell is read once and written once, and per-cell depth order is
// exact.  Cells of a box outside the particle's footprint get P = 0, the
// OVER identity, exactly as the TPU window ring did.  Each Uyp/Uxp row has
// two non-zeros, so the two matmuls become 2 x 2-tap sums per cell, with the
// reference's rounding points (the Uyp sum is rounded to the placement type
// before the Uxp sum).
//
// Bound on this card: bytes (the canvas cells some box meets read + written,
// planes read once: c5's 16384 x 2 x 80 x 80 fp32 planes are 839 MB per
// frame).  A plane's taps are read once per warp sub-tile that the
// particle's box meets.
//
// Built with --fmad=false; the RMW spells its roundings out with
// __fmul_rn / __fadd_rn as well, so the canvas is bit-equal to the plain
// PyTorch version.

#include "warp_common.cuh"
#include "tile_lists.cuh"

struct CompositeParams {
  int N, RM, Hc, Wc, lit, ilv;
  float gscale;   // canvas offset -> march cells
};

// unrounded hat weight of tap k at position g, 0 outside [0, n)
__device__ __forceinline__ float hat_raw(float g, int k, int n) {
  if (k < 0 || k >= n) return 0.f;
  return fmaxf(0.f, 1.f - fabsf(g - (float)k));
}

// the fill's rects: a valid particle's placement box (y0, y1, x0, x1)
struct BoxRects {
  const int4* box;
  const int* valid;
  __device__ __forceinline__ bool operator()(int k, int4* b) const {
    if (!valid[k]) return false;
    *b = box[k];
    return true;
  }
};

// Everything a launch of the composite takes, as one kernel parameter read
// in place (__grid_constant__), so that it costs no registers.
struct CompArgs {
  void* canvas;
  const float* pm;
  const float* ayf;
  const float* axf;
  const int4* box;
  const float* cc;
  const float* cc2;
  const int* valid;
  int* scratch;   // cnt [ntiles] | raw [ntiles, capt] | lists [ntiles, capt]
  CompositeParams p;
  TilePlan tp;
};

// what a warp needs of a listed particle to test it and composite it
struct Entry {
  int k;
  int4 b;
  float ay, ax, c[6];
};

// list[q] (the identity when list is null: every particle, valid or not)
// for this lane; k = -1 past the end
__device__ __forceinline__ Entry load_entry(const CompArgs& a,
                                            const int* list, int q,
                                            int cnt) {
  Entry e{-1, make_int4(0, 0, 0, 0), 0.f, 0.f, {}};
  e.k = q < cnt ? (list ? list[q] : q) : -1;
  if (e.k >= 0) {
    e.b = a.box[e.k];
    e.ay = a.ayf[e.k];
    e.ax = a.axf[e.k];
    if (!list && !a.valid[e.k]) e.b = make_int4(0, 0, 0, 0);
  }
  return e;
}

__device__ __forceinline__ unsigned meets(const CompArgs& a, const Warp& w,
                                          const Entry& e) {
  int ya, yb, xa, xb;
  return __ballot_sync(0xffffffffu,
                       e.k >= 0 && sub_cells(w, e.b, a.p.Hc, a.p.Wc, &ya,
                                             &yb, &xa, &xb));
}

// The OVER of one particle onto this lane's cells: box b, placement origin
// (ay, ax), colour factors ca (cb lit), planes P1p / P2p [RM, RM] with rows
// rs (= RM) apart.
template <typename CT, typename PT, bool LIT, bool ILV>
__device__ __forceinline__ void place(const CompArgs& a, const Warp& w,
                                      int4 b, float ay, float ax,
                                      const float (&ca)[3],
                                      const float (&cb)[3],
                                      const float* P1p, const float* P2p,
                                      int rs, float (&C)[kRowsPerThread][3],
                                      float (&T)[kRowsPerThread]) {
  if (!w.colin || w.X < b.z || w.X >= b.w) return;
  const int RM = a.p.RM;
  const float gx = __fmul_rn(__fsub_rn((float)w.X, ax), a.p.gscale);
  const int m0 = (int)floorf(gx);
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
    const int Y = w.wy0 + r;
    if (Y < b.x || Y >= b.y || Y >= a.p.Hc) continue;
    const float gy = __fmul_rn(__fsub_rn((float)Y, ay), a.p.gscale);
    int k0;
    float wy0, wy1;
    taps<PT>(gy, RM, &k0, &wy0, &wy1);
    // y pass at the two x taps: t[m] = rnd(wy0*P[k0, m] + wy1*P[k0+1, m])
    const float t2a = up_y<PT>(P2p, rs, RM, k0, wy0, wy1, m0);
    const float t2b = up_y<PT>(P2p, rs, RM, k0, wy0, wy1, m0 + 1);
    float t1a = 0.f, t1b = 0.f;
    if (LIT) {
      t1a = up_y<PT>(P1p, rs, RM, k0, wy0, wy1, m0);
      t1b = up_y<PT>(P1p, rs, RM, k0, wy0, wy1, m0 + 1);
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
    const float placed2 = __fadd_rn(__fmul_rn(t2a, wx0), __fmul_rn(t2b, wx1));
    const float T2 = __fmul_rn(Tw, placed2);
    if (LIT) {
      const float placed1 =
          __fadd_rn(__fmul_rn(t1a, wx0), __fmul_rn(t1b, wx1));
      const float T1 = __fmul_rn(Tw, placed1);
      #pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        C[r][ch] = rnd<CT>(__fadd_rn(
            C[r][ch], __fadd_rn(__fmul_rn(ca[ch], T1), __fmul_rn(cb[ch], T2))));
    } else {
      #pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        C[r][ch] = rnd<CT>(__fadd_rn(C[r][ch], __fmul_rn(ca[ch], T2)));
    }
    T[r] = rnd<CT>(__fsub_rn(Tw, T2));
  }
}


// The depth-ordered particles list[0, cnt) (null: every particle) that meet
// the warp's sub-tile: the warp tests the list 32 entries at a time (a lane
// each) and composites the ones that meet it, in order, from the lane that
// holds each.
template <typename CT, typename PT, bool LIT, bool ILV>
__device__ __forceinline__ void walk(const CompArgs& a, const Warp& w,
                                     const int* list, int cnt,
                                     float (&C)[kRowsPerThread][3],
                                     float (&T)[kRowsPerThread]) {
  const int RR = a.p.RM * a.p.RM;
  for (int base = 0; base < cnt; base += 32) {
    Entry mine = load_entry(a, list, base + w.lane, cnt);
    #pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      mine.c[ch] = mine.k >= 0 ? a.cc[3 * mine.k + ch] : 0.f;
      mine.c[3 + ch] = LIT && mine.k >= 0 ? a.cc2[3 * mine.k + ch] : 0.f;
    }
    for (unsigned hit = meets(a, w, mine); hit; hit &= hit - 1u) {
      const int src = __ffs(hit) - 1;
      const int k = __shfl_sync(0xffffffffu, mine.k, src);
      const int4 b = make_int4(__shfl_sync(0xffffffffu, mine.b.x, src),
                               __shfl_sync(0xffffffffu, mine.b.y, src),
                               __shfl_sync(0xffffffffu, mine.b.z, src),
                               __shfl_sync(0xffffffffu, mine.b.w, src));
      const float ay = __shfl_sync(0xffffffffu, mine.ay, src);
      const float ax = __shfl_sync(0xffffffffu, mine.ax, src);
      float ca[3], cb[3];
      #pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        ca[ch] = __shfl_sync(0xffffffffu, mine.c[ch], src);
        cb[ch] = LIT ? __shfl_sync(0xffffffffu, mine.c[3 + ch], src) : 0.f;
      }
      const float* P1p = a.pm + (size_t)k * (LIT ? 2 : 1) * RR;
      place<CT, PT, LIT, ILV>(a, w, b, ay, ax, ca, cb, P1p,
                              P1p + (LIT ? RR : 0), a.p.RM, C, T);
    }
  }
}

// at most 64 registers a thread unlit, 80 lit: four and three blocks an SM
template <typename CT, typename PT, bool LIT, bool ILV>
__global__ void __launch_bounds__(kThreads, LIT ? 3 : 4)
warp_composite_kernel(const __grid_constant__ CompArgs a) {
  __shared__ int list[kChunk];
  __shared__ unsigned bits[kBits / 32];   // the list order's room
  const CompositeParams& p = a.p;
  const TilePlan& tp = a.tp;
  CT* canvas = static_cast<CT*>(a.canvas);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTileW + tx;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int X = tx0 + tx, Ybase = ty0 + ty * kRowsPerThread;
  const size_t plane = (size_t)p.Hc * p.Wc;
  const bool colin = X < p.Wc;
  const int t = blockIdx.y * tp.ntx + blockIdx.x, n = a.scratch[t];
  if (n == 0) return;   // no particle meets the tile: its cells stay

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

  // this tile's list, in depth order (null: it did not fit its slots, and
  // each warp tests every particle)
  const int* ordered =
      tile_list(a.scratch, t, n, p.N, tp, list, bits, kBits, tid);
  const Warp w{Ybase, tx0 + (tx & 32), X, tx & 31, colin};
  walk<CT, PT, LIT, ILV>(a, w, ordered, ordered ? n : p.N, C, T);

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

static bool bad_plan(const CompositeParams& p, const TilePlan& tp) {
  return tile_plan_bad(p.Hc, p.Wc, p.N, tp);
}

template <typename CT, typename PT, bool LIT, bool ILV>
static int launch_k(const CompArgs& a, cudaStream_t st) {
  dim3 block(kTileW, kTileH / kRowsPerThread), grid(a.tp.ntx, a.tp.nty);
  warp_composite_kernel<CT, PT, LIT, ILV><<<grid, block, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename CT, typename PT, bool LIT>
static int launch_l(const CompArgs& a, cudaStream_t st) {
  if (a.p.ilv) return launch_k<CT, PT, LIT, true>(a, st);
  return launch_k<CT, PT, LIT, false>(a, st);
}

template <typename CT, typename PT>
static int launch_p(const CompArgs& a, cudaStream_t st) {
  if (a.p.lit) return launch_l<CT, PT, true>(a, st);
  return launch_l<CT, PT, false>(a, st);
}

// the per-tile lists' fill alone (the first kernel of warp_composite_launch:
// tile t's cnt[t] and its first min(cnt[t], capt) slots, in no order)
extern "C" int warp_composite_fill(const int* box, const int* valid,
                                   CompositeParams p, TilePlan tp,
                                   int* scratch, void* stream) {
  if (bad_plan(p, tp) || ((uintptr_t)box & 15))
    return (int)cudaErrorInvalidValue;
  return fill_lists(BoxRects{(const int4*)box, valid}, p.N, tp, scratch,
                    (cudaStream_t)stream);
}

// the lists' fill, then the composite: two kernels (and a memset)
extern "C" int warp_composite_launch(void* canvas, int canvas_bf16,
                                     const float* pm, int place_bf16,
                                     const float* ayf, const float* axf,
                                     const int* box, const float* cc,
                                     const float* cc2, const int* valid,
                                     CompositeParams p, TilePlan tp,
                                     int* scratch, void* stream) {
  if ((p.lit && !cc2) || ((uintptr_t)box & 15) || bad_plan(p, tp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = fill_lists(BoxRects{(const int4*)box, valid}, p.N, tp, scratch,
                     st);
  if (e) return e;
  const CompArgs a{canvas, pm, ayf, axf, (const int4*)box, cc,
                   p.lit ? cc2 : nullptr, valid, scratch, p, tp};
  if (canvas_bf16)
    return place_bf16 ? launch_p<__nv_bfloat16, __nv_bfloat16>(a, st)
                      : launch_p<__nv_bfloat16, float>(a, st);
  return place_bf16 ? launch_p<float, __nv_bfloat16>(a, st)
                    : launch_p<float, float>(a, st);
}
