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
// walking in depth order only the particles whose box meets it.  Those
// per-tile lists are built in the launch: a kernel over the particles (a
// warp each, its lanes over the tiles) appends each to the slots of every
// tile its box meets (a fixed number of slots a tile, sized on the host
// from the tiles a box can meet, kernel.py:composite_plan; atomics, so in
// no order), and each tile's block first puts its list in ascending order
// -- ranking a short list, or through a bitmap of particle indices in
// shared memory (windows of indices, so any N and any length keep the
// order).  A tile whose list did not fit its slots has every particle
// tested instead; a tile no particle meets returns at once.  Each warp then
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

struct CompositeParams {
  int N, RM, Hc, Wc, lit, ilv;
  float gscale;   // canvas offset -> march cells
};

// mirrors CompositePlan in volq_torch/render/kernel.py: the tile grid and
// the list slots of a tile (capt)
struct CompositePlan {
  int ntx, nty, capt;
};

constexpr int kTileW = 64, kTileH = 16, kRowsPerThread = 4;
constexpr int kThreads = kTileW * (kTileH / kRowsPerThread);
constexpr int kChunk = 1024;          // a list held in shared memory
constexpr int kRankMax = 256;         // lists ordered by ranking
constexpr int kBits = 65536;          // the list order's bitmap window

// unrounded hat weight of tap k at position g, 0 outside [0, n)
__device__ __forceinline__ float hat_raw(float g, int k, int n) {
  if (k < 0 || k >= n) return 0.f;
  return fmaxf(0.f, 1.f - fabsf(g - (float)k));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Each valid particle with a non-empty box appends its index to the slots
// of every tile its box meets (tile t: raw[t * capt, ...), cnt[t] entries
// wanted, the first capt kept), in no order.  A warp per particle, its
// lanes over the tiles, so that a large box's appends run side by side.
__global__ void tile_fill_kernel(const int4* __restrict__ box,
                                 const int* __restrict__ valid, int N,
                                 CompositePlan tp, int* __restrict__ cnt,
                                 int* __restrict__ raw) {
  const int k = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (k >= N || !valid[k]) return;
  const int4 b = box[k];   // (y0, y1, x0, x1)
  if (b.y <= b.x || b.w <= b.z) return;
  const int y0 = max(floor_div(b.x, kTileH), 0);
  const int y1 = min(floor_div(b.y - 1, kTileH), tp.nty - 1);
  const int x0 = max(floor_div(b.z, kTileW), 0);
  const int x1 = min(floor_div(b.w - 1, kTileW), tp.ntx - 1);
  const int nx = x1 - x0 + 1, ntiles = (y1 - y0 + 1) * nx;
  for (int q = lane; q < ntiles && nx > 0; q += 32) {
    const int t = (y0 + q / nx) * tp.ntx + x0 + q % nx;
    const int at = atomicAdd(&cnt[t], 1);
    if (at < tp.capt) raw[(size_t)t * tp.capt + at] = k;
  }
}

// exclusive prefix sum over the block's nthreads (a multiple of 32) threads,
// every one of which calls it; *total gets the block's sum
__device__ __forceinline__ int block_scan(int v, int* total, int tid,
                                          int nthreads) {
  __shared__ int warp_sum[32];
  const int lane = tid & 31, w = tid >> 5, nw = nthreads >> 5;
  int x = v;
  #pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? warp_sum[lane] : 0;
    #pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    warp_sum[lane] = s;   // inclusive over warps
  }
  __syncthreads();
  const int before = (w ? warp_sum[w - 1] : 0) + x - v;
  *total = warp_sum[nw - 1];
  __syncthreads();
  return before;
}

// A tile's list seg[0, n) of distinct particle indices below N, in no
// order -> ascending in out[0, n): per window of W indices (``bits``: W / 32
// words of shared memory) a bitmap, compacted in order with a block scan.
// Every thread of the block calls it; it ends with a barrier.
__device__ void order_list(const int* seg, int n, int N, unsigned* bits,
                           int W, int* out, int tid, int nthreads) {
  int done = 0;
  for (int base = 0; base < N && done < n; base += W) {
    const int nw = (min(W, N - base) + 31) / 32;
    for (int w = tid; w < nw; w += nthreads) bits[w] = 0u;
    __syncthreads();
    for (int q = tid; q < n; q += nthreads) {
      const int k = seg[q] - base;
      if (k >= 0 && k < W) atomicOr(&bits[k >> 5], 1u << (k & 31));
    }
    __syncthreads();
    const int per = (nw + nthreads - 1) / nthreads;
    const int w0 = min(tid * per, nw), w1 = min(w0 + per, nw);
    int mine = 0;
    for (int w = w0; w < w1; ++w) mine += __popc(bits[w]);
    int total;
    int pos = done + block_scan(mine, &total, tid, nthreads);
    for (int w = w0; w < w1; ++w)
      for (unsigned m = bits[w]; m; m &= m - 1u)
        out[pos++] = base + 32 * w + __ffs(m) - 1;
    done += total;
    __syncthreads();
  }
}

// A short list (n <= kRankMax, every index distinct) in order the cheap
// way: each thread ranks its entries against all n in shared memory
// (``keys``: n ints).  Every thread of the block calls it; it ends with a
// barrier.
__device__ void rank_list(const int* seg, int n, int* keys, int* out,
                          int tid, int nthreads) {
  for (int q = tid; q < n; q += nthreads) keys[q] = seg[q];
  __syncthreads();
  for (int q = tid; q < n; q += nthreads) {
    const int k = keys[q];
    int rank = 0;
    for (int o = 0; o < n; ++o) rank += keys[o] < k;
    out[rank] = k;
  }
  __syncthreads();
}

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
  CompositePlan tp;
};

// One warp's walk over a tile's depth-ordered list: the warp owns a
// kRowsPerThread x 32 sub-tile (lane = column, its rows a lane's) and
// takes only the particles whose box meets it; warps synchronise only
// within themselves, so a warp that a particle misses does not wait for it.
struct Warp {
  int wy0, wx0, X, lane;
  bool colin;
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

// the sub-tile's cells inside box b: rows [*ya, *yb], columns [*xa, *xb]
__device__ __forceinline__ bool sub_cells(const CompArgs& a, const Warp& w,
                                          const int4& b, int* ya, int* yb,
                                          int* xa, int* xb) {
  *ya = max(w.wy0, b.x);
  *yb = min(min(w.wy0 + kRowsPerThread, b.y), a.p.Hc) - 1;
  *xa = max(w.wx0, b.z);
  *xb = min(min(w.wx0 + 32, b.w), a.p.Wc) - 1;
  return *ya <= *yb && *xa <= *xb;
}

__device__ __forceinline__ unsigned meets(const CompArgs& a, const Warp& w,
                                          const Entry& e) {
  int ya, yb, xa, xb;
  return __ballot_sync(0xffffffffu,
                       e.k >= 0 && sub_cells(a, w, e.b, &ya, &yb, &xa, &xb));
}

// rnd(wy0 * rnd(P[k0, m]) + wy1 * rnd(P[k0 + 1, m])) over a plane whose rows
// are rs apart (warp_common.cuh's up_y, its address formed once; taps
// outside the plane weigh 0 and are not read)
template <typename PT>
__device__ __forceinline__ float up_y_rs(const float* P, int rs, int RM,
                                         int k0, float wy0, float wy1,
                                         int m) {
  float s = 0.f;
  if (m >= 0 && m < RM) {
    const int at = k0 * rs + m;
    if (k0 >= 0 && k0 < RM) s = __fmul_rn(wy0, rnd<PT>(P[at]));
    if (k0 + 1 >= 0 && k0 + 1 < RM)
      s = __fadd_rn(s, __fmul_rn(wy1, rnd<PT>(P[at + rs])));
  }
  return rnd<PT>(s);
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
    const float t2a = up_y_rs<PT>(P2p, rs, RM, k0, wy0, wy1, m0);
    const float t2b = up_y_rs<PT>(P2p, rs, RM, k0, wy0, wy1, m0 + 1);
    float t1a = 0.f, t1b = 0.f;
    if (LIT) {
      t1a = up_y_rs<PT>(P1p, rs, RM, k0, wy0, wy1, m0);
      t1b = up_y_rs<PT>(P1p, rs, RM, k0, wy0, wy1, m0 + 1);
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
  const CompositePlan& tp = a.tp;
  CT* canvas = static_cast<CT*>(a.canvas);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTileW + tx;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int X = tx0 + tx, Ybase = ty0 + ty * kRowsPerThread;
  const size_t plane = (size_t)p.Hc * p.Wc;
  const bool colin = X < p.Wc;
  const int nt = tp.ntx * tp.nty;
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

  // this tile's list, in depth order: in shared memory, or (longer than
  // kChunk) in its slots of ``lists``.  A list that did not fit its slots:
  // every particle, tested by each warp
  const size_t at = (size_t)t * tp.capt;
  const int* raw = a.scratch + nt;
  int* ordered =
      n <= kChunk ? list : a.scratch + nt + (size_t)nt * tp.capt + at;
  if (n <= tp.capt) {
    if (n <= kRankMax)
      rank_list(raw + at, n, reinterpret_cast<int*>(bits), ordered, tid,
                kThreads);
    else
      order_list(raw + at, n, p.N, bits, kBits, ordered, tid, kThreads);
  }
  const Warp w{Ybase, tx0 + (tx & 32), X, tx & 31, colin};
  walk<CT, PT, LIT, ILV>(a, w, n <= tp.capt ? ordered : nullptr,
                         n <= tp.capt ? n : p.N, C, T);

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

// scratch of a launch: cnt [ntiles] (zeroed here), raw and lists [ntiles,
// capt] each; the memset and the fill kernel
static int fill_lists(const int* box, const int* valid, int N,
                      CompositePlan tp, int* scratch, cudaStream_t st) {
  const int nt = tp.ntx * tp.nty;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)nt * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (N)
    tile_fill_kernel<<<(N + 7) / 8, 256, 0, st>>>(
        (const int4*)box, valid, N, tp, scratch, scratch + nt);
  return (int)cudaGetLastError();
}

static bool bad_plan(const CompositeParams& p, const CompositePlan& tp) {
  return tp.ntx != (p.Wc + kTileW - 1) / kTileW ||
         tp.nty != (p.Hc + kTileH - 1) / kTileH || tp.capt < 0;
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
                                   CompositeParams p, CompositePlan tp,
                                   int* scratch, void* stream) {
  if (bad_plan(p, tp) || ((uintptr_t)box & 15))
    return (int)cudaErrorInvalidValue;
  return fill_lists(box, valid, p.N, tp, scratch, (cudaStream_t)stream);
}

// the lists' fill, then the composite: two kernels (and a memset)
extern "C" int warp_composite_launch(void* canvas, int canvas_bf16,
                                     const float* pm, int place_bf16,
                                     const float* ayf, const float* axf,
                                     const int* box, const float* cc,
                                     const float* cc2, const int* valid,
                                     CompositeParams p, CompositePlan tp,
                                     int* scratch, void* stream) {
  if ((p.lit && !cc2) || ((uintptr_t)box & 15) || bad_plan(p, tp))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int e = fill_lists(box, valid, p.N, tp, scratch, st);
  if (e) return e;
  const CompArgs a{canvas, pm, ayf, axf, (const int4*)box, cc,
                   p.lit ? cc2 : nullptr, valid, scratch, p, tp};
  if (canvas_bf16)
    return place_bf16 ? launch_p<__nv_bfloat16, __nv_bfloat16>(a, st)
                      : launch_p<__nv_bfloat16, float>(a, st);
  return place_bf16 ? launch_p<float, __nv_bfloat16>(a, st)
                    : launch_p<float, float>(a, st);
}
