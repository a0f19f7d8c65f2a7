// tile_lists.cuh: per-tile lists of the rects that meet each canvas tile,
// built inside a composite's launch, for the two composite kernels for
// Hopper (sm_90a): kernel B (warp_composite.cu; the rects are the
// particles' placement boxes, the list entries particle indices in depth
// order) and kernel D (composite_chunk.cu; the rects are the images'
// RP x RP rects, the entries composite positions).
//
// A launch is a memset of the tiles' counts, the fill kernel and the
// composite: the fill (a warp an entry, its lanes over the tiles) appends
// entry q to the slots of every tile of the TILE_H x TILE_W grid its rect
// meets -- a fixed number of slots a tile (capt), sized on the host from
// the tiles a rect can meet (volq_torch/render/kernel.py:_tile_plan);
// atomics, so in no order, and each tile counts its whole list even past
// its slots.  The composite's block then puts its tile's list in ascending
// order -- ranking a short list, or through a bitmap of entry indices in
// shared memory (windows of indices, so any count and any length keep the
// order) -- and walks it a warp per 4 x 32 sub-tile.  A tile whose list did
// not fit its slots has every entry tested instead (tile_list returns
// null); a tile no rect meets returns at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kTileW = 64, kTileH = 16, kRowsPerThread = 4;
constexpr int kThreads = kTileW * (kTileH / kRowsPerThread);
constexpr int kChunk = 1024;          // a list held in shared memory
constexpr int kRankMax = 256;         // lists ordered by ranking
constexpr int kBits = 65536;          // B's bitmap window of the list order

// mirrors CompositePlan in volq_torch/render/kernel.py: the tile grid and
// the list slots of a tile (capt)
struct TilePlan {
  int ntx, nty, capt;
};

// a plan that does not cover the [Hc, Wc] canvas with its tiles, or whose
// slots are not within [0, N]
static bool tile_plan_bad(int Hc, int Wc, int N, const TilePlan& tp) {
  return tp.ntx != (Wc + kTileW - 1) / kTileW ||
         tp.nty != (Hc + kTileH - 1) / kTileH || tp.capt < 0 ||
         tp.capt > (N > 0 ? N : 0);
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Each entry q < N whose rect rects(q, &b) gives (a valid one, with a
// non-empty rect b = (y0, y1, x0, x1)) is appended to the slots of every
// tile its rect meets (tile t: raw[t * capt, ...), cnt[t] entries wanted,
// the first capt kept), in no order.  A warp an entry, its lanes over the
// tiles, so that a large rect's appends run side by side.
template <typename Rects>
__global__ void tile_fill_kernel(const Rects rects, int N, TilePlan tp,
                                 int* __restrict__ cnt,
                                 int* __restrict__ raw) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  int4 b;
  if (q >= N || !rects(q, &b)) return;
  if (b.y <= b.x || b.w <= b.z) return;
  const int y0 = max(floor_div(b.x, kTileH), 0);
  const int y1 = min(floor_div(b.y - 1, kTileH), tp.nty - 1);
  const int x0 = max(floor_div(b.z, kTileW), 0);
  const int x1 = min(floor_div(b.w - 1, kTileW), tp.ntx - 1);
  const int nx = x1 - x0 + 1, ntiles = (y1 - y0 + 1) * nx;
  for (int i = lane; i < ntiles && nx > 0; i += 32) {
    const int t = (y0 + i / nx) * tp.ntx + x0 + i % nx;
    const int at = atomicAdd(&cnt[t], 1);
    if (at < tp.capt) raw[(size_t)t * tp.capt + at] = q;
  }
}

// The scratch of a launch -- cnt [ntiles] (zeroed here), raw and lists
// [ntiles, capt] each -- filled: the memset and the fill kernel.
template <typename Rects>
static int fill_lists(const Rects& rects, int N, const TilePlan& tp,
                      int* scratch, cudaStream_t st) {
  const int nt = tp.ntx * tp.nty;
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)nt * sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  if (N)
    tile_fill_kernel<Rects><<<(N + 7) / 8, 256, 0, st>>>(
        rects, N, tp, scratch, scratch + nt);
  return (int)cudaGetLastError();
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

// A tile's list seg[0, n) of distinct entries below N, in no order ->
// ascending in out[0, n): per window of W indices (``bits``: W / 32 words
// of shared memory) a bitmap, compacted in order with a block scan.  Every
// thread of the block calls it; it ends with a barrier.
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

// A short list (n <= kRankMax, every entry distinct) in order the cheap
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

// Tile t's list, its n entries (below N) ascending: in ``list`` (shared,
// kChunk ints), or -- longer than that -- in the tile's slots of the
// scratch's ordered lists.  Null where the list did not fit its slots: the
// walk then tests every entry.  ``bits``: W / 32 words of shared memory
// (the bitmap window, at least kRankMax * 32).  Every thread of the block
// calls it.
__device__ __forceinline__ const int* tile_list(int* scratch, int t, int n,
                                                int N, const TilePlan& tp,
                                                int* list, unsigned* bits,
                                                int W, int tid) {
  if (n > tp.capt) return nullptr;
  const int nt = tp.ntx * tp.nty;
  const size_t at = (size_t)t * tp.capt;
  const int* raw = scratch + nt + at;
  int* ordered = n <= kChunk ? list : scratch + nt + (size_t)nt * tp.capt + at;
  if (n <= kRankMax)
    rank_list(raw, n, reinterpret_cast<int*>(bits), ordered, tid, kThreads);
  else
    order_list(raw, n, N, bits, W, ordered, tid, kThreads);
  return ordered;
}

// One warp's part of a tile: a kRowsPerThread x 32 sub-tile (lane =
// column, its rows a lane's) with rows from wy0, columns from X - lane;
// warps synchronise only within themselves, so a warp whose sub-tile a
// rect misses does not wait for it.
struct Warp {
  int wy0, wx0, X, lane;
  bool colin;
};

// the sub-tile's cells inside rect b, clipped to the [Hc, Wc] canvas: rows
// [*ya, *yb], columns [*xa, *xb]
__device__ __forceinline__ bool sub_cells(const Warp& w, const int4& b, int Hc,
                                          int Wc, int* ya, int* yb, int* xa,
                                          int* xb) {
  *ya = max(w.wy0, b.x);
  *yb = min(min(w.wy0 + kRowsPerThread, b.y), Hc) - 1;
  *xa = max(w.wx0, b.z);
  *xb = min(min(w.wx0 + 32, b.w), Wc) - 1;
  return *ya <= *yb && *xa <= *xb;
}
