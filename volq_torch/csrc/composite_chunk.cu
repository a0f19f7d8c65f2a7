// composite_chunk: the unfused path's canvas composite, for Hopper (sm_90a).
//
// Replaces: volq/render/kernel.py:composite_chunk_pallas -- the front-to-back
// OVER of one depth-ordered chunk of per-particle images [n, 4, RP, RP]
// (premultiplied RGB in [:3], transmittance 1 - P2 in [3], working type) onto
// the legacy canvas [4, Hc, Wc] (bf16 or fp32), in place.  Image k lands with
// its top-left pixel at canvas (oy[k], ox[k]) (the caller clips the origins
// as the reference does); an optional ``order`` gives the composite order as
// a permutation of the chunk (composite position q takes image order[q]).
// Per covered pixel, in order:
//   C_ch = cdt(f32(C_ch) + Tw * f32(img_ch)),   T = cdt(Tw * f32(img_3)),
// Tw the pixel's transmittance before this image.
//
// Design.  The TPU kernel ran a sequential grid over the images, moving each
// one's 8 x 128-aligned canvas window through double-buffered DMAs, placing
// the image inside it with circular rolls of an identity-padded buffer and
// guarding overlapping windows with flags.  None of that carries over: as in
// warp_composite.cu the order moves inside the block, over the per-tile
// lists of tile_lists.cuh.  A launch is a memset, the fill and the walk: the
// fill appends each composite position q to the slots of every 16 x 64
// canvas tile that its image's rect [oy, oy+RP) x [ox, ox+RP) meets (k =
// order[q] when the order is given); each tile's block orders its list
// ascending, which is composite order, and keeps the tile in registers.
// Each warp walks the list over its 4 x 32 sub-tile, 32 entries at a time,
// compositing the images whose rect meets the sub-tile.  A pixel's images
// are a chain of dependent read-modify-writes, so the walk is bound by the
// latency of the image reads, not by their bytes: each lane reads its 4 x 4
// values of an image through a ring of kChunkRing slots of its own in
// shared memory, a 4-byte cp.async each, so that the next kChunkRing - 1
// images' reads are in flight while one image is composited.  (Rings of 2
// and 4 slots, and a register pipeline one image ahead, were measured
// slower on c4's unfused frames; PERF.md section 6.)  A bf16 value is
// copied as the aligned 4-byte word that holds it: for the images' first
// or last value that word may reach 2 bytes outside the tensor, which the
// wrapper (render/kernel.py:composite_chunk) requires to lie inside the
// tensor's storage.  A lane reads only the slots it filled, so the ring
// needs no barrier.  Each canvas pixel is read once and written at most
// once per launch and per-pixel order is exact; pixels outside every image
// are untouched, which is what the reference's identity ring (C += 0,
// T *= 1) amounts to.
//
// Bound on this card: bytes -- the images are read once (c4: 151 MB per
// megachunk) and the canvas cells some image covers go in and out.
//
// Built with --fmad=false; the RMW spells its roundings out with __fmul_rn /
// __fadd_rn, so the canvas is bit-equal to the plain PyTorch version.

#include "warp_common.cuh"
#include "stage_ring.cuh"
#include "tile_lists.cuh"

struct ChunkParams {
  int n, RP, Hc, Wc;
};

// the fill's rects: composite position q's image rect (y0, y1, x0, x1)
struct ChunkRects {
  const int* oy;
  const int* ox;
  const int* order;
  int RP;
  __device__ __forceinline__ bool operator()(int q, int4* b) const {
    const int k = order ? order[q] : q;
    const int y0 = oy[k], x0 = ox[k];
    *b = make_int4(y0, y0 + RP, x0, x0 + RP);
    return true;
  }
};

// Everything a launch takes, as one kernel parameter read in place
struct ChunkArgs {
  void* canvas;
  const void* images;
  const int* oy;
  const int* ox;
  const int* order;
  int* scratch;   // cnt [ntiles] | raw [ntiles, capt] | lists [ntiles, capt]
  ChunkParams p;
  TilePlan tp;
};

// D's bitmap window of the list order: 4 KB of shared memory, so that three
// blocks an SM keep their rings
constexpr int kChunkBits = 32768;

// the slots of each lane's ring of image reads: two images' reads in flight
// ahead of the one composited
constexpr int kChunkRing = 3;

// 4 bytes from device memory into shared memory, asynchronously
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// a value from the aligned 4-byte word that holds it (bf16: the upper half
// where the value's element index is odd)
template <typename IT>
__device__ __forceinline__ float from_word(unsigned w, unsigned odd);
template <>
__device__ __forceinline__ float from_word<float>(unsigned w, unsigned) {
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float from_word<__nv_bfloat16>(unsigned w,
                                                          unsigned odd) {
  return __uint_as_float(odd ? w & 0xffff0000u : w << 16);
}

// a slot of the walk: whether it holds an image (v, the same for the whole
// warp), the rows [ra, rb) of this lane's column the image covers (none
// where rb <= ra) and the parity of its element index at row 0, channel 0
struct Flight {
  bool v;
  int ra, rb, odd;
};

// at most 85 registers a thread: three blocks an SM, each with its ring of
// 48 KB and 8 KB of list and bitmap
template <typename CT, typename IT>
__global__ void __launch_bounds__(kThreads, 3)
composite_chunk_kernel(const __grid_constant__ ChunkArgs a) {
  extern __shared__ __align__(16) unsigned char dsm[];
  __shared__ int list[kChunk];
  __shared__ unsigned bits[kChunkBits / 32];   // the list order's room
  const ChunkParams& p = a.p;
  CT* canvas = static_cast<CT*>(a.canvas);
  const IT* images = static_cast<const IT*>(a.images);
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTileW + tx;
  const int ty0 = blockIdx.y * kTileH, tx0 = blockIdx.x * kTileW;
  const int X = tx0 + tx, Ybase = ty0 + ty * kRowsPerThread;
  const size_t plane = (size_t)p.Hc * p.Wc;
  const bool colin = X < p.Wc;
  const int t = blockIdx.y * a.tp.ntx + blockIdx.x, n = a.scratch[t];
  if (n == 0) return;   // no image meets the tile: its pixels stay

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

  // this tile's composite positions, ascending (null: the list did not fit
  // its slots, and each warp tests every position)
  const int* ord =
      tile_list(a.scratch, t, n, p.n, a.tp, list, bits, kChunkBits, tid);
  const int cnt = ord ? n : p.n;
  const Warp w{Ybase, tx0 + (tx & 32), X, tx & 31, colin};
  const int RP = p.RP, PP = RP * RP;

  // the next image of the list whose rect meets the warp's sub-tile (its
  // index and origin; false past the end): the lanes test 32 list entries
  // at a time, and the hits are taken in order from the lane that holds
  // each
  int base = -32, mk = -1, my0 = 0, mx0 = 0;
  unsigned hit = 0u;
  auto next = [&](int* k, int* y0, int* x0) -> bool {
    while (!hit) {
      base += 32;
      if (base >= cnt) return false;
      const int q = base + w.lane;
      mk = -1;
      if (q < cnt) {
        const int pos = ord ? ord[q] : q;
        mk = a.order ? a.order[pos] : pos;
        my0 = a.oy[mk];
        mx0 = a.ox[mk];
      }
      int ya, yb, xa, xb;
      hit = __ballot_sync(
          0xffffffffu,
          mk >= 0 && sub_cells(w, make_int4(my0, my0 + RP, mx0, mx0 + RP),
                               p.Hc, p.Wc, &ya, &yb, &xa, &xb));
    }
    const int src = __ffs(hit) - 1;
    hit &= hit - 1u;
    *k = __shfl_sync(0xffffffffu, mk, src);
    *y0 = __shfl_sync(0xffffffffu, my0, src);
    *x0 = __shfl_sync(0xffffffffu, mx0, src);
    return true;
  };

  // The ring: slots [kChunkRing][rows][channels][kThreads] 4-byte words, a
  // lane's
  // at its tid (conflict-free).  Row r, channel ch of an image lies
  // r * RP + ch * PP elements past its row 0, channel 0; ``parity`` holds
  // those offsets' parities, bit r * 4 + ch.
  unsigned* ring = reinterpret_cast<unsigned*>(dsm) + tid;
  // bf16: the parity of the images' first element's address in elements
  const int base_odd = sizeof(IT) == 2 ? ((uintptr_t)images >> 1) & 1 : 0;
  unsigned parity = 0u;
  #pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
    #pragma unroll
    for (int ch = 0; ch < 4; ++ch)
      parity |= (unsigned)((r * RP + ch * PP) & 1) << (r * 4 + ch);
  // image (k, y0, x0)'s values of this lane into ring slot ``slot`` (no
  // image: none), and what the composite needs of it
  auto request = [&](int slot, bool v, int k, int y0, int x0) -> Flight {
    Flight f{v, 0, 0, 0};
    const int xo = X - x0;
    if (v && colin && xo >= 0 && xo < RP) {
      f.ra = max(y0 - Ybase, 0);
      f.rb = min(min(y0 + RP - Ybase, p.Hc - Ybase), kRowsPerThread);
      const long long e0 = (long long)k * 4 * PP + (Ybase - y0) * RP + xo;
      f.odd = (int)((e0 + base_odd) & 1);
      unsigned* dst = ring + slot * (kRowsPerThread * 4 * kThreads);
      #pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        if (r < f.ra || r >= f.rb) continue;
        const IT* row = images + e0 + r * RP;
        #pragma unroll
        for (int ch = 0; ch < 4; ++ch)
          cp_async4(dst + (r * 4 + ch) * kThreads,
                    (const void*)((uintptr_t)(row + ch * PP) &
                                  ~(uintptr_t)3));
      }
    }
    cp_async_commit();
    return f;
  };
  // the OVER of the image in slot ``slot`` onto this lane's pixels
  bool dirty = false;
  auto over = [&](int slot, const Flight& f) {
    const unsigned odd = f.odd ? ~parity : parity;
    const unsigned* src = ring + slot * (kRowsPerThread * 4 * kThreads);
    #pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      if (r < f.ra || r >= f.rb) continue;
      float v[4];
      #pragma unroll
      for (int ch = 0; ch < 4; ++ch)
        v[ch] = from_word<IT>(src[(r * 4 + ch) * kThreads],
                              (odd >> (r * 4 + ch)) & 1u);
      const float Tw = T[r];
      #pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        C[r][ch] = rnd<CT>(__fadd_rn(C[r][ch], __fmul_rn(Tw, v[ch])));
      T[r] = rnd<CT>(__fmul_rn(Tw, v[3]));
      dirty = true;
    }
  };
  // the walk: kChunkRing - 1 images' reads in flight ahead of the one
  // composited (fl[0] the oldest; once the list has no more hits, no later
  // one is an image either)
  constexpr int L = kChunkRing - 1;
  Flight fl[kChunkRing];
  bool more = true;
  #pragma unroll
  for (int d = 0; d < L; ++d) {
    int k = 0, y0 = 0, x0 = 0;
    more = more && next(&k, &y0, &x0);
    fl[d] = request(d, more, k, y0, x0);
  }
  for (int i = 0; fl[0].v; ++i) {
    cp_async_wait_pending(kChunkRing - 2);   // image i has landed
    int k = 0, y0 = 0, x0 = 0;
    more = more && next(&k, &y0, &x0);
    fl[L] = request((i + L) % kChunkRing, more, k, y0, x0);
    over(i % kChunkRing, fl[0]);
    #pragma unroll
    for (int d = 0; d < L; ++d) fl[d] = fl[d + 1];
  }
  cp_async_wait_pending(0);

  if (!dirty) return;
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

template <typename CT, typename IT>
static int launch_d(const ChunkArgs& a, cudaStream_t st) {
  dim3 block(kTileW, kTileH / kRowsPerThread), grid(a.tp.ntx, a.tp.nty);
  const int smem = kChunkRing * kRowsPerThread * 4 * kThreads * 4;
  auto kern = composite_chunk_kernel<CT, IT>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, block, smem, st>>>(a);
  return (int)cudaGetLastError();
}

static bool bad_chunk(const ChunkParams& p, const TilePlan& tp) {
  return p.n < 0 || p.RP < 1 || tile_plan_bad(p.Hc, p.Wc, p.n, tp);
}

// the per-tile lists' fill alone (the first kernel of composite_chunk_launch:
// tile t's cnt[t] and its first min(cnt[t], capt) slots, in no order)
extern "C" int composite_chunk_fill(const int* oy, const int* ox,
                                    const int* order, ChunkParams p,
                                    TilePlan tp, int* scratch, void* stream) {
  if (bad_chunk(p, tp)) return (int)cudaErrorInvalidValue;
  return fill_lists(ChunkRects{oy, ox, order, p.RP}, p.n, tp, scratch,
                    (cudaStream_t)stream);
}

// the lists' fill, then the walk: two kernels (and a memset)
extern "C" int composite_chunk_launch(void* canvas, int canvas_bf16,
                                      const void* images, int images_bf16,
                                      const int* oy, const int* ox,
                                      const int* order, ChunkParams p,
                                      TilePlan tp, int* scratch,
                                      void* stream) {
  if (bad_chunk(p, tp)) return (int)cudaErrorInvalidValue;
  if (p.n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  int e = fill_lists(ChunkRects{oy, ox, order, p.RP}, p.n, tp, scratch, st);
  if (e) return e;
  const ChunkArgs a{canvas, images, oy, ox, order, scratch, p, tp};
  if (canvas_bf16)
    return images_bf16 ? launch_d<__nv_bfloat16, __nv_bfloat16>(a, st)
                       : launch_d<__nv_bfloat16, float>(a, st);
  return images_bf16 ? launch_d<float, __nv_bfloat16>(a, st)
                     : launch_d<float, float>(a, st);
}
