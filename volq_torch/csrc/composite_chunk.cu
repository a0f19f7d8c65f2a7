// composite_chunk: the unfused path's canvas composite, for Hopper (sm_90a).
//
// Replaces: volq/render/kernel.py:composite_chunk_pallas -- the front-to-back
// OVER of one depth-ordered chunk of per-particle images [n, 4, RP, RP]
// (premultiplied RGB in [:3], transmittance 1 - P2 in [3], working type) onto
// the legacy canvas [4, Hc, Wc] (bf16 or fp32), in place.  Image k lands with
// its top-left pixel at canvas (oy[k], ox[k]) (the caller clips the origins
// as the reference does); an optional ``order`` gives the composite order as
// a permutation of the chunk.  Per covered pixel, in order:
//   C_ch = cdt(f32(C_ch) + Tw * f32(img_ch)),   T = cdt(Tw * f32(img_3)),
// Tw the pixel's transmittance before this image.
//
// Design.  The TPU kernel ran a sequential grid over the images, moving each
// one's 8 x 128-aligned canvas window through double-buffered DMAs, placing
// the image inside it with circular rolls of an identity-padded buffer and
// guarding overlapping windows with flags.  None of that carries over: as in
// warp_composite.cu the order moves inside the block.  One block per 16 x 64
// canvas tile keeps the tile in registers and walks the chunk in composite
// order, skipping images whose rect misses the tile (warp 0 compacts the
// list with ballots, keeping the order).  Each canvas pixel is read once and
// written at most once per launch and per-pixel order is exact; pixels
// outside every image are untouched, which is what the reference's identity
// ring (C += 0, T *= 1) amounts to.
//
// Bound on this card: bytes -- the images are read once (c4: 151 MB per
// megachunk) and the canvas goes in and out (2 x 23 MB bf16).
//
// Built with --fmad=false; the RMW spells its roundings out with __fmul_rn /
// __fadd_rn, so the canvas is bit-equal to the plain PyTorch version.

#include "warp_common.cuh"

struct ChunkParams {
  int n, RP, Hc, Wc;
};

constexpr int kTileW = 64, kTileH = 16, kRowsPerThread = 4;
constexpr int kChunk = 1024;

template <typename CT, typename IT>
__global__ void __launch_bounds__(kTileW * (kTileH / kRowsPerThread))
composite_chunk_kernel(CT* __restrict__ canvas, const IT* __restrict__ images,
                       const int* __restrict__ oy, const int* __restrict__ ox,
                       const int* __restrict__ order, ChunkParams p) {
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

  const int RP = p.RP, PP = RP * RP;
  const int lane = threadIdx.x & 31;
  const bool warp0 = ty == 0 && tx < 32;
  bool dirty = false;
  for (int base = 0; base < p.n; base += kChunk) {
    // ordered compaction of the images whose rect meets this tile
    if (warp0) {
      int cnt = 0;
      for (int qb = base; qb < min(base + kChunk, p.n); qb += 32) {
        const int q = qb + lane;
        bool hit = false;
        int k = 0;
        if (q < p.n) {
          k = order ? order[q] : q;
          const int y0 = oy[k], x0 = ox[k];
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
      const int xo = X - ox[k];
      if (!colin || xo < 0 || xo >= RP) continue;
      const int y0 = oy[k];
      const IT* img = images + (size_t)k * 4 * PP;
      #pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int yo = Ybase + r - y0;
        if (yo < 0 || yo >= RP || Ybase + r >= p.Hc) continue;
        const int e = yo * RP + xo;
        const float Tw = T[r];
        #pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          C[r][ch] = rnd<CT>(__fadd_rn(
              C[r][ch], __fmul_rn(Tw, ldf<IT>(img + ch * PP + e))));
        T[r] = rnd<CT>(__fmul_rn(Tw, ldf<IT>(img + 3 * PP + e)));
        dirty = true;
      }
    }
    __syncthreads();
  }

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
static void launch_d(void* canvas, const void* images, const int* oy,
                     const int* ox, const int* order, ChunkParams p,
                     cudaStream_t st) {
  dim3 block(kTileW, kTileH / kRowsPerThread);
  dim3 grid((p.Wc + kTileW - 1) / kTileW, (p.Hc + kTileH - 1) / kTileH);
  composite_chunk_kernel<CT, IT><<<grid, block, 0, st>>>(
      (CT*)canvas, (const IT*)images, oy, ox, order, p);
}

extern "C" int composite_chunk_launch(void* canvas, int canvas_bf16,
                                      const void* images, int images_bf16,
                                      const int* oy, const int* ox,
                                      const int* order, ChunkParams p,
                                      void* stream) {
  if (p.n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (canvas_bf16 && images_bf16)
    launch_d<__nv_bfloat16, __nv_bfloat16>(canvas, images, oy, ox, order, p,
                                           st);
  else if (canvas_bf16)
    launch_d<__nv_bfloat16, float>(canvas, images, oy, ox, order, p, st);
  else if (images_bf16)
    launch_d<float, __nv_bfloat16>(canvas, images, oy, ox, order, p, st);
  else
    launch_d<float, float>(canvas, images, oy, ox, order, p, st);
  return (int)cudaGetLastError();
}
