// probe_window: which offsets a window copy accepts on Hopper (sm_90a), and
// at what price.
//
// Replaces: bench/granule_probe.py:run -- N = 4096 windows [8, 128] of a
// [1088, 2048] fp32 canvas in device memory, in order: fetch the window,
// add 1, write it back, at offsets whose y is 8-aligned and whose x is
// aligned to 128, 16 or 8 elements.  On the TPU it asked whether the DMA
// engine takes a lane offset finer than the 128-lane tile.  The card's
// version: kernels B and D read-modify-write canvas tiles; what does a
// window cost when its rows no longer start on a 128-byte line, and does
// the copy engine (TMA) take an offset finer than 16 bytes?
//
// The order matters only where two windows share a cell.  y is a multiple
// of 8 (the reference's contract; the wrapper checks it) and a window is 8
// rows high, so two windows share a cell only if they have the same y and
// |dx| < 128: windows of different 8-row bands are independent.  So a block
// takes one band (grid: one block per band) and finds that band's windows
// in the order given by scanning the offsets itself (``band_list``).  It
// walks them through a ring of kDepth window slots, fetching a window as
// soon as every earlier window of the band that it overlaps has been
// written back (``Lookahead``: a sliding run of 32 windows, one a lane, each
// with the mask of the earlier ones it overlaps), so a window held back
// does not hold back the independent windows after it.  Within a band of
// the reference's offsets most windows overlap one of the 7 before them,
// but the longest chain of windows each overlapping an earlier one is 8-14.
//
// Two arms.  ``cp_async`` (x a multiple of 4 elements, 16 bytes): warp w
// owns row w of every window of the band -- a window's rows are the same
// canvas rows for all of the band's windows, so the warps never share a
// cell and need no barrier between them.  Lane l copies the 16 bytes at
// column 4 l with cp.async into its slot of the warp's ring, waits for the
// group, adds 1, stores the 16 bytes back; a __syncwarp orders the store
// before every lane's later fetches.  ``tma`` (any x): a 2-D tensor map on
// the canvas with an [8, 128] box, loads and stores at element coordinates
// -- which the copy engine takes only in multiples of 16 bytes, so a window
// at any other x moves as an [8, 132] box from x & ~3 (below).  A producer
// warp's lane 0 issues every TMA load (completing on the slot's ``full``
// mbarrier) and every TMA store (one bulk group each); the 8 row warps add
// 1 to their row of the slot, fence the generic writes for the async proxy
// (fence.proxy.async.shared::cta) and arrive on the slot's ``ready``
// mbarrier, which the producer waits on before the store.  A slot is
// refilled once its store has read it (wait_group.read); a window that
// overlaps an earlier one is fetched only once that window's store has
// completed (wait_group 0, then fence.proxy.async.global).  No block-wide
// barrier in either arm's walk.
//
// Bound on this card: the larger of the bytes (each cell the windows cover
// read once and written once, the offsets read once) and the chain: the
// longest run of windows each overlapping an earlier one, times one
// dependent load -> add -> store -> load round trip through L2
// (``window_rt_kernel`` below times that on the card).
//
// Adding 1.0f to an fp32 count is exact: bit-equal to the plain loop.

#include "hopper.cuh"
#include "probe_common.cuh"

constexpr int kWH = 8, kWW = 128;
constexpr int kRowThreads = 32 * kWH;          // a warp per window row
constexpr int kTmaThreads = kRowThreads + 32;  // + the producer warp
constexpr int kDepth = 8;                      // window slots in flight
constexpr int kMaxList = 4096;                 // windows a launch
constexpr int kChunks = kMaxList / kRowThreads;  // offsets a thread scans
constexpr int kWinBytes = kWH * kWW * 4;
constexpr int kSlide = 8;   // done windows that move the lookahead on
constexpr int kFar = -(1 << 20);               // x of a lane past the band
// the tma arm's wide box (below): [8, 132] from x & ~3
constexpr int kWideW = kWW + 4;

// Whether the copies of the windows at x = a and x = b (one band) may
// share a column.  A copy moves [x, x + 128), or, where kSkew (0 or 3)
// leaves x - x0 = x & kSkew > 0, the wide box [x0, x0 + 132), which lies
// in [x - 3, x + 131): |dx| < 128 where neither box is wide (exact), else
// |dx| < 135 (a few pairs more than share a column).
template <int kSkew>
__device__ __forceinline__ bool boxes_meet(int a, int b) {
  return abs(a - b) < (((a | b) & kSkew) ? kWideW + 3 : kWW);
}

// The windows of band blockIdx.x (y == 8 * band, x inside the canvas), in
// the order given: their x into ``list``, their number returned.  Thread t
// reads windows t, t + T, ... (coalesced int2 loads, all in flight at
// once); a prefix sum of the per-warp match counts in window order places
// each match.  ``counts``: kChunks * 9 + 1 ints of shared memory.
__device__ int band_list(const int2* __restrict__ off, int n, int W,
                         int* list, int* counts) {
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5, nwarps = T >> 5;
  const int y = kWH * blockIdx.x;
  int xs[kChunks];
  unsigned hit = 0;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int i = k * T + tid;
    xs[k] = 0;
    if (i < n) {
      const int2 v = __ldg(off + i);
      xs[k] = v.y;
      if (v.x == y && v.y >= 0 && v.y <= W - kWW) hit |= 1u << k;
    }
  }
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned b = __ballot_sync(~0u, (hit >> k) & 1);
    if (lane == 0) counts[k * nwarps + warp] = __popc(b);
  }
  __syncthreads();
  if (warp == 0) {                     // exclusive, in window order
    const int m = kChunks * nwarps;
    int carry = 0;
    for (int b = 0; b < m; b += 32) {
      const int c = b + lane < m ? counts[b + lane] : 0;
      int inc = c;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(~0u, inc, o);
        if (lane >= o) inc += v;
      }
      if (b + lane < m) counts[b + lane] = carry + inc - c;
      carry += __shfl_sync(~0u, inc, 31);
    }
    if (lane == 0) counts[m] = carry;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const unsigned b = __ballot_sync(~0u, (hit >> k) & 1);
    if ((hit >> k) & 1)
      list[counts[k * nwarps + warp] + __popc(b & below)] = xs[k];
  }
  const int nb = counts[kChunks * nwarps];
  __syncthreads();
  return nb;
}

// A warp's view of the band's windows [base, base + 32), window base + l
// on lane l: its x and ``dep``, the mask of the windows base + i, i < l,
// whose boxes may share a column with its own (``boxes_meet``: |dx| <
// 128 where neither box is widened).  ``done`` (written back where every
// later fetch sees it) and ``issued`` (fetched) are masks over the 32, the
// same on every lane.  A window may be fetched once every window of its
// ``dep`` is done: overlapping windows keep their order, and the windows
// fetched are never ones that overlap a window in flight.
template <int kSkew>
struct Lookahead {
  int base, x;
  unsigned dep, done, issued;

  // drop the k (1..32) lowest windows, all done, and take in the next k
  __device__ void slide(int k, const int* list, int nb) {
    const int lane = threadIdx.x & 31;
    base += k;
    done = k < 32 ? done >> k : 0;
    issued = k < 32 ? issued >> k : 0;
    x = __shfl_down_sync(~0u, x, k & 31);
    dep = k < 32 ? __shfl_down_sync(~0u, dep, k) >> k : 0;
    const bool fresh = lane >= 32 - k;
    if (fresh) {
      x = base + lane < nb ? list[base + lane] : kFar;
      dep = 0;
    }
#pragma unroll
    for (int i = 0; i < 31; ++i) {
      const int xi = __shfl_sync(~0u, x, i);
      if (fresh && i < lane && boxes_meet<kSkew>(xi, x)) dep |= 1u << i;
    }
  }

  __device__ void start(const int* list, int nb) {
    base = -32;
    done = issued = ~0u;
    slide(32, list, nb);
  }

  // the windows that may be fetched now
  __device__ unsigned ready(int nb) const {
    const int lane = threadIdx.x & 31;
    return __ballot_sync(~0u, base + lane < nb && !((issued >> lane) & 1) &&
                                  !(dep & ~done));
  }

  // done windows at the bottom
  __device__ int low_done() const {
    return done == ~0u ? 32 : __ffs(~done) - 1;
  }
};

// cp.async.wait_group n for a run-time n in 0..kDepth - 1
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  static_assert(kDepth == 8, "one case per slot");
  switch (n) {
    case 7: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    default: cp_async_wait_all();
  }
}

// cp.async.bulk.wait_group.read n for a run-time n in 0..kDepth - 1
__device__ __forceinline__ void bulk_wait_read_upto(int n) {
  switch (n) {
    case 7: bulk_wait_read<7>(); break;
    case 6: bulk_wait_read<6>(); break;
    case 5: bulk_wait_read<5>(); break;
    case 4: bulk_wait_read<4>(); break;
    case 3: bulk_wait_read<3>(); break;
    case 2: bulk_wait_read<2>(); break;
    case 1: bulk_wait_read<1>(); break;
    default: bulk_wait_read<0>();
  }
}

// ======================================================================
// cp_async arm: 8 warps, warp w on row w of the band's windows

__global__ void __launch_bounds__(kRowThreads)
probe_window_kernel(float* __restrict__ canvas, const int2* __restrict__ off,
                    int n, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* ring = reinterpret_cast<float4*>(smem);   // [8 warps][kDepth][32]
  int* list = reinterpret_cast<int*>(ring + kWH * kDepth * 32);
  __shared__ int counts[kChunks * 8 + 1];
  const int nb = band_list(off, n, W, list, counts);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  float* row = canvas + (size_t)(kWH * blockIdx.x + w) * W + 4 * lane;
  float4* slots = ring + w * kDepth * 32 + lane;     // slot s at [32 s]
  Lookahead<0> a;
  a.start(list, nb);
  int nfetch = 0, nstore = 0;   // windows fetched / written back, in order
  int slot_l = 0, slot_x = 0;   // lane s: the window in slot s, its x
  while (a.base < nb) {
    // fetch the ready windows, lowest first, while a slot is free
    for (unsigned r = a.ready(nb); r && nfetch - nstore < kDepth;
         r &= r - 1) {
      const int l = __ffs(r) - 1, s = nfetch % kDepth;
      const int x = __shfl_sync(~0u, a.x, l);
      cp_async16(slots + 32 * s, row + x);
      cp_async_commit();
      if (lane == s) {
        slot_l = a.base + l;
        slot_x = x;
      }
      a.issued |= 1u << l;
      ++nfetch;
    }
    // add 1 to the oldest window in flight and write it back
    if (nfetch > nstore) {
      const int s = nstore % kDepth;
      cp_async_wait_upto(nfetch - nstore - 1);
      float4 v = slots[32 * s];
      v.x += 1.f;
      v.y += 1.f;
      v.z += 1.f;
      v.w += 1.f;
      *reinterpret_cast<float4*>(row + __shfl_sync(~0u, slot_x, s)) = v;
      __syncwarp();
      a.done |= 1u << (__shfl_sync(~0u, slot_l, s) - a.base);
      ++nstore;
    }
    const int k = a.low_done();
    if (k >= kSlide || (k > 0 && nfetch == nstore))
      a.slide(k, list, nb);
  }
}

// ======================================================================
// tma arm: 8 row warps add, a producer warp loads and stores.  The copy
// engine refuses a box whose innermost coordinate is not a multiple of 16
// bytes (error 715, illegal instruction, at x = 1 and 2 on an H100), so a
// window whose x is not a multiple of 4 goes through a second map, whose
// [8, 132] box starts at x0 = x & ~3: the rows add 1 only to the window's
// 128 columns, and the store writes the 4 others back unchanged -- safe
// because the overlap test is on the boxes moved (``boxes_meet``), so no
// window in flight touches them.  kSkew 3 takes any x this way; kSkew 0
// sends every window through the [8, 128] map at its own x (what the
// launcher runs where every x is a multiple of 4; elsewhere the refusal
// itself).

constexpr int kSlotBytes = kWH * kWideW * 4;     // 4224, a multiple of 128

template <int kSkew>
__global__ void __launch_bounds__(kTmaThreads)
probe_window_tma_kernel(const __grid_constant__ CUtensorMap map,
                        const __grid_constant__ CUtensorMap wide,
                        const int2* __restrict__ off, int n, int W) {
  extern __shared__ unsigned char smem_raw[];
  // the ring (kDepth slots of up to [8][132] fp32, 128-byte aligned for
  // TMA), the mbarriers full[kDepth] and ready[kDepth], the x of the window
  // in each slot, the band's list
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 127u) & ~127u;
  unsigned char* base = smem_raw + (ring - raw);
  const uint32_t full0 = ring + kDepth * kSlotBytes;
  const uint32_t ready0 = full0 + 8 * kDepth;
  int* slot_x = reinterpret_cast<int*>(base + kDepth * kSlotBytes +
                                       16 * kDepth);
  int* list = slot_x + kDepth;
  __shared__ int counts[kChunks * 9 + 1];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < kDepth; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(ready0 + 8 * s, kWH);               // one arrival a row warp
    }
    mbar_init_fence();
  }
  // (its block barriers also publish the initialised mbarriers)
  const int nb = band_list(off, n, W, list, counts);
  const int y = kWH * blockIdx.x;

  if (warp < kWH) {
    // ---- row warp: row ``warp`` of every window, in the order of the
    // slots, float4 ``lane`` of it; in a wide box lane 0 also takes float4
    // 32, and the +1 skips the r columns before the window and the 4 - r
    // after it
    for (int d = 0; d < nb; ++d) {
      const int s = d % kDepth;
      mbar_wait(full0 + 8 * s, (d / kDepth) & 1);
      const int r = slot_x[s] & kSkew;
      float4* row = reinterpret_cast<float4*>(base + s * kSlotBytes) +
                    warp * (r ? kWideW / 4 : kWW / 4);
      float4 v = row[lane];
      const bool all = lane > 0 || r == 0;
      v.x += all || r < 1 ? 1.f : 0.f;
      v.y += all || r < 2 ? 1.f : 0.f;
      v.z += all || r < 3 ? 1.f : 0.f;
      v.w += 1.f;
      row[lane] = v;
      if (r && lane == 0) {
        float4 e = row[kWW / 4];
        e.x += 1.f;
        e.y += r > 1 ? 1.f : 0.f;
        e.z += r > 2 ? 1.f : 0.f;
        row[kWW / 4] = e;
      }
      fence_proxy_async_shared();     // visible to the TMA store's reads
      __syncwarp();
      if (lane == 0) mbar_arrive(ready0 + 8 * s);
    }
    return;
  }

  // ---- producer warp: lane 0 issues the copies (the bulk groups are its
  // own); the lookahead's ``done`` is the windows whose store has landed,
  // ``wrote`` those whose store is issued
  Lookahead<kSkew> a;
  a.start(list, nb);
  unsigned wrote = 0;
  int nfetch = 0, nstore = 0;  // windows fetched / stores issued, in order
  int slot_l = 0;               // lane s: the window in slot s
  while (a.base < nb) {
    for (unsigned rd = a.ready(nb); rd && nfetch - nstore < kDepth;
         rd &= rd - 1) {
      const int l = __ffs(rd) - 1, s = nfetch % kDepth;
      const int x = __shfl_sync(~0u, a.x, l), r = x & kSkew;
      if (lane == 0) {
        // the slot's last window, nfetch - kDepth, has been stored; wait
        // until that store has read the slot (the later ones may pend)
        if (nfetch >= kDepth)
          bulk_wait_read_upto(nstore - 1 - (nfetch - kDepth));
        slot_x[s] = x;
        mbar_arrive_tx(full0 + 8 * s, r ? kSlotBytes : kWinBytes);
        tma_load_2d(ring + s * kSlotBytes, r ? &wide : &map, x - r, y,
                    full0 + 8 * s);
      }
      if (lane == s) slot_l = a.base + l;
      a.issued |= 1u << l;
      ++nfetch;
    }
    if (nfetch > nstore) {          // store the oldest, once it is added to
      const int s = nstore % kDepth;
      mbar_wait(ready0 + 8 * s, (nstore / kDepth) & 1);
      if (lane == 0) {
        const int x = slot_x[s], r = x & kSkew;
        tma_store_2d(r ? &wide : &map, ring + s * kSlotBytes, x - r, y);
        bulk_commit();
      }
      wrote |= 1u << (__shfl_sync(~0u, slot_l, s) - a.base);
      ++nstore;
    } else if (wrote & ~a.done) {   // nothing in flight: land the stores
      if (lane == 0) {
        bulk_wait<0>();
        fence_proxy_async_global();
      }
      a.done |= wrote;
    }
    __syncwarp();
    const int k = a.low_done();
    if (k >= kSlide || (k > 0 && nfetch == nstore)) {
      a.slide(k, list, nb);
      wrote = k < 32 ? wrote >> k : 0;
    }
  }
  if (lane == 0) bulk_wait<0>();
}

// shared memory of each arm: its ring (+ the tma arm's mbarriers, slot x
// and alignment slack) and the band's list of up to n windows
static int smem_bytes(int arm, int n) {
  return (arm ? kDepth * kSlotBytes + 20 * kDepth + 128
              : kWH * kDepth * 32 * 16) + 4 * n;
}

static int bands(int H) { return (H - kWH) / kWH + 1; }

// canvas [H, W] fp32, 16-byte aligned, W a multiple of 4; offsets int32 [2n],
// 8-byte aligned, every y a multiple of 8 and every x a multiple of 4 (the
// wrapper checks); 1 <= n <= kMaxList.  ``blocks``: the grid launched.
extern "C" int probe_window_launch(float* canvas, const int* off, int n,
                                   int H, int W, int* blocks, void* stream) {
  if (n < 1 || n > kMaxList || H < kWH || W < kWW || W % 4)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(0, n);
  cudaError_t e = cudaFuncSetAttribute(
      probe_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = bands(H);
  probe_window_kernel<<<*blocks, kRowThreads, smem, (cudaStream_t)stream>>>(
      canvas, reinterpret_cast<const int2*>(off), n, W);
  return (int)cudaGetLastError();
}

// fp32 [H, W] canvas map with a [8, bw] box, no swizzle
static int encode_canvas(CUtensorMap* map, float* canvas, int H, int W,
                         int bw) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)W, (cuuint64_t)H};
  const cuuint64_t strides[1] = {(cuuint64_t)W * 4};
  const cuuint32_t box[2] = {(cuuint32_t)bw, kWH}, ones[2] = {1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, canvas, dims,
                      strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

// the same for the tma arm, x any element offset (``widen`` 1: kSkew 3);
// ``widen`` 0 (kSkew 0) where every x is a multiple of 4: the [8, 128] box
// at every x, which the card refuses elsewhere.  Returns a CUDA error, or
// -1 (no cuTensorMapEncodeTiled) / -1000 - CUresult (a map refused).
extern "C" int probe_window_tma_launch(float* canvas, const int* off, int n,
                                       int H, int W, int widen, int* blocks,
                                       void* stream) {
  if (n < 1 || n > kMaxList || H < kWH || W < kWW || W % 4)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map, wide;
  int r = encode_canvas(&map, canvas, H, W, kWW);
  if (r) return r;
  // (a canvas narrower than the wide box has no x % 4 != 0 window)
  wide = map;
  if (W >= kWideW && (r = encode_canvas(&wide, canvas, H, W, kWideW)))
    return r;
  const int smem = smem_bytes(1, n);
  auto kernel =
      widen ? probe_window_tma_kernel<3> : probe_window_tma_kernel<0>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  *blocks = bands(H);
  kernel<<<*blocks, kTmaThreads, smem, (cudaStream_t)stream>>>(
      map, wide, reinterpret_cast<const int2*>(off), n, W);
  return (int)cudaGetLastError();
}

// ======================================================================
// The chain term of the bound: one dependent round trip through L2 -- a
// 16-byte load, the add, the store of the sum to the same address, whose
// value the next load returns -- in SM clocks.  One thread times kChain
// round trips between two reads of clock64 (loads and stores .cg: L2, not
// L1); the chain runs twice so that the second, timed, pass finds its
// instructions in the cache.

constexpr int kChain = 256;

__global__ void window_rt_kernel(float4* buf, long long* clocks) {
  long long t0 = 0, t1 = 0;
#pragma unroll 1
  for (int pass = 0; pass < 2; ++pass) {
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0)::"memory");
#pragma unroll 1
    for (int i = 0; i < kChain; ++i) {
      float4 v;
      asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
                   : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                   : "l"(buf)
                   : "memory");
      v.x += 1.f;
      v.y += 1.f;
      v.z += 1.f;
      v.w += 1.f;
      asm volatile("st.global.cg.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(buf),
                   "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                   : "memory");
    }
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1)::"memory");
  }
  clocks[0] = t1 - t0;
  clocks[1] = kChain;
}

// clocks[0]: SM clocks of the timed chain, clocks[1]: its length; ``buf``
// 16 bytes of device memory (zeros: the sums stay exact).
extern "C" int window_rt_launch(float* buf, long long* clocks, void* stream) {
  window_rt_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<float4*>(buf), clocks);
  return (int)cudaGetLastError();
}
