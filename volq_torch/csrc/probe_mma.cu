// probe_mma: what a small matrix product costs on Hopper's tensor cores
// (sm_90a), at the warp engine's hat-matrix shapes.
//
// Replaces: bench/mxu_probe.py:time_shape (body _dot_kernel) -- a Pallas
// kernel that does nothing but repeated bf16 products with fp32 accumulation
// on operands resident in fast memory: out[M, N] = sum over G grid steps of
// sum over R of A[i] @ B, through 1 accumulator (every product chained) or 8
// round-robin ones (products in flight together).  It measured the TPU matrix
// unit's cost model on the shapes of the march and placement products.  The
// card's version of the question: kernels A-D place planes with 2-tap
// gathers; what would the same placement cost as a [M, K] x [K, N] product
// on the tensor cores of one SM, operands in shared memory?
//
// Two arms compute it.  ``mma_sync``, the Ampere-era path: warp-level
// mma.sync fed by ldmatrix, operands staged by the threads themselves.
// ``wgmma``, Hopper's path: warpgroup-level wgmma reading both operands from
// shared memory that TMA filled, with mbarriers between a producer warp and
// the consumer warpgroups.  Comparing the two at the same shapes is what the
// probe is for.
//
// ---- mma_sync arm.
// The product is computed with mma.sync.aligned.m16n8k16
// (bf16 operands, fp32 accumulators; inline PTX) on fragments that ldmatrix
// reads from shared memory, by one block of 8 warps: a block is
// one SM's tensor cores as the TPU grid was one core's matrix unit, and
// ``blocks`` copies of it, each doing the whole work into its own output,
// give the card's rate.  The sequential grid becomes the g loop inside the
// block.  The M x N output is cut into 16x16 tiles; the 8 warps form a WGM x
// WGN grid and each owns a WM x WN rectangle of tiles (WM, WN in {1, 2, 4}),
// so an A fragment is reused across WN tiles and a B fragment across WM.
// A is row-major [M, K] and is read with ldmatrix.x4; B is row-major [K, N],
// whose fragments pair elements along K, so it is read with ldmatrix.x4.trans
// (one instruction brings the two 16 x 8 halves of a 16 x 16 tile).
// Tiles past the edge are skipped.  M is padded to a multiple of 16 with zero
// rows in shared memory (M = 120 is 7.5 fragments): the padded rows are
// multiplied like any others, and the output buffer carries them too.
//
// Accumulators.  A warp holds WM * WN * NACC accumulator tiles of 8
// registers a thread (two m16n8 fragments).  nacc = 1 chains every product of a tile through one
// fragment; nacc = 8 round-robins product i into accumulator i % NACC with
// NACC = min(8, 16 / (WM * WN)): all 8 for up to 2 tiles a warp, 4 for 4
// tiles, 2 for 8 tiles (128 x 128 outputs), and 1 for 16 tiles (256 x 128 and
// 128 x 256 outputs) -- 16 fragments = 128 registers is what fits beside the
// operand fragments under the 255-register limit.  Even at NACC = 1 a warp's
// WM * WN tiles are independent chains.
//
// Operands.  When the whole A stack and B fit in the block's shared memory
// (227 KB) they are staged once and every product reads them from there
// (``resident``).  Otherwise -- the K = 1280 shapes: one 128 x 1280 bf16
// operand is 320 KB -- every product streams its operands through shared
// memory in K chunks of KC columns, re-read from device memory / L2 each
// time, with a barrier on either side of the copy; the wrapper picks KC.
// Rows are padded by 8 elements (16 bytes) against bank conflicts.
// mma.sync itself tops out near a third of the card's dense bf16 rate.
//
// ---- wgmma arm.
// Orientation.  wgmma computes a 64-row tile, N a multiple of 8 up to 256,
// k16 a step.  Where M % 64 == 0 it computes out = A B directly: A is the
// K-major operand, B ([K, N], N contiguous) the MN-major one (transpose
// bit).  Otherwise, where N % 64 == 0, it computes out^T = B^T A^T: B^T,
// MN-major, is the 64-row operand and A^T, K-major, the N side -- c3_dot1
// (80 x 128 x 64) is one m64n80 tile, no padding.  Otherwise M is padded to
// the next 64 with zero rows (TMA fills what lies outside the tensor).
// Block: two consumer warpgroups and one producer warp (288 threads).
// Where the oriented output has two or more 64-row tiles the consumers
// split them (TPW tiles each); where it has one, they split the R products,
// each into its own accumulators, summed through shared memory at the end.
// Accumulators: an m64nN fp32 tile is N / 2 registers a thread; nacc 1
// chains every product of a tile through one, nacc 8 round-robins over as
// many as fit in 128 registers (NACC, the wrapper's plan).  Each product
// (or ring stage) is wgmma.fence, the k16 steps, commit_group, then
// wait_group 1: one group stays in flight while the next is issued.
// Operands.  Every tile lands by TMA in 128-byte-swizzled shared memory
// (tensor maps with CU_TENSOR_MAP_SWIZZLE_128B, 1024-byte-aligned tiles), and
// wgmma reads it through descriptors of the same swizzle (hopper.cuh:
// sw128_desc).  A [R, M, K] is a 3-D map, boxes of 64 k x rowsA rows (the
// padded M direct, M transposed); B [K, N] a 2-D map, boxes of 64 columns x
// K rows.  Resident (K <= 256 and the lot fits): one mbarrier, every box
// loaded once.  Streamed (the K = 1280 shapes): a ring of ``stages`` slots,
// each one product's 64-column k block of A and the matching 64 rows of B,
// with full (TMA bytes) and empty (consumer) mbarriers; the producer keeps
// the ring's loads in flight while the consumers run on what has arrived,
// and a consumer releases a slot once the wgmma group that read it is done.
//
// Bound on this card: operations (2 * M * K * N a product against 989
// TFLOP/s dense bf16); the operands are a few hundred KB read once.
//
// The fp32 accumulation order (k within a product, products round-robin,
// accumulators summed at the end) differs from a plain sum's: compared within
// 1e-4 of max |out| against an fp64 reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8, kThreads = kWarps * 32;

// mirrors MmaParams in volq_torch/probe/tensor_core.py
struct MmaParams {
  int R, M, K, N, G;
  int Mp;        // M rounded up to a multiple of 16
  int KC;        // K columns staged at a time (K when resident)
  int resident;  // the A stack and B stay in shared memory
  int lda, ldb;  // shared-memory row strides in elements (KC + 8, N + 8)
  int WGM, WGN;  // warp grid, WGM * WGN == 8
};

// rows x cols bf16 (cols a multiple of 8) from src (row stride lds) to dst
// (row stride ldd), 16 bytes a thread
__device__ __forceinline__ void stage(bf16* dst, int ldd, const bf16* src,
                                      int lds, int rows, int cols) {
  const int vpr = cols >> 3;
  for (int idx = threadIdx.x; idx < rows * vpr; idx += kThreads) {
    const int r = idx / vpr, v = idx - r * vpr;
    *reinterpret_cast<uint4*>(dst + (size_t)r * ldd + v * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * lds + v * 8);
  }
}

// four 8x8 b16 matrices from shared memory: lane l gives the address of row
// l % 8 of matrix l / 8 (16 bytes, 16-byte aligned); register i of every lane
// then holds its two elements of matrix i (row lane / 4, columns 2 * (lane %
// 4) and + 1; with .trans, of the transposed matrix).  The "memory" clobber
// keeps the read after the staging stores and barriers before it.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c[16 x 8] += a[16 x 16] * b[16 x 8]
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const unsigned (&a)[4], unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int WM, int WN, int NACC>
__global__ void __launch_bounds__(kThreads)
probe_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 float* __restrict__ out, MmaParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  const int a_slots = p.resident ? p.R : 1;
  const size_t a_slot = (size_t)p.Mp * p.lda;
  bf16* sB = sA + a_slots * a_slot;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Mt = p.Mp >> 4, Nt = p.N >> 4;
  const int mt0 = (warp / p.WGN) * WM, nt0 = (warp % p.WGN) * WN;
  // this lane's row and column offset inside a 16 x 16 tile for ldmatrix.x4
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;

  // zero A's slots once: the pad rows M..Mp are never written again
  for (size_t i = threadIdx.x; i < a_slots * a_slot / 8; i += kThreads)
    reinterpret_cast<uint4*>(sA)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  if (p.resident) {
    for (int i = 0; i < p.R; ++i)
      stage(sA + i * a_slot, p.lda, A + (size_t)i * p.M * p.K, p.K, p.M, p.K);
    stage(sB, p.ldb, B, p.N, p.K, p.N);
    __syncthreads();
  }

  // per 16 x 16 tile and accumulator: the n 0-7 and n 8-15 fragments
  float acc[WM][WN][NACC][2][4];
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n)
#pragma unroll
      for (int j = 0; j < NACC; ++j)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[m][n][j][e >> 2][e & 3] = 0.f;

  for (int g = 0; g < p.G; ++g) {
    for (int i0 = 0; i0 < p.R; i0 += NACC) {
#pragma unroll
      for (int j = 0; j < NACC; ++j) {
        const int i = i0 + j;
        if (i >= p.R) continue;
        for (int kc = 0; kc < p.K; kc += p.KC) {
          if (!p.resident) {
            __syncthreads();   // every warp is done with the last chunk
            stage(sA, p.lda, A + (size_t)i * p.M * p.K + kc, p.K, p.M, p.KC);
            stage(sB, p.ldb, B + (size_t)kc * p.N, p.N, p.KC, p.N);
            __syncthreads();
          }
          const bf16* a_base = p.resident ? sA + i * a_slot : sA;
          for (int kk = 0; kk < p.KC; kk += 16) {
            unsigned b[WN][4];
#pragma unroll
            for (int n = 0; n < WN; ++n)
              if (nt0 + n < Nt)
                ldmatrix_x4_trans(b[n], sB + (size_t)(kk + lrow) * p.ldb +
                                            (nt0 + n) * 16 + lcol);
#pragma unroll
            for (int m = 0; m < WM; ++m) {
              if (mt0 + m >= Mt) continue;
              unsigned a[4];
              ldmatrix_x4(a, a_base +
                                 (size_t)((mt0 + m) * 16 + lrow) * p.lda +
                                 kk + lcol);
#pragma unroll
              for (int n = 0; n < WN; ++n)
                if (nt0 + n < Nt) {
                  mma_16816(acc[m][n][j][0], a, b[n][0], b[n][1]);
                  mma_16816(acc[m][n][j][1], a, b[n][2], b[n][3]);
                }
            }
          }
        }
      }
    }
  }

  // sum the accumulators and store: a fragment holds rows lane / 4 and + 8,
  // columns 2 * (lane % 4) and + 1 of its 16 x 8 half
  float* o = out + (size_t)blockIdx.x * p.Mp * p.N;
  const int frow = lane >> 2, fcol = (lane & 3) * 2;
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n) {
      if (mt0 + m >= Mt || nt0 + n >= Nt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          c[e] = acc[m][n][0][h][e];
#pragma unroll
          for (int j = 1; j < NACC; ++j) c[e] += acc[m][n][j][h][e];
        }
        float* t = o + (size_t)((mt0 + m) * 16 + frow) * p.N +
                   (nt0 + n) * 16 + h * 8 + fcol;
        *reinterpret_cast<float2*>(t) = make_float2(c[0], c[1]);
        *reinterpret_cast<float2*>(t + 8 * (size_t)p.N) =
            make_float2(c[2], c[3]);
      }
    }
}

template <int WM, int WN, int NACC>
static int launch(const bf16* A, const bf16* B, float* out, MmaParams p,
                  int blocks, int smem, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      probe_mma_kernel<WM, WN, NACC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  probe_mma_kernel<WM, WN, NACC><<<blocks, kThreads, smem, st>>>(A, B, out, p);
  return (int)cudaGetLastError();
}

// one instantiation per warp rectangle, chained (NACC 1) and round-robin
#define VOLQ_MMA_CASE(wm, wn, pipe)                                          \
  if (WM == wm && WN == wn)                                                  \
    return nacc == 1 ? launch<wm, wn, 1>(A, B, out, p, blocks, smem, st)     \
                     : launch<wm, wn, pipe>(A, B, out, p, blocks, smem, st);

// ``nacc`` is the accumulator count the wrapper computed for (WM, WN): 1, or
// min(8, 16 / (WM * WN)).
extern "C" int probe_mma_launch(const void* A_, const void* B_, float* out,
                                MmaParams p, int WM, int WN, int nacc,
                                int blocks, int smem, void* stream) {
  const bf16* A = (const bf16*)A_;
  const bf16* B = (const bf16*)B_;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.WGM * p.WGN != kWarps || p.Mp % 16 || p.N % 16 || p.K % p.KC ||
      p.KC % 16 || blocks < 1 ||
      (nacc != 1 && nacc != (16 / (WM * WN) < 8 ? 16 / (WM * WN) : 8)))
    return (int)cudaErrorInvalidValue;
  VOLQ_MMA_CASE(1, 1, 8)
  VOLQ_MMA_CASE(1, 2, 8)
  VOLQ_MMA_CASE(2, 1, 8)
  VOLQ_MMA_CASE(1, 4, 4)
  VOLQ_MMA_CASE(4, 1, 4)
  VOLQ_MMA_CASE(2, 2, 4)
  VOLQ_MMA_CASE(2, 4, 2)
  VOLQ_MMA_CASE(4, 2, 2)
  VOLQ_MMA_CASE(4, 4, 1)
  return (int)cudaErrorInvalidValue;
}

// ======================================================================
// wgmma arm

constexpr int kConsumers = 256;                  // two warpgroups
constexpr int kWgThreads = kConsumers + 32;      // + the producer warp

// mirrors WgmmaParams in volq_torch/probe/tensor_core.py
struct WgmmaParams {
  int R, M, K, N, G;
  int Tm;        // 64-row tiles of the oriented output (out, or out^T)
  int split;     // 1: the consumers split the R products (Tm == 1)
  int resident;  // 1: every operand loaded once; 0: the ring
  int stages;    // ring slots (streamed)
  int K64;       // 64-column k blocks of a product, ceil(K / 64)
  int a_box;     // bytes of one A box: rowsA rows of 128 bytes
  int b_chunk;   // bytes between B's 64-column chunks (K or 64 rows)
  int nc;        // B's 64-column chunks, ceil(N / 64)
  int b_off;     // offset of B in the operands (resident) or in a slot
  int slot;      // bytes of a ring slot (streamed)
  int bar_off;   // offset of the mbarriers
};

// One k16 step of a product on this warpgroup's TPW tiles, into the
// accumulators ``acc[tt]``.  ``a_kb``: the 64-column k block of A that holds
// the step (K-major rows of 128 bytes), ``kk`` the step inside it; ``b_k``:
// the step's 16 rows of B (MN-major, 2048 bytes, chunks b_chunk apart).
template <int NW, int TPW, int TRANS>
__device__ __forceinline__ void wg_step(float (&acc)[TPW][NW / 2],
                                        uint32_t a_kb, int kk, uint32_t b_k,
                                        int wg, const WgmmaParams& p) {
#pragma unroll
  for (int tt = 0; tt < TPW; ++tt) {
    const int t = p.split ? 0 : wg + 2 * tt;
    if (t >= p.Tm) continue;
    if (TRANS == 0) {
      // out rows 64 t..: A's rows of tile t (8192 bytes a tile) by all of B
      wgmma<NW, 0, 1>(acc[tt],
                      sw128_desc(a_kb + t * 8192 + kk * 32, 0, 1024),
                      sw128_desc(b_k, p.b_chunk, 1024));
    } else {
      // out^T rows 64 t..: B's 64-column chunk t by all of A's M rows
      wgmma<NW, 1, 0>(acc[tt],
                      sw128_desc(b_k + t * p.b_chunk, p.b_chunk, 1024),
                      sw128_desc(a_kb + kk * 32, 0, 1024));
    }
  }
}

template <int NW, int TPW, int NACC, int TRANS>
__global__ void __launch_bounds__(kWgThreads, 1)
probe_mma_wgmma_kernel(const __grid_constant__ CUtensorMap tmA,
                       const __grid_constant__ CUtensorMap tmB,
                       float* __restrict__ out, WgmmaParams p) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte-swizzled tiles start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int nslots = p.resident ? 1 : p.stages;
  const uint32_t full0 = base + p.bar_off, empty0 = full0 + 8 * nslots;
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < nslots; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, p.split ? 1 : 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // ---- producer: one thread issues every TMA load
    if ((tid & 31) != 0) return;
    if (p.resident) {
      mbar_arrive_tx(full0, p.R * p.K64 * p.a_box + p.nc * p.b_chunk);
      for (int i = 0; i < p.R; ++i)
        for (int kb = 0; kb < p.K64; ++kb)
          tma_load_3d(base + (i * p.K64 + kb) * p.a_box, &tmA, kb * 64, 0, i,
                      full0);
      for (int c = 0; c < p.nc; ++c)
        tma_load_2d(base + p.b_off + c * p.b_chunk, &tmB, c * 64, 0, full0);
      return;
    }
    // the ring, in the consumers' order: the G * R products of the run in
    // turn (tiles split), or in pairs, one product a warpgroup, k block by
    // k block alternating between the two (products split)
    const int total = p.G * p.R;
    int st = 0;
    auto produce = [&](int i, int kb) {
      const int s = st % p.stages;
      if (st >= p.stages)
        mbar_wait(empty0 + 8 * s, ((st / p.stages) - 1) & 1);
      const uint32_t slot = base + s * p.slot, full = full0 + 8 * s;
      mbar_arrive_tx(full, p.a_box + p.nc * 8192);
      tma_load_3d(slot, &tmA, kb * 64, 0, i, full);
      for (int c = 0; c < p.nc; ++c)
        tma_load_2d(slot + p.b_off + c * 8192, &tmB, c * 64, kb * 64, full);
      ++st;
    };
    if (p.split) {
      for (int q = 0; 2 * q < total; ++q)
        for (int kb = 0; kb < p.K64; ++kb)
          for (int w = 0; w < 2 && 2 * q + w < total; ++w)
            produce((2 * q + w) % p.R, kb);
    } else {
      for (int f = 0; f < total; ++f)
        for (int kb = 0; kb < p.K64; ++kb) produce(f % p.R, kb);
    }
    return;
  }

  // ---- consumers.  The warpgroup index goes through a shuffle so that
  // the compiler knows it is uniform across the warp: wgmma under a branch
  // it cannot prove uniform is serialized
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), tw = tid & 127;
  float acc[NACC][TPW][NW / 2];
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int r = 0; r < NW / 2; ++r) {
        acc[j][tt][r] = 0.f;
        fence_operand(acc[j][tt][r]);
      }
  // this warpgroup's products: all G * R in turn, or every other one
  const int total = p.G * p.R;
  const int nloc = p.split ? (total - wg + 1) >> 1 : total;
  const int nk = p.K >> 4;
  int prev = -1;  // ring slot of the stage this warpgroup consumed last
  if (p.resident) mbar_wait(full0, 0);
  for (int q0 = 0; q0 < nloc; q0 += NACC) {
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int q = q0 + j;
      if (q >= nloc) break;
      const int i = (p.split ? 2 * q + wg : q) % p.R;
      if (p.resident) {
        const uint32_t a0 = base + i * p.K64 * p.a_box;
        wgmma_fence();
        for (int ks = 0; ks < nk; ++ks)
          wg_step<NW, TPW, TRANS>(acc[j], a0 + (ks >> 2) * p.a_box, ks & 3,
                                  base + p.b_off + ks * 2048, wg, p);
        wgmma_commit();
        wgmma_wait<1>();
        continue;
      }
      const int pair = total - 2 * q < 2 ? 1 : 2;
      for (int kb = 0; kb < p.K64; ++kb) {
        const int st = p.split ? 2 * q * p.K64 + kb * pair + wg
                               : q * p.K64 + kb;
        const int s = st % p.stages;
        mbar_wait(full0 + 8 * s, (st / p.stages) & 1);
        const uint32_t slot = base + s * p.slot;
        const int kn = nk - 4 * kb < 4 ? nk - 4 * kb : 4;
        wgmma_fence();
        for (int ks = 0; ks < kn; ++ks)
          wg_step<NW, TPW, TRANS>(acc[j], slot, ks,
                                  slot + p.b_off + ks * 2048, wg, p);
        wgmma_commit();
        // the group before this one is done: its slot is free
        wgmma_wait<1>();
        if (prev >= 0 && tw == 0) mbar_arrive(empty0 + 8 * prev);
        prev = s;
      }
    }
  }
  wgmma_wait<0>();
  // the last slot too: the producer may still need it for the other
  // warpgroup's stages
  if (prev >= 0 && tw == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
  for (int j = 0; j < NACC; ++j)
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int r = 0; r < NW / 2; ++r) fence_operand(acc[j][tt][r]);
#pragma unroll
  for (int j = 1; j < NACC; ++j)
#pragma unroll
    for (int tt = 0; tt < TPW; ++tt)
#pragma unroll
      for (int r = 0; r < NW / 2; ++r) acc[0][tt][r] += acc[j][tt][r];

  if (p.split) {
    // both warpgroups are past their last wgmma: the operands are dead, and
    // warpgroup 1's sum goes through them to warpgroup 0
    float* red = reinterpret_cast<float*>(smem_raw + (base - raw));
    bar_sync(1, kConsumers);
    if (wg == 1) {
#pragma unroll
      for (int r = 0; r < NW / 2; ++r) red[r * 128 + tw] = acc[0][0][r];
    }
    bar_sync(1, kConsumers);
    if (wg == 1) return;
#pragma unroll
    for (int r = 0; r < NW / 2; ++r) acc[0][0][r] += red[r * 128 + tw];
  }

  // store: row 16 * warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) + 0, 1
  float* o = out + (size_t)blockIdx.x * p.M * p.N;
  const int lane = tw & 31, row0 = 16 * (tw >> 5) + (lane >> 2);
#pragma unroll
  for (int tt = 0; tt < TPW; ++tt) {
    const int t = p.split ? 0 : wg + 2 * tt;
    if (t >= p.Tm) continue;
#pragma unroll
    for (int jn = 0; jn < NW / 8; ++jn)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 64 * t + row0 + 8 * h, col = 8 * jn + 2 * (lane & 3);
        const float v0 = acc[0][tt][4 * jn + 2 * h];
        const float v1 = acc[0][tt][4 * jn + 2 * h + 1];
        if (TRANS == 0) {
          if (row < p.M)
            *reinterpret_cast<float2*>(o + (size_t)row * p.N + col) =
                make_float2(v0, v1);
        } else {
          o[(size_t)col * p.N + row] = v0;
          o[(size_t)(col + 1) * p.N + row] = v1;
        }
      }
  }
}

// bf16 tensor map, 128-byte swizzle, zeros outside the tensor
static int encode(CUtensorMap* map, const void* ptr, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint32_t ones[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                  const_cast<void*>(ptr), dims, strides, box, ones,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -1000 - (int)r;
}

template <int NW, int TPW, int NACC, int TRANS>
static int launch_wg(const CUtensorMap& a, const CUtensorMap& b, float* out,
                     const WgmmaParams& p, int blocks, int smem,
                     cudaStream_t st) {
  auto k = probe_mma_wgmma_kernel<NW, TPW, NACC, TRANS>;
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<blocks, kWgThreads, smem, st>>>(a, b, out, p);
  return (int)cudaGetLastError();
}

// one instantiation per (wgmma N, tiles a warpgroup, orientation), chained
// (NACC 1) and round-robin (the plan's NACC)
#define VOLQ_WG_CASE(nw, tpw, tr, pipe)                                       \
  if (NW == nw && TPW == tpw && trans == tr) {                               \
    if (nacc == 1) return launch_wg<nw, tpw, 1, tr>(ma, mb, out, p, blocks,  \
                                                    smem, st);               \
    if (nacc == pipe) return launch_wg<nw, tpw, pipe, tr>(ma, mb, out, p,    \
                                                          blocks, smem, st); \
  }

// A [R, M, K] and B [K, N] bf16, 16-byte aligned; ``rowsA`` the rows of an
// A box (the padded M, or M transposed); the rest from the wrapper's plan.
// Returns a CUDA error, or -1 (no cuTensorMapEncodeTiled) / -1000 - CUresult
// (a tensor map refused).
extern "C" int probe_mma_wgmma_launch(const void* A, const void* B,
                                      float* out, WgmmaParams p, int NW,
                                      int TPW, int nacc, int trans, int rowsA,
                                      int blocks, int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (blocks < 1 || p.G < 0 || p.K % 16 || rowsA < 8 || rowsA > 256 ||
      (p.resident && p.K > 256) || (!p.resident && p.stages < 2))
    return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mb;
  const cuuint64_t adim[3] = {(cuuint64_t)p.K, (cuuint64_t)p.M,
                              (cuuint64_t)p.R};
  const cuuint64_t astr[2] = {(cuuint64_t)p.K * 2,
                              (cuuint64_t)p.M * p.K * 2};
  const cuuint32_t abox[3] = {64, (cuuint32_t)rowsA, 1};
  int r = encode(&ma, A, 3, adim, astr, abox);
  if (r) return r;
  const cuuint64_t bdim[2] = {(cuuint64_t)p.N, (cuuint64_t)p.K};
  const cuuint64_t bstr[1] = {(cuuint64_t)p.N * 2};
  const cuuint32_t bbox[2] = {64, (cuuint32_t)(p.resident ? p.K : 64)};
  r = encode(&mb, B, 2, bdim, bstr, bbox);
  if (r) return r;
  VOLQ_WG_CASE(16, 1, 0, 8)
  VOLQ_WG_CASE(32, 1, 0, 8)
  VOLQ_WG_CASE(64, 1, 0, 4)
  VOLQ_WG_CASE(80, 1, 0, 3)
  VOLQ_WG_CASE(128, 1, 0, 2)
  VOLQ_WG_CASE(128, 2, 0, 1)
  VOLQ_WG_CASE(256, 1, 0, 1)
  VOLQ_WG_CASE(16, 1, 1, 8)
  VOLQ_WG_CASE(32, 1, 1, 8)
  VOLQ_WG_CASE(80, 1, 1, 3)
  VOLQ_WG_CASE(120, 1, 1, 2)
  VOLQ_WG_CASE(120, 2, 1, 1)
  return (int)cudaErrorInvalidValue;
}
