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
// Design.  The product is computed here, with mma.sync.aligned.m16n8k16
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
//
// Bound on this card: operations (2 * M * K * N a product against 989
// TFLOP/s dense bf16); the operands are a few hundred KB read once.  wgmma
// and TMA arms are for a later change.
//
// The fp32 accumulation order (k within a product, products round-robin,
// accumulators summed at the end) differs from a plain sum's: compared within
// 1e-4 of max |out| against an fp64 reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
