// light_bake: the light bank (volq_torch/volume/lightbake.py) -- every bank
// entry's directional-light optical depth, swept slice by slice from the
// light's entry face -- in one launch.
//
// Replaces no TPU kernel: the JAX package's sweep (volq/volume/lightbake.py)
// is a lax.scan that XLA compiles, and the port's plain version
// (``_bake_light_plain``) walks the V - 1 slices from Python, some 21 small
// torch ops a slice on [M, V, V] planes (c5: ~1,300 launches a frame) after
// three blocking reads of the light's direction to the host.  Here a block
// sweeps one entry: its loop over the slices takes the place of the Python
// loop, and the light's direction is read where it lies on the card.
//
// Bound on this card: the bytes (the bank read once, the fp32 depth written
// once: 6 bytes a voxel of a bf16 bank) take ~7.5 us at c5's [16, 64^3], the
// ~22 fp32 operations a voxel less (chip_smoke.py's ``light_bake_work``).
// The time is set on the SMs the grid uses (a block an entry: c5's 16): the
// V - 1 dependent steps, each a voxel's four reads of the planes and its
// operations, two barriers, and the accesses to the bank and the output.
// The design keeps every step on chip: the carried depth and the previous
// density plane live in shared memory, interleaved as float2 (8 V^2 bytes:
// 32 KB at V = 64, 128 KB at V = 128), each thread owns VPT voxels of the
// plane and reads its neighbours there, and the next slice is loaded a step
// ahead.  Sweeping z or x, a plane's rows are contiguous and the threads'
// scalar accesses coalesce.  Sweeping y (the innermost axis; c5's light), a
// voxel's slices are contiguous: its thread loads them as 16-byte vectors
// and stores the depth as float4 (RUN), each lane on a line of its own,
// which costs about as much again as the steps (on the card: ~0.2 ms
// against ~0.1 ms for a z or x sweep of c5's bank).
//
// Bit-equal to the plain version, by construction: the build passes
// --fmad=false and no fast math, so nothing is contracted and ``/`` is IEEE;
// the constants are the plain version's fp32 ops on the direction (clamp,
// the two divisions, floor and the fraction, the path step as the
// reciprocal of |L_axis| times fp32(1 / (V - 1)), as torch's rdiv makes
// it); each shift lerps along the plane's first dim, rounds, then lerps that
// along its second, zero outside the plane; each step adds the trapezoid in
// the plain version's order.  Entry slice: depth 0.

#include <cstdint>
#include <type_traits>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

constexpr int kThreads = 1024;
constexpr int kMaxV = 128;               // V^2 = kThreads * 16 plane voxels
constexpr int kMaxRunVpt = 4;            // RUN's registers: V <= 64

struct Sweep {
  int V, axis;
  int ss, ps, qs;   // strides of the sweep axis and the plane's two dims
  int ci, cj;       // light components of the plane's two dims
  float min_laxis;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// element e of a 16-byte vector of T (selects: no indexed registers)
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  if constexpr (sizeof(T) == 2) {
    const int k = e >> 1;
    const uint32_t w = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    return __uint_as_float((e & 1 ? w >> 16 : w & 0xffffu) << 16);
  } else {
    return __uint_as_float(e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w);
  }
}

// a voxel's next load: a 16-byte run of slices (RUN) or one slice
template <typename T>
__device__ __forceinline__ void fetch(uint4& d, const T* p) {
  d = *reinterpret_cast<const uint4*>(p);
}
template <typename T>
__device__ __forceinline__ void fetch(T& d, const T* p) { d = *p; }

// the planes (tau, sig) [V, V] shifted by (i0 + fx, j0 + fy) voxels at
// (p, q): the lerp along the first dim at columns q + j0 and q + j0 + 1
// (zero outside the plane), each rounded, then the lerp of those along the
// second dim
__device__ __forceinline__ float2 shift2d(const float2* a, int V, int p,
                                          int q, int i0, float fx, int j0,
                                          float fy) {
  const int r0 = p + i0, c0 = q + j0;
  const bool v0 = (unsigned)r0 < (unsigned)V;
  const bool v1 = (unsigned)(r0 + 1) < (unsigned)V;
  float2 row[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int col = c0 + c;
    row[c] = make_float2(0.0f, 0.0f);
    if ((unsigned)col < (unsigned)V) {
      const float2 a0 = v0 ? a[r0 * V + col] : make_float2(0.0f, 0.0f);
      const float2 a1 = v1 ? a[(r0 + 1) * V + col] : make_float2(0.0f, 0.0f);
      row[c].x = a0.x + (a1.x - a0.x) * fx;
      row[c].y = a0.y + (a1.y - a0.y) * fx;
    }
  }
  return make_float2(row[0].x + (row[1].x - row[0].x) * fy,
                     row[0].y + (row[1].y - row[0].y) * fy);
}

// vol, out [n, V, V, V] (entry, z, x, y); light [3] fp32 toward the light.
// A block per entry; RUN: the sweep axis is contiguous (y), V % 8 == 0.
template <typename T, int VPT, bool RUN>
__global__ void __launch_bounds__(kThreads, 1)
    light_bake_kernel(const T* __restrict__ vol, float* __restrict__ out,
                      const float* __restrict__ light, const Sweep s) {
  // the carried depth and the previous slice's density, plane [V, V]
  extern __shared__ float2 planes[];
  const int V = s.V, VV = V * V;

  // the plain version's constants, from the direction on the card
  const float la = light[s.axis];
  const float aa = fabsf(la);
  const float ala = aa < s.min_laxis ? s.min_laxis : aa;   // keeps a NaN
  const float dx = light[s.ci] / ala, dy = light[s.cj] / ala;
  const float fx0 = floorf(dx), fy0 = floorf(dy);
  const float fx = dx - fx0, fy = dy - fy0;
  // beyond +-(V + 1) voxels every read is outside the plane
  const int i0 = (int)fminf(fmaxf(fx0, -(float)(V + 1)), (float)(V + 1));
  const int j0 = (int)fminf(fmaxf(fy0, -(float)(V + 1)), (float)(V + 1));
  const float dl = (1.0f / ala) * (float)(1.0 / (double)(V - 1));
  const bool desc = la >= 0.0f;   // the light enters at k = V - 1

  constexpr int W = RUN ? 16 / (int)sizeof(T) : 1;   // slices a load holds
  const int nch = V / W, cs = RUN ? W : s.ss;         // a chunk's stride
  const T* src = vol + (size_t)blockIdx.x * VV * V;
  float* dst = out + (size_t)blockIdx.x * VV * V;

  int pq[VPT];                // (p << 8) | q, or -1 past the plane
  typename std::conditional<RUN, uint4, T>::type cur[VPT];
  float4 buf[VPT];            // RUN: four slices' depths, stored together
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int p = v / V;
    pq[i] = v < VV ? (p << 8) | (v - p * V) : -1;
    if (pq[i] >= 0)
      fetch(cur[i], src + p * s.ps + (v - p * V) * s.qs
                        + (desc ? nch - 1 : 0) * cs);
    buf[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  for (int t = 0; t < V; ++t) {
    const int n = t / W, j = t % W;
    const int c = desc ? nch - 1 - n : n;      // the chunk
    const int e = desc ? W - 1 - j : j;        // the slice within it
    const int k = c * W + e;
    float sg[VPT], tn[VPT];
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if constexpr (RUN)
        sg[i] = elem<T>(cur[i], e);
      else
        sg[i] = widen(cur[i]);
    }
    // the next chunk's load, a step ahead of its first use
    if (j == W - 1 && n + 1 < nch) {
#pragma unroll
      for (int i = 0; i < VPT; ++i)
        if (pq[i] >= 0)
          fetch(cur[i], src + (pq[i] >> 8) * s.ps + (pq[i] & 0xff) * s.qs
                            + (desc ? c - 1 : c + 1) * cs);
    }
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      tn[i] = 0.0f;                            // the entry slice
      if (t > 0 && pq[i] >= 0) {
        const float2 sh = shift2d(planes, V, pq[i] >> 8, pq[i] & 0xff, i0,
                                  fx, j0, fy);
        tn[i] = sh.x + (0.5f * (sg[i] + sh.y)) * dl;
      }
    }
    __syncthreads();   // every read of the planes is done
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      if (pq[i] < 0) continue;
      planes[threadIdx.x + i * kThreads] = make_float2(tn[i], sg[i]);
      const int o = (pq[i] >> 8) * s.ps + (pq[i] & 0xff) * s.qs;
      if constexpr (RUN) {
        const int e4 = e & 3;
        buf[i].x = e4 == 0 ? tn[i] : buf[i].x;
        buf[i].y = e4 == 1 ? tn[i] : buf[i].y;
        buf[i].z = e4 == 2 ? tn[i] : buf[i].z;
        buf[i].w = e4 == 3 ? tn[i] : buf[i].w;
        if ((j & 3) == 3)
          *reinterpret_cast<float4*>(dst + o + (k & ~3)) = buf[i];
      } else {
        dst[o + k * s.ss] = tn[i];
      }
    }
    __syncthreads();   // the new planes are in place
  }
}

template <typename T, int VPT, bool RUN>
static int go(const void* vol, float* out, const float* light, int n,
              const Sweep& s, cudaStream_t st) {
  const size_t smem = sizeof(float2) * s.V * s.V;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        light_bake_kernel<T, VPT, RUN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  light_bake_kernel<T, VPT, RUN>
      <<<n, kThreads, smem, st>>>((const T*)vol, out, light, s);
  return (int)cudaGetLastError();
}

template <typename T, int VPT>
static int go_vpt(bool run, const void* vol, float* out, const float* light,
                  int n, const Sweep& s, cudaStream_t st) {
  if constexpr (VPT <= kMaxRunVpt)
    if (run) return go<T, VPT, true>(vol, out, light, n, s, st);
  return go<T, VPT, false>(vol, out, light, n, s, st);
}

template <typename T>
static int dispatch(int vpt, bool run, const void* vol, float* out,
                    const float* light, int n, const Sweep& s,
                    cudaStream_t st) {
  switch (vpt) {
    case 1: return go_vpt<T, 1>(run, vol, out, light, n, s, st);
    case 2: return go_vpt<T, 2>(run, vol, out, light, n, s, st);
    case 4: return go_vpt<T, 4>(run, vol, out, light, n, s, st);
    case 8: return go_vpt<T, 8>(run, vol, out, light, n, s, st);
    default: return go_vpt<T, 16>(run, vol, out, light, n, s, st);
  }
}

// n entries of V^3 (2 <= V <= kMaxV), bf16 (1) or fp32 (0), swept along
// world axis 0 (x), 1 (y) or 2 (z); min_laxis the floor of |L_axis|
extern "C" int light_bake_launch(const void* vol, float* out,
                                 const float* light, int n, int V, int axis,
                                 int bf16, float min_laxis, void* stream) {
  if (!vol || !out || !light || n < 0 || V < 2 || V > kMaxV || axis < 0
      || axis > 2)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  // storage (z, x, y): strides V^2, V, 1
  const int sz = V * V, sx = V, sy = 1;
  Sweep s{V, axis, 0, 0, 0, 0, 0, min_laxis};
  if (axis == 2) { s.ss = sz; s.ps = sx; s.qs = sy; s.ci = 0; s.cj = 1; }
  if (axis == 0) { s.ss = sx; s.ps = sz; s.qs = sy; s.ci = 2; s.cj = 1; }
  if (axis == 1) { s.ss = sy; s.ps = sz; s.qs = sx; s.ci = 2; s.cj = 0; }
  int vpt = 1;
  while (vpt * kThreads < V * V) vpt *= 2;
  const bool run = axis == 1 && V % 8 == 0 && vpt <= kMaxRunVpt
                   && (uintptr_t)vol % 16 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(vpt, run, vol, out, light, n, s, st)
              : dispatch<float>(vpt, run, vol, out, light, n, s, st);
}
