// noise_bake: a bank of carved fBm noise volumes (volq_torch/volume/bake.py)
// in one launch -- the static bank of 3-D noise and the animated bank of 4-D
// noise that the frame loop re-bakes every frame.
//
// Replaces no TPU kernel: the JAX package leaves the bake to XLA's fusion
// (volq/volume/bake.py), and the port's plain version (``_bake_plain`` over
// volume/noise.py) runs it op by op on int64 words that hold uint32 hashes,
// some 1,200 elementwise launches an octave of the 4-D bank, each reading
// and writing temporaries the size of the bank.  Here a thread bakes one
// voxel of one entry with every hash in a register, from the entry's id
// and (4-D) the simulation time alone, and stores its bf16 value: nothing
// else is read, and nothing but the bank is written.
//
// Bound on this card: the integer and fp32 operations of the hashes and the
// gradients (about 3,200 a voxel of a 3-octave 4-D bank; the count is
// written out in chip_smoke.py's ``noise_bake_work``), far above the 2 bytes
// a voxel stored.  Threads walk the output's last axis (y) fastest, so the
// stores of a warp are one coalesced run; a block covers 256 voxels of one
// entry, the grid's y axis the entries.
//
// Bit-equal to the plain version, by construction:
//   * the hashes are uint32 arithmetic, which the plain version's int64
//     words masked to 32 bits emulate: the lattice coordinate is floor, the
//     cast to int32, then + c, in that order;
//   * every fp32 expression rounds where the plain version's ops do, in its
//     order (fade, the corner dot products, the lerps over w, then z, y, x,
//     the fBm sum, the carving): the build passes --fmad=false and no fast
//     math, so nothing is contracted and ``/`` is IEEE division;
//   * each Python-float constant of the plain version comes in NoiseParams
//     as the fp32 that torch rounds it to, and the seed words are worked
//     out on the host from Python ints;
//   * the store rounds to nearest even, as torch's cast to bf16 does.
// The simulation time is read from the card (a 0-d fp32 tensor): no copy
// between host and card.

#include <climits>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "noise_common.cuh"

constexpr int kThreads = 256;
constexpr int kMaxOctaves = 16;

// mirrors NoiseParams in volq_torch/volume/bake.py
struct NoiseParams {
  int n;                       // entries baked: the output's first axis
  int size;                    // V: voxels along each axis
  int octaves;
  float denom;                 // size - 1, the lattice's divisor
  float noise_scale, time_scale;
  float norm;                  // the fBm's sum of octave amplitudes
  float cutoff, edge;
  float span;                  // max(1 - cutoff, 1e-3)
  uint32_t off_seed;           // seed word of seed + 101 (entry offsets)
  uint32_t time_seed;          // seed word of seed + 202 (4-D time phases)
  uint32_t seed[kMaxOctaves];  // octave o: the seed word of seed + o
  float amp[kMaxOctaves], freq[kMaxOctaves];
};

// out [n, V, V, V] (entry, z, x, y); entry row e bakes bank entry ids[e]
// (ids NULL: e itself); t: the simulation time (4-D only)
template <int D>
__global__ void __launch_bounds__(kThreads)
    noise_bake_kernel(__nv_bfloat16* __restrict__ out,
                      const long long* __restrict__ ids,
                      const float* __restrict__ t, const NoiseParams p) {
  const int V = p.size;
  const int v = blockIdx.x * kThreads + threadIdx.x;
  if (v >= V * V * V) return;
  const int e = blockIdx.y;
  const int vox[3] = {(v / V) % V, v % V, v / (V * V)};  // x, y, z
  const uint32_t id = ids ? (uint32_t)ids[e] : (uint32_t)e;

  float q[D], r2 = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float c = (float)vox[a] / p.denom - 0.5f;
    const float d = c * 2.0f;
    r2 = a == 0 ? d * d : r2 + d * d;
    const float off =
        u2f(hash3(id, id * 7u + a, id * 13u + 2u * a, p.off_seed)) * 64.0f;
    q[a] = c * p.noise_scale + off;
  }
  if constexpr (D == 4)
    q[D - 1] = t[0] * p.time_scale
               + u2f(hash3(id, id * 3u + 1u, id * 5u + 2u, p.time_seed))
                     * 16.0f;

  float total = 0.0f;
  for (int o = 0; o < p.octaves; ++o) {
    float po[D];
#pragma unroll
    for (int a = 0; a < D; ++a) po[a] = q[a] * p.freq[o];
    total = total + p.amp[o] * perlin<D>(po, p.seed[o]);
  }
  const float n = total / p.norm;
  // _shape_density: the clamps keep a NaN, as torch.clamp does
  float d = 0.5f + 0.5f * n - (p.cutoff + p.edge * r2);
  d = (d < 0.0f ? 0.0f : d) / p.span;
  d = d > 1.0f ? 1.0f : d;
  out[(size_t)e * (V * V * V) + v] = __float2bfloat16_rn(d);
}

// dim 3 (static bank, t unused) or 4; ids NULL bakes entries 0 .. n - 1
extern "C" int noise_bake_launch(void* out, const long long* ids,
                                 const float* t, int dim, NoiseParams p,
                                 void* stream) {
  if ((dim != 3 && dim != 4) || (dim == 4 && !t) || p.n < 0 || p.n > 65535
      || p.size < 1 || (long long)p.size * p.size * p.size > INT_MAX
      || p.octaves < 0 || p.octaves > kMaxOctaves)
    return (int)cudaErrorInvalidValue;
  if (p.n == 0) return 0;
  const int vox = p.size * p.size * p.size;
  const dim3 grid((vox + kThreads - 1) / kThreads, p.n);
  cudaStream_t st = (cudaStream_t)stream;
  auto* o = (__nv_bfloat16*)out;
  if (dim == 4)
    noise_bake_kernel<4><<<grid, kThreads, 0, st>>>(o, ids, t, p);
  else
    noise_bake_kernel<3><<<grid, kThreads, 0, st>>>(o, ids, t, p);
  return (int)cudaGetLastError();
}
