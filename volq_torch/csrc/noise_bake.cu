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

constexpr int kThreads = 256;
constexpr int kMaxOctaves = 16;

// volume/noise.py's hash constants
constexpr uint32_t kK1 = 0x8DA6B343u, kK2 = 0xD8163841u, kK3 = 0xCB1AB31Fu,
                   kK4 = 0x165667B1u;
constexpr uint32_t kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u;

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

__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 13;
  h *= kM1;
  h ^= h >> 16;
  h *= kM2;
  return h ^ (h >> 15);
}

// volume/noise.py's _hash_base of three int32 coordinates
__device__ __forceinline__ uint32_t hash3(uint32_t ix, uint32_t iy,
                                          uint32_t iz, uint32_t seed_word) {
  return mix(ix * kK1 ^ iy * kK2 ^ iz * kK3 ^ seed_word);
}

// uint32 word -> fp32 in [-1, 1)
__device__ __forceinline__ float u2f(uint32_t h) {
  return __uint2float_rn(h) * (2.0f / 4294967296.0f) - 1.0f;
}

__device__ __forceinline__ float fade(float t) {
  return t * t * t * (t * (t * 6.0f - 15.0f) + 10.0f);
}

__device__ __forceinline__ float lerp(float a, float b, float w) {
  return a + (b - a) * w;
}

// perlin3 (D = 3) or perlin4 (D = 4) of volume/noise.py at point p
template <int D>
__device__ __forceinline__ float perlin(const float (&p)[D], uint32_t s) {
  const uint32_t key[4] = {kK1, kK2, kK3, kK4};  // per axis (x, y, z, w)
  float f[D], w[D];
  uint32_t h[D][2];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const float pf = floorf(p[a]);
    const uint32_t i = (uint32_t)(int)pf;
    f[a] = p[a] - pf;
    w[a] = fade(f[a]);
    h[a][0] = i * key[a];
    h[a][1] = (i + 1u) * key[a];
  }
  // the gradient dot product at corner (cx, cy, cz, cw)
  auto corner = [&](int cx, int cy, int cz, int cw) {
    uint32_t c = h[0][cx] ^ h[1][cy] ^ h[2][cz] ^ s;
    if constexpr (D == 4) c ^= h[D - 1][cw];
    c = mix(c);
    float d = u2f(c) * (f[0] - cx) + u2f(mix(c ^ kK1)) * (f[1] - cy)
              + u2f(mix(c ^ kK2)) * (f[2] - cz);
    if constexpr (D == 4) d = d + u2f(mix(c ^ kK3)) * (f[D - 1] - cw);
    return d;
  };
  // over w first (4-D), then z, y, x
  float n[2][2];
#pragma unroll
  for (int cx = 0; cx < 2; ++cx) {
#pragma unroll
    for (int cy = 0; cy < 2; ++cy) {
      float nz[2];
#pragma unroll
      for (int cz = 0; cz < 2; ++cz)
        nz[cz] = D == 4 ? lerp(corner(cx, cy, cz, 0), corner(cx, cy, cz, 1),
                               w[D - 1])
                        : corner(cx, cy, cz, 0);
      n[cx][cy] = lerp(nz[0], nz[1], w[2]);
    }
  }
  return lerp(lerp(n[0][0], n[0][1], w[1]), lerp(n[1][0], n[1][1], w[1]),
              w[0]);
}

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
