// The hash-gradient noise of volq_torch/volume/noise.py on the card: the
// uint32 lattice hash, its fp32 gradients and the Perlin lerps, shared by
// the noise bank's bake (noise_bake.cu, perlin<3> and perlin<4>) and the
// sim's curl-noise forces (sim_step.cu, perlin<3>).  Every fp32 expression
// rounds where volume/noise.py's torch ops round, in their order; a source
// that includes this is built with --fmad=false (volq_torch/_build.py), so
// nothing is contracted.

#pragma once

#include <cstdint>

// volume/noise.py's hash constants
constexpr uint32_t kK1 = 0x8DA6B343u, kK2 = 0xD8163841u, kK3 = 0xCB1AB31Fu,
                   kK4 = 0x165667B1u;
constexpr uint32_t kM1 = 0x85EBCA6Bu, kM2 = 0xC2B2AE35u;

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
