// sim_step: the particle sim's step (volq_torch/sim/step.py) in three
// launches.
//
// Replaces no TPU kernel: the JAX package leaves the step to XLA's fusion
// (volq/sim/), and the port's plain version runs it op by op on the card:
// threefry's 20 rounds as int64 ops masked to 32 bits for each of a dozen
// draws, the erfinv polynomial in fp64, three Perlin potentials over
// [4, N, 3], some 2,800 small launches a frame whose host time paces it.
// Here a thread steps one slot with every word in a register:
//   sim_scan    one block: ageing and death of every slot, and each slot's
//               count of dead slots up to and including it (the emission
//               rank), with their total for the sharded step;
//   sim_spawn   a thread a slot: the first floor(carry + rate * dt) dead
//               slots in slot order draw fresh attributes from
//               fold_in(fold_in(base, frame), slot); every slot's age,
//               lifetime, size, albedo and volume index, the dead slots'
//               position and velocity; frame + 1, the carry, time + dt;
//   sim_forces  a thread a slot: the alive slots' gravity, drag and curl
//               noise (the curl of three Perlin potentials by central
//               differences), then the advection.
// sim_spawn and sim_forces write disjoint slots of position and velocity.
// frame, time, the carry and the key are read from the card (0-d tensors
// and the [2] key): no copy between host and card.
//
// Bound on this card: the step's work is small (the curl's 12 Perlin
// evaluations a slot, ~70 spawning slots' draws a c5 frame, 56 bytes a slot
// read and written; chip_smoke.py's ``sim_step_work``), so the three
// launches' latency and sim_scan's one block set its time.
//
// Bit-equal to the plain version, by construction:
//   * the threefry words, hashes and the randint modulo are uint32
//     arithmetic, which the plain version's int64 words masked to 32 bits
//     emulate;
//   * every fp32 expression rounds where the plain version's torch ops do,
//     in their order; the build passes --fmad=false and no fast math, so
//     nothing is contracted and ``/`` and sqrtf are IEEE;
//   * uniform's fused multiply-add (prng._fma) and the erfinv polynomial's
//     steps are done in double and rounded to fp32 once, as there;
//   * log1pf and powf are the CUDA math library's, which torch's log1p and
//     pow kernels call for fp32;
//   * each Python-float constant comes in SimParams as the fp32 that torch
//     rounds it to, and a divisor as a tensor's value (no reciprocal).

#include <cstdint>
#include <cuda_runtime.h>

#include "noise_common.cuh"

constexpr int kThreads = 128;
constexpr int kScanThreads = 1024;
constexpr int kScanItems = 16;          // slots a scan thread holds a tile
constexpr int kErfinvTerms = 9;

// mirrors SimParams in volq_torch/sim/kernel.py
struct SimParams {
  float dt, rate;
  // the emitter (uniform draws: floor lo and fp32 span)
  float center[3], radius, vel_base[3], vel_spread;
  float life_lo, life_span, size_lo, size_span;
  float albedo_base[3], albedo_var;
  float third;                          // the radius draw's exponent 1/3
  float normal_lo, normal_span;         // uniform(-1 + ulp, 1)
  float sqrt2;
  float erfinv_lt[kErfinvTerms], erfinv_ge[kErfinvTerms];
  float eps;                            // the direction norm's clamp
  uint32_t vol_span, vol_mult;          // randint's span and multiplier
  // the forces
  float gravity[3], drag, curl_strength;
  int curl;                             // curl_strength != 0
  float curl_freq, fd_h, fd_den, t_scale;
  float pot_off[3][3];                  // per potential
  uint32_t curl_seed[3];                // seed word of curl_seed + comp
};

// mirrors SimTensors in volq_torch/sim/kernel.py: the state in and out
struct SimTensors {
  const float *pos, *vel, *age, *life, *size, *albedo;
  const int* vol;
  const int* frame;
  const float *carry, *time;
  const long long* key;                 // base key: two uint32 in int64
  float *pos_o, *vel_o, *age_o, *life_o, *size_o, *albedo_o;
  int* vol_o;
  int* frame_o;
  float *carry_o, *time_o;
};

struct Words {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// sim/prng.py's threefry2x32 of key (k1, k2) on the counter (x1, x2)
__device__ __forceinline__ Words threefry(uint32_t k1, uint32_t k2,
                                          uint32_t x1, uint32_t x2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = x1 + k1;
  x1 = x2 + k2;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return {x0, x1};
}

// key i of split(key), and fold_in(key, data): threefry(key, (0, i))
__device__ __forceinline__ Words fold(Words k, uint32_t i) {
  return threefry(k.a, k.b, 0u, i);
}

// random_bits(key) word ``i``
__device__ __forceinline__ uint32_t bits(Words k, uint32_t i) {
  const Words o = fold(k, i);
  return o.a ^ o.b;
}

// prng.uniform: mantissa bits under exponent 0, then the fused
// multiply-add in double, floored at lo
__device__ __forceinline__ float uniform(uint32_t b, float lo, float span) {
  const float f = __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
  const float u = (float)((double)f * (double)span + (double)lo);
  return u != u ? u : fmaxf(lo, u);
}

// prng._erfinv_f32 (XLA's fp32 ErfInv, its steps in double as prng._fma)
__device__ __forceinline__ float erfinv(float x, const SimParams& p) {
  const float w0 = -log1pf(-(x * x));
  const bool lt = w0 < 5.0f;
  const float w = lt ? w0 - 2.5f : sqrtf(w0) - 3.0f;
  float q = lt ? p.erfinv_lt[0] : p.erfinv_ge[0];
#pragma unroll
  for (int k = 1; k < kErfinvTerms; ++k) {
    const float c = lt ? p.erfinv_lt[k] : p.erfinv_ge[k];
    q = (float)((double)q * (double)w + (double)c);
  }
  const float r = q * x;
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7F800000) : r;
}

__device__ __forceinline__ float normal(uint32_t b, const SimParams& p) {
  return p.sqrt2 * erfinv(uniform(b, p.normal_lo, p.normal_span), p);
}

struct Fresh {
  float pos[3], vel[3], life, size, albedo[3];
  int vol;
};

// sim/emit.py's spawn_attrs for one slot id under the frame's key
__device__ __forceinline__ Fresh spawn_one(Words key, uint32_t slot,
                                           const SimParams& p) {
  const Words s = fold(key, slot);
  // split(7): kp, kr, kv, kl, ks, ka, kb
  const Words kp = fold(s, 0), kr = fold(s, 1), kv = fold(s, 2),
              kl = fold(s, 3), ks = fold(s, 4), ka = fold(s, 5),
              kb = fold(s, 6);
  Fresh f;
  float d[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) d[c] = normal(bits(kp, c), p);
  float norm = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
  norm = norm != norm ? norm : fmaxf(norm, p.eps);
  const float r = p.radius * powf(uniform(bits(kr, 0), 0.0f, 1.0f), p.third);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f.pos[c] = p.center[c] + d[c] / norm * r;
    f.vel[c] = p.vel_base[c] + p.vel_spread * normal(bits(kv, c), p);
    f.albedo[c] = p.albedo_base[c]
                  * (1.0f - p.albedo_var
                                * uniform(bits(ka, c), 0.0f, 1.0f));
  }
  f.life = uniform(bits(kl, 0), p.life_lo, p.life_span);
  f.size = uniform(bits(ks, 0), p.size_lo, p.size_span);
  // randint: two words of split(kb, 2) combined modulo the span
  const uint32_t hi = bits(fold(kb, 0), 0), lo = bits(fold(kb, 1), 0);
  const uint32_t off = (hi % p.vol_span) * p.vol_mult + lo % p.vol_span;
  f.vol = (int)(off % p.vol_span);
  return f;
}

__device__ __forceinline__ void store(const Fresh& f, const SimTensors& t,
                                      int i) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    t.pos_o[3 * i + c] = f.pos[c];
    t.vel_o[3 * i + c] = f.vel[c];
    t.albedo_o[3 * i + c] = f.albedo[c];
  }
  t.life_o[i] = f.life;
  t.size_o[i] = f.size;
  t.vol_o[i] = f.vol;
}

// incl[i]: dead slots among 0 .. i; dead_total (optional): all of them
__global__ void __launch_bounds__(kScanThreads)
    sim_scan_kernel(const float* __restrict__ age,
                    const float* __restrict__ life, int n, float dt,
                    int* __restrict__ incl, long long* dead_total) {
  __shared__ int warp_sum[kScanThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += kScanThreads * kScanItems) {
    const int first = base + threadIdx.x * kScanItems;
    bool dead[kScanItems];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      const int i = first + j;
      dead[j] = i < n && age[i] + dt >= life[i];
      mine += dead[j];
    }
    int x = mine;  // inclusive scan over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    if (warp == 0) {
      int v = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, v, o);
        if (lane >= o) v += y;
      }
      warp_sum[lane] = v;
    }
    __syncthreads();
    int run = carry + (warp ? warp_sum[warp - 1] : 0) + x - mine;
#pragma unroll
    for (int j = 0; j < kScanItems; ++j) {
      run += dead[j];
      if (first + j < n) incl[first + j] = run;
    }
    carry += warp_sum[kScanThreads / 32 - 1];
    __syncthreads();
  }
  if (threadIdx.x == 0 && dead_total) *dead_total = carry;
}

// rank_offset (optional): dead slots on the ranks before this one;
// slot_offset: this rank's first global slot id
__global__ void __launch_bounds__(kThreads)
    sim_spawn_kernel(const SimTensors t, const int* __restrict__ incl,
                     const long long* rank_offset, int slot_offset, int n,
                     const SimParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float budget = t.carry[0] + p.rate * p.dt;
  const float n_spawn = floorf(budget);
  if (i == 0) {
    t.frame_o[0] = (int)((uint32_t)t.frame[0] + 1u);
    t.carry_o[0] = budget - n_spawn;
    t.time_o[0] = t.time[0] + p.dt;
  }
  if (i >= n) return;
  const float age = t.age[i] + p.dt;
  const bool dead = age >= t.life[i];
  if (dead) {
    const long long rank =
        (rank_offset ? rank_offset[0] : 0LL) + (long long)incl[i] - 1;
    if ((float)rank < n_spawn) {
      const Words key = threefry((uint32_t)t.key[0], (uint32_t)t.key[1], 0u,
                                 (uint32_t)t.frame[0]);
      store(spawn_one(key, (uint32_t)(slot_offset + i), p), t, i);
      t.age_o[i] = 0.0f;
      return;
    }
  }
  t.age_o[i] = age;
  t.life_o[i] = t.life[i];
  t.size_o[i] = t.size[i];
  t.vol_o[i] = t.vol[i];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    t.albedo_o[3 * i + c] = t.albedo[3 * i + c];
    if (dead) {
      t.pos_o[3 * i + c] = t.pos[3 * i + c];
      t.vel_o[3 * i + c] = t.vel[3 * i + c];
    }
  }
}

// sim/forces.py's potential ``comp`` at point q and its time term
__device__ __forceinline__ float potential(const float (&q)[3], int comp,
                                           float tt, const SimParams& p) {
  float s[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    s[a] = q[a] * p.curl_freq + p.pot_off[comp][a];
  s[0] = s[0] + 0.0f;
  s[1] = s[1] + tt;
  s[2] = s[2] + 0.0f;
  return perlin<3>(s, p.curl_seed[comp]);
}

__global__ void __launch_bounds__(kThreads)
    sim_forces_kernel(const SimTensors t, int n, const SimParams p) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n || t.age[i] + p.dt >= t.life[i]) return;  // dead: sim_spawn's
  float pos[3], vel[3], f[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pos[c] = t.pos[3 * i + c];
    vel[c] = t.vel[3 * i + c];
    f[c] = p.gravity[c] - p.drag * vel[c];
  }
  if (p.curl) {
    // dd[comp][axis]: potential comp differentiated along axis
    const int axes[3][2] = {{2, 1}, {2, 0}, {1, 0}};
    const float tt = p.t_scale * t.time[0];
    float dd[3][3];
#pragma unroll
    for (int comp = 0; comp < 3; ++comp) {
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int axis = axes[comp][k];
        float qp[3], qm[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float e = a == axis ? p.fd_h : 0.0f;
          qp[a] = pos[a] + e;
          qm[a] = pos[a] - e;
        }
        dd[comp][axis] = (potential(qp, comp, tt, p)
                          - potential(qm, comp, tt, p)) / p.fd_den;
      }
    }
    const float curl[3] = {dd[2][1] - dd[1][2], dd[0][2] - dd[2][0],
                           dd[1][0] - dd[0][1]};
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] = f[c] + p.curl_strength * curl[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = vel[c] + f[c] * p.dt;
    t.vel_o[3 * i + c] = v;
    t.pos_o[3 * i + c] = pos[c] + v * p.dt;
  }
}

static int blocks(int n) { return n > 0 ? (n + kThreads - 1) / kThreads : 1; }

extern "C" int sim_scan_launch(const float* age, const float* life, int n,
                               float dt, int* incl, long long* dead_total,
                               void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  sim_scan_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      age, life, n, dt, incl, dead_total);
  return (int)cudaGetLastError();
}

extern "C" int sim_spawn_launch(SimTensors t, const int* incl,
                                const long long* rank_offset,
                                int slot_offset, int n, SimParams p,
                                void* stream) {
  if (n < 0 || p.vol_span == 0) return (int)cudaErrorInvalidValue;
  sim_spawn_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      t, incl, rank_offset, slot_offset, n, p);
  return (int)cudaGetLastError();
}

extern "C" int sim_forces_launch(SimTensors t, int n, SimParams p,
                                 void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  sim_forces_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(t, n,
                                                                      p);
  return (int)cudaGetLastError();
}
