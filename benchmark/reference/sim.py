"""Plain reference of volq's particle simulation, in torch on any device.

A frozen copy of the semantics of ``volq/sim/`` (jax.random's threefry2x32
with ``jax_threefry_partitionable``, ring-buffer emission, gravity + drag +
curl noise, explicit Euler): the same operations in the same fp32 order, so
a correct program agrees with it to rounding.  It differs in structure from
the program: fresh attributes are drawn only for the slots that spawn.

``lowp`` rounds the float state to bfloat16 after every step: the
lower-precision control of the comparison (the configuration states fp32).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


class Particles(NamedTuple):
    pos: torch.Tensor       # [N, 3] f32
    vel: torch.Tensor       # [N, 3] f32
    age: torch.Tensor       # [N] f32
    lifetime: torch.Tensor  # [N] f32
    size: torch.Tensor      # [N] f32
    albedo: torch.Tensor    # [N, 3] f32
    vol_idx: torch.Tensor   # [N] i32


class SimState(NamedTuple):
    particles: Particles
    frame: torch.Tensor     # [] i32
    carry: torch.Tensor     # [] f32
    time: torch.Tensor      # [] f32
    key: torch.Tensor       # [2] int64 holding two uint32 words


# ---------------------------------------------------------------- threefry

def _rotl(x, r):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1, k2, x1, x2):
    k3 = k1 ^ k2 ^ 0x1BD11BDA
    ks = (k1, k2, k3)
    x0 = (x1 + k1) & _MASK
    x1 = (x2 + k2) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def prng_key(seed, device):
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def fold_in(keys, data):
    if not torch.is_tensor(data):
        data = torch.tensor(int(data), dtype=torch.int64, device=keys.device)
    data = data.long() & _MASK
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(data),
                          data)
    return torch.stack([o1, o2], dim=-1)


def _hash(keys, counts):
    nb = counts.dim()
    k1 = keys[..., 0].reshape(keys.shape[:-1] + (1,) * nb)
    k2 = keys[..., 1].reshape(keys.shape[:-1] + (1,) * nb)
    return threefry2x32(k1, k2, torch.zeros_like(counts), counts)


def split(keys, num):
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    o1, o2 = _hash(keys, counts)
    return torch.stack([o1, o2], dim=-1)


def random_bits(keys, shape=()):
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64,
                          device=keys.device).reshape(shape)
    o1, o2 = _hash(keys, counts)
    return o1 ^ o2


def _fma(a, b, c):
    # one rounding, as XLA's fused multiply-add inside jax.random
    return (a.double() * b + c).float()


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x):
    # XLA's fp32 ErfInv (Giles), multiply-adds fused
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, torch.full_like(x, _ERFINV_LT5[0]),
                    torch.full_like(x, _ERFINV_GE5[0]))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        c = torch.where(lt, torch.full_like(x, a), torch.full_like(x, b))
        p = _fma(p, w.double(), c.double())
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def uniform(keys, shape=(), lo=0.0, hi=1.0):
    return _unit(random_bits(keys, shape), lo, hi)


def normal(keys, shape=()):
    return _SQRT2 * _erfinv(uniform(keys, shape, _NLO, 1.0))


# ------------------------------------------------------------- emission

def _vec(v, dev):
    return torch.tensor(v, dtype=torch.float32, device=dev)


def _draws(keys, counts):
    """threefry bits of each key at each (key index, count) pair: keys
    [n, k, 2], counts [k] -> [n, k] words (bits1 ^ bits2)."""
    c = torch.tensor(counts, dtype=torch.int64, device=keys.device)
    o1, o2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(c), c)
    return o1 ^ o2


def _unit(bits, lo, hi):
    """jax.random.uniform's float of the bits, in [lo, hi)."""
    fb = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = fb.view(torch.float32) - 1.0
    lo32 = np.float32(lo)
    span = float(np.float32(hi) - lo32)
    return torch.maximum(torch.tensor(lo32, device=bits.device),
                         _fma(floats, span, float(lo32)))


# the per-slot draws of a spawn, by key index (kp kr kv kl ks ka) and count
_SPAWN = (0, 0, 0, 1, 2, 2, 2, 3, 4, 5, 5, 5)
_COUNT = (0, 1, 2, 0, 0, 1, 2, 0, 0, 0, 1, 2)
_NLO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2)))


def spawn_attrs(key, slots, e, bank_size):
    """Fresh attributes of the given slot ids under ``key``: the draws of
    jax.random.split / uniform / normal / randint, batched over slots."""
    keys = fold_in(key, slots)
    k = split(keys, 7)
    dev = keys.device
    bits = _draws(k[:, list(_SPAWN)], _COUNT)
    nrm = _SQRT2 * _erfinv(_unit(bits[:, [0, 1, 2, 4, 5, 6]], _NLO, 1.0))
    d, gv = nrm[:, :3], nrm[:, 3:]
    norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])
    d = d / torch.clamp(norm, min=1e-6)[:, None]
    r = e.radius * _unit(bits[:, 3], 0.0, 1.0) ** (1.0 / 3.0)
    kb = split(k[:, 6], 2)
    ab = _draws(kb, (0, 0))
    span = bank_size & _MASK if bank_size > 0 else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = (((ab[:, 0] % span) * mult) & _MASK) + (ab[:, 1] % span)
    return dict(
        pos=_vec(e.center, dev) + d * r[:, None],
        vel=_vec(e.vel_base, dev) + e.vel_spread * gv,
        lifetime=_unit(bits[:, 7], e.life_min, e.life_max),
        size=_unit(bits[:, 8], e.size_min, e.size_max),
        albedo=_vec(e.albedo_base, dev)
        * (1.0 - e.albedo_var * _unit(bits[:, 9:12], 0.0, 1.0)),
        vol_idx=((off & _MASK) % span).to(torch.int32))


def init_state(cfg, device) -> SimState:
    """The scene's initial particles (init "random" or "grid")."""
    n = cfg.n_particles
    e = cfg.emitter
    base = prng_key(cfg.seed, device)
    ka, kj, kf = split(fold_in(base, 0x5EED), 3)
    fresh = spawn_attrs(ka, torch.arange(n, dtype=torch.int32,
                                         device=device),
                        e, cfg.volume.bank_size)
    lo, hi = cfg.init_age_frac
    age = fresh["lifetime"] * uniform(kf, (n,), lo, hi)
    pos = fresh["pos"]
    if cfg.init == "grid":
        f32 = dict(dtype=torch.float32, device=device)
        k = int(np.ceil(n ** (1.0 / 3.0)))
        idx = torch.arange(n, device=device)
        g = (torch.stack([idx // (k * k), (idx // k) % k, idx % k], -1)
             .to(torch.float32) - (k - 1) / 2.0) \
            / torch.tensor(max(k - 1, 1), **f32) * 2.0
        pos = torch.tensor(e.center, **f32) + g * e.radius \
            + 0.15 * e.radius * normal(kj, (n, 3))
    elif cfg.init != "random":
        raise ValueError(f"the reference covers init random and grid, not "
                         f"{cfg.init!r}")
    z = torch.zeros((), dtype=torch.float32, device=device)
    return SimState(
        Particles(pos=pos, vel=fresh["vel"], age=age,
                  lifetime=fresh["lifetime"], size=fresh["size"],
                  albedo=fresh["albedo"], vol_idx=fresh["vol_idx"]),
        frame=torch.zeros((), dtype=torch.int32, device=device),
        carry=z, time=z.clone(), key=base)


# ---------------------------------------------------------------- forces

_K1, _K2, _K3 = 0x8DA6B343, 0xD8163841, 0xCB1AB31F
_KSEED, _M1, _M2 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35


def _signed(m):
    return m - (1 << 32) if m >= (1 << 31) else m


def hmul(h, m):
    """(h * m) mod 2^32 on int64 words."""
    return (h * _signed(m)) & _MASK


def hmix(h):
    h = h ^ (h >> 13)
    h = hmul(h, _M1)
    h = h ^ (h >> 16)
    h = hmul(h, _M2)
    return h ^ (h >> 15)


def seed_word(seed):
    return ((seed & _MASK) * _KSEED) & _MASK


def u2f(h):
    return h.to(torch.float32) * (2.0 / 4294967296.0) - 1.0


def smooth(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(p, seed):
    pf = torch.floor(p)
    pi = pf.to(torch.int32).long()
    f = p - pf
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    hx = [hmul(pi[..., 0] + c, _K1) for c in (0, 1)]
    hy = [hmul(pi[..., 1] + c, _K2) for c in (0, 1)]
    hz = [hmul(pi[..., 2] + c, _K3) for c in (0, 1)]
    s = seed_word(seed)

    def corner(cx, cy, cz):
        h = hmix(hx[cx] ^ hy[cy] ^ hz[cz] ^ s)
        return (u2f(h) * (fx - cx) + u2f(hmix(h ^ _K1)) * (fy - cy)
                + u2f(hmix(h ^ _K2)) * (fz - cz))

    def lerp(a, b, w):
        return a + (b - a) * w

    wx, wy, wz = smooth(fx), smooth(fy), smooth(fz)
    n00 = lerp(corner(0, 0, 0), corner(0, 0, 1), wz)
    n01 = lerp(corner(0, 1, 0), corner(0, 1, 1), wz)
    n10 = lerp(corner(1, 0, 0), corner(1, 0, 1), wz)
    n11 = lerp(corner(1, 1, 0), corner(1, 1, 1), wz)
    return lerp(lerp(n00, n01, wy), lerp(n10, n11, wy), wx)


_FD_H = 0.05
_POT_OFF = ((0.0, 0.0, 0.0), (31.416, 47.853, 12.793),
            (-19.113, 33.437, 7.661))
_POT_AXES = {0: (2, 1), 1: (2, 0), 2: (1, 0)}


def _curl(p, t, fc):
    """Curl of the three potentials by central differences, the twelve
    difference points of all three in one noise evaluation."""
    dev = p.device
    den = torch.tensor(2.0 * _FD_H, dtype=torch.float32, device=dev)
    qs = []
    for comp, axes in _POT_AXES.items():
        pts = []
        for axis in axes:
            e = torch.zeros(3, dtype=torch.float32, device=dev)
            e[axis] = _FD_H
            pts += [p + e, p - e]
        qs.append(torch.stack(pts) * fc.curl_freq + torch.tensor(
            _POT_OFF[comp], dtype=torch.float32, device=dev))
    tt = t[None].expand(4, -1)
    z = torch.zeros_like(tt)
    q = torch.stack(qs) + torch.stack([z, 0.1 * tt, z], -1)
    v = perlin3(q, torch.tensor([fc.curl_seed + c for c in range(3)],
                                dtype=torch.int64, device=dev)[:, None, None])
    dd = {}
    for comp, axes in _POT_AXES.items():
        for i, axis in enumerate(axes):
            dd[comp, axis] = (v[comp, 2 * i] - v[comp, 2 * i + 1]) / den
    return torch.stack([dd[2, 1] - dd[1, 2], dd[0, 2] - dd[2, 0],
                        dd[1, 0] - dd[0, 1]], dim=-1)


def _force(pos, vel, t, fc):
    f = torch.tensor(fc.gravity, dtype=torch.float32,
                     device=pos.device).expand_as(pos) - fc.drag * vel
    if fc.curl_strength != 0.0:
        f = f + fc.curl_strength * _curl(
            pos, t.to(torch.float32).expand(pos.shape[:-1]), fc)
    return f


# ------------------------------------------------------------------ step

def _bf16(x):
    return x.to(torch.bfloat16).to(x.dtype)


def step(st: SimState, cfg, lowp=False, force_device=None) -> SimState:
    """One sim step.  ``force_device``: where the forces (the curl noise
    over every particle, most of the step's work) are evaluated; the
    same fp32 operations give the same values on either device."""
    p = st.particles
    n = p.age.shape[0]
    dev = p.age.device
    dt = torch.tensor(np.float32(cfg.dt), device=dev)
    key = fold_in(st.key, st.frame)
    age = p.age + dt
    dead = age >= p.lifetime
    budget = st.carry + cfg.emitter.rate * dt
    n_spawn = torch.floor(budget)
    rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    spawn = dead & (rank.to(torch.float32) < n_spawn)
    slots = torch.nonzero(spawn).flatten().to(torch.int32)
    pos, vel, lifetime = p.pos.clone(), p.vel.clone(), p.lifetime.clone()
    size, albedo, vol_idx = p.size.clone(), p.albedo.clone(), \
        p.vol_idx.clone()
    if slots.numel():
        fresh = spawn_attrs(key, slots, cfg.emitter, cfg.volume.bank_size)
        i = slots.long()
        pos[i], vel[i], lifetime[i] = fresh["pos"], fresh["vel"], \
            fresh["lifetime"]
        size[i], albedo[i], vol_idx[i] = fresh["size"], fresh["albedo"], \
            fresh["vol_idx"]
        age[i] = 0.0
    fd = force_device or dev
    f = _force(pos.to(fd), vel.to(fd), st.time.to(fd), cfg.forces).to(dev)
    vel_new = vel + f * dt
    pos_new = pos + vel_new * dt
    adv = ((~dead) & (~spawn))[:, None]
    parts = Particles(pos=torch.where(adv, pos_new, pos),
                      vel=torch.where(adv, vel_new, vel), age=age,
                      lifetime=lifetime, size=size, albedo=albedo,
                      vol_idx=vol_idx)
    carry, time = budget - n_spawn, st.time + dt
    if lowp:
        parts = Particles(*(_bf16(a) if a.is_floating_point() else a
                            for a in parts))
        carry, time = _bf16(carry), _bf16(time)
    return SimState(parts, st.frame + 1, carry, time, st.key)
