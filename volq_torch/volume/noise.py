"""Hash-gradient 3D/4D noise + fBm (mirror of ``volq/volume/noise.py``).

The hashes are wrapping uint32 arithmetic.  torch has no full uint32
arithmetic, so a hash word lives in an int64 tensor holding a value in
[0, 2^32) and every multiply and shift is masked back to 32 bits.  A
multiply by a constant M >= 2^31 uses M - 2^32 instead (same product
mod 2^32), so no int64 product can overflow.  ``ix.astype(uint32)`` of
a negative int wraps: masking the (signed) product gives the same low
32 bits.  The gradient math is fp32, in the reference's operation
order.  The 4-D variant (xyz + time) is the animated density of preset
c5: one more lattice axis hashed with ``_K4``, one more gradient
component, and the 16 corners lerped over w first, then z, y, x.
"""
from __future__ import annotations

import torch

from volq_torch.core.device import h2d

_MASK = 0xFFFFFFFF

_K1 = 0x8DA6B343
_K2 = 0xD8163841
_K3 = 0xCB1AB31F
_K4 = 0x165667B1
_KSEED = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _signed(m: int) -> int:
    """The int64 multiplier congruent to ``m`` mod 2^32 with |value| <
    2^31, so ``x * value`` fits in int64 for any |x| < 2^32."""
    return m - (1 << 32) if m >= (1 << 31) else m


def _mul(h, m: int):
    """(h * m) mod 2^32 for an int64 tensor h with |h| < 2^32."""
    return (h * _signed(m)) & _MASK


def _mix(h):
    h = h ^ (h >> 13)
    h = _mul(h, _M1)
    h = h ^ (h >> 16)
    h = _mul(h, _M2)
    h = h ^ (h >> 15)
    return h


def _seed_word(seed: int) -> int:
    return ((seed & _MASK) * _KSEED) & _MASK


def _hash_base(ix, iy, iz, seed: int, iw=None):
    """Integer lattice coords (any int dtype, may be negative) -> uint32
    hash word in int64; ``iw`` is the 4-D lattice's fourth coordinate."""
    ix, iy, iz = ix.long(), iy.long(), iz.long()
    h = _mul(ix, _K1) ^ _mul(iy, _K2) ^ _mul(iz, _K3) ^ _seed_word(seed)
    if iw is not None:
        h = h ^ _mul(iw.long(), _K4)
    return _mix(h)


def _u2f(h):
    """uint32 word -> f32 in [-1, 1)."""
    return h.to(torch.float32) * (2.0 / 4294967296.0) - 1.0


def _fade(t):
    """Perlin smootherstep 6t^5 - 15t^4 + 10t^3."""
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def perlin3(p, seed: int):
    """3D gradient noise. p: [..., 3] f32 -> [...] f32, roughly [-1, 1]."""
    pf = torch.floor(p)
    pi = pf.to(torch.int32).long()
    f = p - pf
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    wx, wy, wz = _fade(fx), _fade(fy), _fade(fz)
    # the per-axis products of the lattice hash, shared by 4 corners each
    hx = [_mul(pi[..., 0] + c, _K1) for c in (0, 1)]
    hy = [_mul(pi[..., 1] + c, _K2) for c in (0, 1)]
    hz = [_mul(pi[..., 2] + c, _K3) for c in (0, 1)]
    s = _seed_word(seed)

    def corner(cx, cy, cz):
        h = _mix(hx[cx] ^ hy[cy] ^ hz[cz] ^ s)
        gx = _u2f(h)
        gy = _u2f(_mix(h ^ _K1))
        gz = _u2f(_mix(h ^ _K2))
        return gx * (fx - cx) + gy * (fy - cy) + gz * (fz - cz)

    n000, n001 = corner(0, 0, 0), corner(0, 0, 1)
    n010, n011 = corner(0, 1, 0), corner(0, 1, 1)
    n100, n101 = corner(1, 0, 0), corner(1, 0, 1)
    n110, n111 = corner(1, 1, 0), corner(1, 1, 1)

    n00 = n000 + (n001 - n000) * wz
    n01 = n010 + (n011 - n010) * wz
    n10 = n100 + (n101 - n100) * wz
    n11 = n110 + (n111 - n110) * wz
    n0 = n00 + (n01 - n00) * wy
    n1 = n10 + (n11 - n10) * wy
    return n0 + (n1 - n0) * wx


def perlin4(p, seed: int):
    """4D gradient noise. p: [..., 4] f32 (xyz + time) -> [...] f32."""
    pf = torch.floor(p)
    pi = pf.to(torch.int32).long()
    f = p - pf
    fx, fy, fz, fw = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    wx, wy, wz, ww = _fade(fx), _fade(fy), _fade(fz), _fade(fw)
    hx = [_mul(pi[..., 0] + c, _K1) for c in (0, 1)]
    hy = [_mul(pi[..., 1] + c, _K2) for c in (0, 1)]
    hz = [_mul(pi[..., 2] + c, _K3) for c in (0, 1)]
    hw = [_mul(pi[..., 3] + c, _K4) for c in (0, 1)]
    s = _seed_word(seed)

    def corner(cx, cy, cz, cw):
        h = _mix(hx[cx] ^ hy[cy] ^ hz[cz] ^ s ^ hw[cw])
        gx = _u2f(h)
        gy = _u2f(_mix(h ^ _K1))
        gz = _u2f(_mix(h ^ _K2))
        gw = _u2f(_mix(h ^ _K3))
        return gx * (fx - cx) + gy * (fy - cy) + gz * (fz - cz) \
            + gw * (fw - cw)

    def lerp(a, b, w):
        return a + (b - a) * w

    # over w first, then z, y, x (16 corners)
    n000, n001, n010, n011, n100, n101, n110, n111 = (
        lerp(corner(cx, cy, cz, 0), corner(cx, cy, cz, 1), ww)
        for cx in (0, 1) for cy in (0, 1) for cz in (0, 1))
    n00 = lerp(n000, n001, wz)
    n01 = lerp(n010, n011, wz)
    n10 = lerp(n100, n101, wz)
    n11 = lerp(n110, n111, wz)
    n0 = lerp(n00, n01, wy)
    n1 = lerp(n10, n11, wy)
    return lerp(n0, n1, wx)


def _fbm(noise, p, seed: int, octaves: int, lacunarity: float, gain: float):
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * noise(p * freq, seed + o)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return total / h2d(norm, p.device, torch.float32)


def fbm3(p, seed: int, *, octaves: int = 4, lacunarity: float = 2.0,
         gain: float = 0.5):
    """Fractal Brownian motion over perlin3, normalized to ~[-1, 1]."""
    return _fbm(perlin3, p, seed, octaves, lacunarity, gain)


def fbm4(p, seed: int, *, octaves: int = 4, lacunarity: float = 2.0,
         gain: float = 0.5):
    """Fractal Brownian motion over perlin4."""
    return _fbm(perlin4, p, seed, octaves, lacunarity, gain)
