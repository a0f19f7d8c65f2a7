"""Plain reference of volq's volume banks, in torch on any device.

A frozen copy of the semantics of ``volq/volume/`` (hash-gradient fBm, the
carved puff, the 4-D animated bank, the light optical-depth sweep) and of
the warp engine's pre-lerped marching slabs: the same fp32 operations, entry
by entry, so a correct program agrees with it to rounding.  Banks are
[M, V, V, V] with array axes (entry, z, x, y).

``store`` is the dtype a bank is kept in: bfloat16 as configured, or
float8_e4m3fn for the lower-precision control.
"""
from __future__ import annotations

import torch

from .sim import hmix, hmul, seed_word, smooth, u2f, perlin3
from .warp import march_z_consts, slab_x_consts

_K1, _K2, _K3, _K4 = 0x8DA6B343, 0xD8163841, 0xCB1AB31F, 0x165667B1


def _hash(ix, iy, iz, seed):
    h = hmul(ix.long(), _K1) ^ hmul(iy.long(), _K2) ^ hmul(iz.long(), _K3) \
        ^ seed_word(seed)
    return hmix(h)


def perlin4(p, seed):
    pf = torch.floor(p)
    pi = pf.to(torch.int32).long()
    f = p - pf
    fs = [f[..., i] for i in range(4)]
    ws = [smooth(x) for x in fs]
    hs = [[hmul(pi[..., a] + c, k) for c in (0, 1)]
          for a, k in enumerate((_K1, _K2, _K3, _K4))]
    s = seed_word(seed)

    def corner(cx, cy, cz, cw):
        h = hmix(hs[0][cx] ^ hs[1][cy] ^ hs[2][cz] ^ s ^ hs[3][cw])
        return (u2f(h) * (fs[0] - cx) + u2f(hmix(h ^ _K1)) * (fs[1] - cy)
                + u2f(hmix(h ^ _K2)) * (fs[2] - cz)
                + u2f(hmix(h ^ _K3)) * (fs[3] - cw))

    def lerp(a, b, w):
        return a + (b - a) * w

    n = {(cx, cy, cz): lerp(corner(cx, cy, cz, 0), corner(cx, cy, cz, 1),
                            ws[3])
         for cx in (0, 1) for cy in (0, 1) for cz in (0, 1)}
    n00 = lerp(n[0, 0, 0], n[0, 0, 1], ws[2])
    n01 = lerp(n[0, 1, 0], n[0, 1, 1], ws[2])
    n10 = lerp(n[1, 0, 0], n[1, 0, 1], ws[2])
    n11 = lerp(n[1, 1, 0], n[1, 1, 1], ws[2])
    return lerp(lerp(n00, n01, ws[1]), lerp(n10, n11, ws[1]), ws[0])


def _fbm(noise, p, seed, octaves):
    total = torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device)
    amp, freq, norm = 1.0, 1.0, 0.0
    for o in range(octaves):
        total = total + amp * noise(p * freq, seed + o)
        norm += amp
        amp *= 0.5
        freq *= 2.0
    return total / torch.tensor(norm, dtype=torch.float32, device=p.device)


def bake(vc, ids, t=None, store=torch.bfloat16):
    """Bank entries ``ids`` of the volume config ``vc``: static fBm3, or
    (``t`` given, a 0-d fp32 tensor) the animated fBm4 at time ``t``.
    Returns [len(ids), V, V, V] in ``store``."""
    dev = ids.device
    V = vc.size
    ax = torch.arange(V, dtype=torch.float32, device=dev) \
        / torch.tensor(V - 1, dtype=torch.float32, device=dev)
    uz, ux, uy = torch.meshgrid(ax, ax, ax, indexing="ij")
    u = torch.stack([ux, uy, uz], dim=-1)
    d = (u - 0.5) * 2.0
    r2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    den = torch.tensor(max(1.0 - vc.cutoff, 1e-3), dtype=torch.float32,
                       device=dev)
    out = torch.empty((len(ids), V, V, V), dtype=store, device=dev)
    chunk = max(1, (1 << 24) // V ** 3)
    for c0 in range(0, len(ids), chunk):
        idx = ids[c0:c0 + chunk].to(torch.int32).long()
        off = torch.stack([u2f(_hash(idx, idx * 7 + c, idx * 13 + 2 * c,
                                     vc.seed + 101)) for c in range(3)],
                          -1) * 64.0
        xyz = ((u - 0.5) * vc.noise_scale)[None] + off[:, None, None, None]
        if t is None:
            n = _fbm(perlin3, xyz, vc.seed, vc.octaves)
        else:
            w = t * vc.time_scale + u2f(_hash(idx, idx * 3 + 1, idx * 5 + 2,
                                              vc.seed + 202)) * 16.0
            w = w[:, None, None, None, None].expand(*xyz.shape[:-1], 1)
            n = _fbm(perlin4, torch.cat([xyz, w], -1), vc.seed, vc.octaves)
        dens = torch.clamp(0.5 + 0.5 * n - (vc.cutoff + vc.edge * r2[None]),
                           min=0.0) / den
        out[c0:c0 + len(idx)] = torch.clamp(dens, max=1.0).to(store)
    return out


# ------------------------------------------------------------ light bake

# (permutation putting the sweep axis at dim 1, its inverse, the light
# components on the two plane dims)
_SWEEPS = {2: ((0, 1, 2, 3), (0, 1, 2, 3), 0, 1),
           0: ((0, 2, 1, 3), (0, 2, 1, 3), 2, 1),
           1: ((0, 3, 1, 2), (0, 2, 3, 1), 2, 0)}


def _split(d):
    i0f = torch.floor(d)
    return int(i0f), d - i0f


def _shift(a, d, axis):
    n = a.shape[axis]
    i0, f = d
    pads = [0, 0, 0, 0]
    pads[2 * (-1 - axis):2 * (-1 - axis) + 2] = [n, n]
    p = torch.nn.functional.pad(a, pads)
    a0 = p.narrow(axis, n + i0, n)
    return a0 + (p.narrow(axis, n + i0 + 1, n) - a0) * f


def light_bake(volumes, light_dir, light_cfg_dir, lowp=False):
    """Optical depth toward the light per voxel (trapezoid sweep along the
    axis most aligned with the configured light), fp32 [M, V, V, V];
    ``lowp`` keeps the sweep's running depth in bfloat16."""
    axis = int(max(range(3), key=lambda i: abs(float(light_cfg_dir[i]))))
    perm, inv, ci, cj = _SWEEPS[axis]
    V = volumes.shape[-1]
    ld = light_dir.to(torch.float32)
    la = ld[axis]
    ala = torch.clamp(torch.abs(la), min=0.15)
    dx, dy = _split(ld[ci] / ala), _split(ld[cj] / ala)
    dl = (1.0 / (V - 1)) / ala
    ks = range(V - 1, -1, -1) if bool(la >= 0) else range(V)
    vols = volumes.to(torch.float32).permute(perm)
    taus = torch.empty_like(vols)
    tau = torch.zeros_like(vols[:, 0])
    prev = None
    for k in ks:
        sig = vols[:, k]
        if prev is not None:
            tau = (_shift(_shift(tau, dx, -2), dy, -1)
                   + 0.5 * (sig + _shift(_shift(prev, dx, -2), dy, -1)) * dl)
            if lowp:
                tau = tau.to(torch.bfloat16).to(torch.float32)
        taus[:, k] = tau
        prev = sig
    return taus.permute(inv).contiguous()


# ------------------------------------------------------------ slab banks

def slabs(volumes, S, vx, store):
    """Pre-lerped marching slabs of an engine-coordinate bank [M, V, V, V]:
    [M, S, vx, V], z-lerped then x-resampled in fp32, kept in ``store``."""
    M, V = volumes.shape[0], volumes.shape[-1]
    out = torch.empty((M, S, vx, V), dtype=store, device=volumes.device)
    xc = slab_x_consts(vx, V) if vx != V else None
    for s, (z0, fz) in enumerate(march_z_consts(S, V)):
        a = volumes[:, z0].to(torch.float32)
        sl = a + (volumes[:, z0 + 1].to(torch.float32) - a) * fz
        if xc is not None:
            k0 = torch.tensor([k for k, _ in xc], device=sl.device)
            fx = torch.tensor([f for _, f in xc], dtype=torch.float32,
                              device=sl.device)[None, :, None]
            ka = sl.index_select(1, k0)
            sl = ka + (sl.index_select(1, k0 + 1) - ka) * fx
        out[:, s] = sl.to(store)
    return out
