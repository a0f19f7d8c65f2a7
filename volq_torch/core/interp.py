"""Trilinear sampling of 3-D density grids (counterpart of
``volq/core/interp.py``).

A volume is a [V, V, V] grid of samples at positions u * (V - 1) for
local coordinates u in [0, 1]^3, stored z-major: the array is
[V_z, V_x, V_y] and element (x, y, z) lives at lin = (z * V + x) * V + y.
The base cell is floor(g) clamped to [0, V-2] and the fractions are
clamped to [0, 1], so queries are defined slightly outside the box.
Volumes are stored bf16 and widened to fp32 before the interpolation.
"""
from __future__ import annotations

import torch


def trilinear_weights(u, size: int):
    """Base cell i0 [..., 3] int32 and fractions f [..., 3] fp32 of local
    coordinates u [..., 3]."""
    g = u.to(torch.float32) * (size - 1)
    i0 = torch.clamp(torch.floor(g), 0, size - 2).to(torch.int32)
    f = torch.clamp(g - i0.to(torch.float32), 0.0, 1.0)
    return i0, f


def sample_bank_trilinear(bank2d, size: int, vol, u):
    """Trilinearly sample per-point volumes from a bank.

    bank2d: [M, V^3] densities (any float dtype; math in fp32).  The 2-D
            layout keeps the in-volume index within int32 even when
            M * V^3 reaches 2^31 (1024 volumes of 128^3 do exactly); the
            two indices are widened to int64 for the gather, never
            flattened into one.
    size:   V.
    vol:    [...] integer volume index (bank row) per point.
    u:      [..., 3] fp32 local coordinates in [0, 1]^3 (x, y, z order).
    Returns [...] fp32 densities.
    """
    V = size
    i0, f = trilinear_weights(u, V)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    lin000 = ((z0 * V + x0) * V + y0).long()
    row = vol.long()

    def fetch(off):
        return bank2d[row, lin000 + off].to(torch.float32)

    # corner offsets in the z-major linearization: +1 => y+1, +V => x+1,
    # +V^2 => z+1
    c000 = fetch(0)
    c001 = fetch(V * V)
    c010 = fetch(1)
    c011 = fetch(V * V + 1)
    c100 = fetch(V)
    c101 = fetch(V * V + V)
    c110 = fetch(V + 1)
    c111 = fetch(V * V + V + 1)

    c00 = c000 + (c001 - c000) * fz
    c01 = c010 + (c011 - c010) * fz
    c10 = c100 + (c101 - c100) * fz
    c11 = c110 + (c111 - c110) * fz
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fx
