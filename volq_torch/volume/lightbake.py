"""Light optical-depth bake (mirror of ``volq/volume/lightbake.py``).

The directional-light optical depth is baked into a volume per bank
entry by a slice sweep: starting from the light-entry face, each slice's
accumulated depth is the previous (closer-to-light) slice's depth
resampled along the in-plane light drift plus the local density
contribution (trapezoid rule).  Shifts and lerps only.

The baked value is tau_raw, the integral of unit-scale density over the
path in normalized extent (the volume as a unit cube); the march applies
``atten = exp(-density_scale * fade * ext * tau)`` per particle.

The sweep runs along the volume axis most aligned with the light
(``dominant_axis``), so the in-plane drift per slice is at most about
one voxel.  The drift toward the light is L_plane / |L_axis| whichever
face the light enters; only the sweep order depends on the sign.
"""
from __future__ import annotations

import torch

from volq_torch.core import trace
from volq_torch.core.device import d2h

# floor of |L_axis|: unreachable through dominant_axis (>= 1/sqrt(3))
MIN_LAXIS = 0.15
# bank entries swept at once (bounds the fp32 temporaries)
_BAKE_CHUNK = 64


def dominant_axis(direction) -> int:
    """World axis index (0=x, 1=y, 2=z) with the largest |component| of
    the (static, config) light direction."""
    d = [abs(float(direction[i])) for i in range(3)]
    return int(max(range(3), key=lambda i: d[i]))


# Volume storage is z-major [M, V_z, V_x, V_y].  For a sweep along world
# axis w: (permutation putting w's volume dim at axis 1, its inverse,
# light component on the permuted dim -2, on dim -1).
_SWEEPS = {
    2: ((0, 1, 2, 3), (0, 1, 2, 3), 0, 1),   # sweep z; plane dims (x, y)
    0: ((0, 2, 1, 3), (0, 2, 1, 3), 2, 1),   # sweep x; plane dims (z, y)
    1: ((0, 3, 1, 2), (0, 2, 3, 1), 2, 0),   # sweep y; plane dims (z, x)
}


def _split(d: torch.Tensor):
    """Shift d -> (integer part as a Python int, fraction as an fp32
    tensor): floor, then the cast, as the reference."""
    i0f = torch.floor(d)
    return int(d2h(i0f)), d - i0f


def _shift1(a, d, axis: int):
    """out[..., k, ...] = lerp of a at k + d along ``axis`` (-2 or -1),
    zero outside; ``d`` a tensor or its ``_split``."""
    n = a.shape[axis]
    i0, f = d if isinstance(d, tuple) else _split(d)
    pads = [0, 0, 0, 0]
    pads[2 * (-1 - axis):2 * (-1 - axis) + 2] = [n, n]
    padded = torch.nn.functional.pad(a, pads)
    a0 = padded.narrow(axis, n + i0, n)
    a1 = padded.narrow(axis, n + i0 + 1, n)
    return a0 + (a1 - a0) * f


def _shift2d(a, dx, dy):
    """Shift [..., X, Y] by (+dx, +dy) fractional voxels, zero padding:
    out[x, y] = a[x + dx, y + dy] (bilinear, vacuum outside)."""
    return _shift1(_shift1(a, dx, -2), dy, -1)


def bake_light_volumes(volumes, light_dir, axis: int = 2):
    """volumes: [M, V, V, V] (z-major) densities.  light_dir: [3] fp32
    unit vector toward the light.  axis: static world axis to sweep
    along (``dominant_axis(cfg.light.direction)``).  Returns tau_raw
    [M, V, V, V] fp32 in the original z-major layout."""
    perm, inv_perm, ci, cj = _SWEEPS[axis]
    M, V = volumes.shape[0], volumes.shape[-1]
    light_dir = light_dir.to(torch.float32)
    la = light_dir[axis]
    ala = torch.clamp(torch.abs(la), min=MIN_LAXIS)
    # in-plane drift toward the light per one-voxel step along the sweep
    # axis, and the path length per step for a unit-cube volume; the
    # drift sign does not depend on sign(la)
    dx = _split(light_dir[ci] / ala)
    dy = _split(light_dir[cj] / ala)
    dl = (1.0 / (V - 1)) / ala
    # from the light-entry face inward: la >= 0 enters at k = V - 1
    ks = range(V - 1, -1, -1) if d2h(la >= 0) else range(V)

    out = torch.empty((M, V, V, V), dtype=torch.float32,
                      device=volumes.device)
    for c0 in range(0, M, _BAKE_CHUNK):
        vols = volumes[c0:c0 + _BAKE_CHUNK].to(torch.float32).permute(perm)
        taus = torch.empty_like(vols)          # ascending storage [m, k]
        tau_prev = torch.zeros_like(vols[:, 0])
        sig_prev = None
        for k in ks:
            sig_k = vols[:, k]
            if sig_prev is not None:
                # the path from this slice's voxel centers toward the
                # light crosses the previous slice at (+dx, +dy) voxels
                tau_prev = (_shift2d(tau_prev, dx, dy)
                            + 0.5 * (sig_k + _shift2d(sig_prev, dx, dy)) * dl)
            taus[:, k] = tau_prev              # entry slice: tau = 0
            sig_prev = sig_k
        out[c0:c0 + _BAKE_CHUNK] = taus.permute(inv_perm)
    return out


def render_light_volumes(volumes, light, cfg):
    """The light bank the render reads: ``volumes`` baked toward
    ``light`` for the lit modes (slab and warp engines with
    ``light_steps > 0``), else None."""
    r = cfg.render
    with trace.span("volq.bake.light"):
        if r.engine in ("slab", "warp") and r.light_steps > 0:
            return bake_light_volumes(volumes, light.direction,
                                      axis=dominant_axis(cfg.light.direction))
        return None
