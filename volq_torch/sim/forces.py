"""Particle forces (mirror of ``volq/sim/forces.py``): gravity, linear
drag and curl noise (the curl of three Perlin potentials, by central
differences).  The four difference points of each potential are
evaluated in one batched ``perlin3`` call; the noise is elementwise, so
the values equal the reference's one-point-at-a-time evaluation.
"""
from __future__ import annotations

import torch

from volq_torch.core import trace
from volq_torch.core.device import h2d, scalar
from volq_torch.scene.config import ForcesConfig
from volq_torch.volume.noise import perlin3

_FD_H = 0.05
_POT_OFF = ((0.0, 0.0, 0.0), (31.416, 47.853, 12.793),
            (-19.113, 33.437, 7.661))
# the two axes each potential is differentiated along (curl terms)
_POT_AXES = {0: (2, 1), 1: (2, 0), 2: (1, 0)}


def _potential(q, comp: int, t, cfg: ForcesConfig):
    """Potential ``comp`` at points q [..., 3] and times t [...]."""
    off = h2d(_POT_OFF[comp], q.device, torch.float32)
    q = q * cfg.curl_freq + off
    z = torch.zeros_like(t)
    q = q + torch.stack([z, 0.1 * t, z], -1)
    return perlin3(q, cfg.curl_seed + comp)


def curl_noise(p, t, cfg: ForcesConfig):
    """Divergence-free velocity field at world points p [N, 3]."""
    h = _FD_H
    den = scalar(2.0 * h, p)
    dd = {}
    for comp, axes in _POT_AXES.items():
        pts = []
        for axis in axes:
            e = h2d([h if i == axis else 0.0 for i in range(3)], p.device,
                    torch.float32)
            pts += [p + e, p - e]
        v = _potential(torch.stack(pts), comp, t[None].expand(4, -1), cfg)
        for i, axis in enumerate(axes):
            dd[comp, axis] = (v[2 * i] - v[2 * i + 1]) / den
    cx = dd[2, 1] - dd[1, 2]
    cy = dd[0, 2] - dd[2, 0]
    cz = dd[1, 0] - dd[0, 1]
    return torch.stack([cx, cy, cz], dim=-1)


def total_force(pos, vel, t, cfg: ForcesConfig):
    """Per-particle acceleration [N, 3] (unit mass)."""
    with trace.span("volq.sim.forces"):
        g = h2d(cfg.gravity, pos.device, torch.float32)
        f = g.expand_as(pos) - cfg.drag * vel
        if cfg.curl_strength != 0.0:
            tt = t.to(torch.float32).expand(pos.shape[:-1])
            f = f + cfg.curl_strength * curl_noise(pos, tt, cfg)
        return f
