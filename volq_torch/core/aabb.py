"""Ray-AABB slab intersection (counterpart of ``volq/core/aabb.py``).

The marched segment is [t0, t1] with t0 = max(t_enter, 0), t1 = t_exit;
a hit requires t1 > t0.  Degenerate direction components are made safe by
clamping |d| >= 1e-12 with the original sign, which keeps every product
finite and classifies outside-parallel rays as misses.
"""
from __future__ import annotations

import torch

_TINY = 1e-12


def ray_aabb(origin, direction, lo, hi):
    """Slab test.  origin / direction: [..., 3]; lo / hi: broadcastable
    [..., 3].  Returns (t0, t1), the clipped entry and exit distances; the
    segment is empty (a miss) iff t1 <= t0."""
    d = direction
    sign = torch.where(d >= 0, 1.0, -1.0)
    d_safe = torch.where(torch.abs(d) < _TINY, sign * _TINY, d)
    inv = 1.0 / d_safe
    ta = (lo - origin) * inv
    tb = (hi - origin) * inv
    tmin = torch.minimum(ta, tb).amax(dim=-1)
    tmax = torch.maximum(ta, tb).amin(dim=-1)
    return torch.clamp(tmin, min=0.0), tmax
