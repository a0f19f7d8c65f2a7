"""Density-volume baking (mirror of ``volq/volume/bake.py``): static
banks from 3-D noise and the time-animated bank of 4-D noise, which the
frame loop re-bakes from the simulation time every frame.

fBm noise over a voxel lattice, carved by a radial falloff into a puff
that reaches zero before the AABB faces.  A bank is [M, V, V, V] with
array axes (entry, z, x, y), stored bf16.  Entries are baked in chunks
so peak memory stays bounded (the reference maps over entries with
``lax.map``); the result is independent of the chunk size.
"""
from __future__ import annotations

import torch

from volq_torch.core.device import h2d, resolve_device

from volq_torch.volume.noise import fbm3, fbm4, _hash_base, _u2f

# voxels per bake chunk: ~2^25 keeps the int64 hash temporaries of one
# chunk at a few GB on the card (16 entries of 128^3)
_CHUNK_VOXELS = 1 << 25


def _lattice(size: int, device):
    """Local coords u (x, y, z order) of every voxel center, array axes
    (z, x, y): shape [V, V, V, 3]."""
    ax = torch.arange(size, dtype=torch.float32, device=device) \
        / h2d(size - 1, device, torch.float32)
    uz, ux, uy = torch.meshgrid(ax, ax, ax, indexing="ij")
    return torch.stack([ux, uy, uz], dim=-1)


def _radius2(u):
    """Squared radius from the volume center, 1 at the inscribed sphere
    (the three squares summed in the reference's order)."""
    d = (u - 0.5) * 2.0
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
        + d[..., 2] * d[..., 2]


def _volume_offsets(ids, seed: int):
    """Deterministic world offset per bank entry: ids [k] int -> [k, 3]."""
    idx = ids.to(torch.int32).long()
    off = torch.stack(
        [_u2f(_hash_base(idx, idx * 7 + c, idx * 13 + 2 * c, seed + 101))
         for c in range(3)], dim=-1)
    return off * 64.0


def _shape_density(n, r2, cutoff: float, edge: float = 0.9):
    """fBm in [-1, 1] -> carved density in [0, 1]; ``r2`` = _radius2."""
    d = torch.clamp(0.5 + 0.5 * n - (cutoff + edge * r2), min=0.0) \
        / h2d(max(1.0 - cutoff, 1e-3), n.device, torch.float32)
    return torch.clamp(d, max=1.0)


def _bake(bank_size: int, size: int, seed: int, noise_of, noise_scale,
          cutoff, edge, dtype, device, ids=None):
    """The chunked bake both banks share: ``noise_of(xyz [k, V, V, V, 3],
    ids [k])`` -> fBm [k, V, V, V]; entries ``ids`` (default: all)."""
    u = _lattice(size, device)
    r2 = _radius2(u)
    all_ids = torch.arange(bank_size, device=device) if ids is None \
        else torch.as_tensor(ids, device=device).to(torch.int64)
    n = all_ids.shape[0]
    out = torch.empty((n, size, size, size), dtype=dtype, device=device)
    chunk = max(1, _CHUNK_VOXELS // size ** 3)
    for c0 in range(0, n, chunk):
        ids = all_ids[c0:c0 + chunk]
        off = _volume_offsets(ids, seed)                    # [k, 3]
        xyz = ((u - 0.5) * noise_scale)[None] + off[:, None, None, None]
        out[c0:c0 + ids.shape[0]] = _shape_density(
            noise_of(xyz, ids), r2[None], cutoff, edge).to(dtype)
    return out


def bake_bank(bank_size: int, size: int, seed: int, *, octaves: int = 4,
              noise_scale: float = 4.0, cutoff: float = 0.3,
              edge: float = 0.9, dtype=torch.bfloat16, device=None):
    """Bake a static volume bank [bank_size, V, V, V] on ``device``
    (None: the card; raises without one)."""
    return _bake(bank_size, size, seed,
                 lambda xyz, ids: fbm3(xyz, seed, octaves=octaves),
                 noise_scale, cutoff, edge, dtype, resolve_device(device))


def bake_bank_4d(bank_size: int, size: int, seed: int, t, *,
                 octaves: int = 3, noise_scale: float = 4.0,
                 time_scale: float = 0.5, cutoff: float = 0.3,
                 edge: float = 0.9, dtype=torch.bfloat16, device=None,
                 ids=None):
    """Bake a time-animated bank from 4-D noise at simulation time ``t``
    (a float or a 0-d tensor, used as fp32).  Entry ``e`` samples the
    time coordinate ``t * time_scale + u2f(hash(e, 3e+1, 5e+2,
    seed+202)) * 16``, so the entries drift out of phase.  ``ids``
    (default: every entry) selects which global entries to bake, so the
    sharded frame can split the bake over ranks.  On ``device`` (None:
    the card; raises without one)."""
    device = resolve_device(device)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)

    def noise_of(xyz, ids):
        eid = ids.to(torch.int32).long()
        w = t * time_scale + _u2f(
            _hash_base(eid, eid * 3 + 1, eid * 5 + 2, seed + 202)) * 16.0
        w = w[:, None, None, None, None].expand(*xyz.shape[:-1], 1)
        return fbm4(torch.cat([xyz, w], dim=-1), seed, octaves=octaves)

    return _bake(bank_size, size, seed, noise_of, noise_scale, cutoff, edge,
                 dtype, device, ids)
