"""Density-volume baking (mirror of ``volq/volume/bake.py``): static
banks from 3-D noise and the time-animated bank of 4-D noise, which the
frame loop re-bakes from the simulation time every frame.

fBm noise over a voxel lattice, carved by a radial falloff into a puff
that reaches zero before the AABB faces.  A bank is [M, V, V, V] with
array axes (entry, z, x, y), stored bf16.

A bank on the card is baked by one CUDA kernel (``noise_bake``,
``csrc/noise_bake.cu``) that computes every voxel of every entry in
registers, bit-equal to the plain version; it stores bf16, and a bank of
another dtype on the card is refused.  A bank on the CPU takes the plain
version (``_bake_plain``): torch ops over the lattice, entries baked in
chunks so peak memory stays bounded (the reference maps over entries
with ``lax.map``); its result is independent of the chunk size.  The
kernel's launch counts as ``noise_bake_launch`` (``_build.launch``) and,
under the program's tracing, each plain bake as ``noise_torch``.
"""
from __future__ import annotations

import ctypes

import torch

from volq_torch import _build
from volq_torch._build import check_tensor, ptr, stream
from volq_torch.core import trace
from volq_torch.core.device import h2d, resolve_device

from volq_torch.volume.noise import (fbm3, fbm4, _hash_base, _octaves,
                                     _seed_word, _u2f)

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


def _bake_plain(bank_size: int, size: int, seed: int, noise_of,
                noise_scale, cutoff, edge, dtype, device, ids=None):
    """The chunked bake both banks share, the kernel's plain version:
    ``noise_of(xyz [k, V, V, V, 3], ids [k])`` -> fBm [k, V, V, V];
    entries ``ids`` (default: all).  Counts ``noise_torch``."""
    trace.count("noise_torch")
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


def _noise_3d(seed: int, octaves: int):
    """``_bake_plain``'s ``noise_of`` for the static bank."""
    return lambda xyz, ids: fbm3(xyz, seed, octaves=octaves)


def _noise_4d(t, seed: int, octaves: int, time_scale):
    """``_bake_plain``'s ``noise_of`` for the animated bank at time ``t``
    (0-d fp32)."""
    def noise_of(xyz, ids):
        eid = ids.to(torch.int32).long()
        w = t * time_scale + _u2f(
            _hash_base(eid, eid * 3 + 1, eid * 5 + 2, seed + 202)) * 16.0
        w = w[:, None, None, None, None].expand(*xyz.shape[:-1], 1)
        return fbm4(torch.cat([xyz, w], dim=-1), seed, octaves=octaves)
    return noise_of


# the kernel's octave limit (csrc/noise_bake.cu's kMaxOctaves)
_MAX_OCTAVES = 16


class NoiseParams(ctypes.Structure):
    """``noise_bake``'s scalars (``csrc/noise_bake.cu``'s NoiseParams): the
    plain version's Python floats as the fp32 values torch rounds them
    to, and its seed words."""
    _fields_ = [("n", ctypes.c_int), ("size", ctypes.c_int),
                ("octaves", ctypes.c_int), ("denom", ctypes.c_float),
                ("noise_scale", ctypes.c_float),
                ("time_scale", ctypes.c_float), ("norm", ctypes.c_float),
                ("cutoff", ctypes.c_float), ("edge", ctypes.c_float),
                ("span", ctypes.c_float), ("off_seed", ctypes.c_uint32),
                ("time_seed", ctypes.c_uint32),
                ("seed", ctypes.c_uint32 * _MAX_OCTAVES),
                ("amp", ctypes.c_float * _MAX_OCTAVES),
                ("freq", ctypes.c_float * _MAX_OCTAVES)]


def noise_params(n: int, size: int, seed: int, octaves: int, noise_scale,
                 cutoff, edge, time_scale=0.0) -> NoiseParams:
    """The kernel's parameters for ``n`` entries of a bank of V = ``size``
    (the arguments of ``bake_bank`` / ``bake_bank_4d``)."""
    if not 0 <= octaves <= _MAX_OCTAVES:
        raise ValueError(f"noise_bake takes 0 to {_MAX_OCTAVES} octaves, "
                         f"not {octaves}")
    amps, freqs, norm = _octaves(octaves)
    words = [_seed_word(seed + o) for o in range(octaves)]
    return NoiseParams(
        n=n, size=size, octaves=octaves, denom=size - 1,
        noise_scale=noise_scale, time_scale=time_scale, norm=norm,
        cutoff=cutoff, edge=edge, span=max(1.0 - cutoff, 1e-3),
        off_seed=_seed_word(seed + 101), time_seed=_seed_word(seed + 202),
        seed=(ctypes.c_uint32 * _MAX_OCTAVES)(*words),
        amp=(ctypes.c_float * _MAX_OCTAVES)(*amps),
        freq=(ctypes.c_float * _MAX_OCTAVES)(*freqs))


_NOISE_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int, NoiseParams,
                                       ctypes.c_void_p]


def noise_bake(p: NoiseParams, device, ids=None, t=None):
    """Kernel: ``p.n`` entries of a bank [p.n, V, V, V] bf16 on the card
    ``device``, bit-equal to ``_bake_plain``'s.  ``ids``: None (entries 0
    to p.n - 1) or the entries' global ids, [p.n] int64 on the card;
    ``t``: None for the static bank of 3-D noise, or the animated bank's
    simulation time, a 0-d fp32 tensor on the card (read there, not
    copied).  Raises, before anything is built or loaded, on a tensor it
    does not take or off a card."""
    for name, x, dt, shape in (("ids", ids, torch.int64, (p.n,)),
                               ("t", t, torch.float32, ())):
        if x is not None:
            check_tensor(x, name, (dt,), shape)
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"noise_bake runs on a CUDA device, not {device} "
                         "(the CPU takes _bake_plain)")
    out = torch.empty((p.n, p.size, p.size, p.size), dtype=torch.bfloat16,
                      device=device)
    for name, x in (("ids", ids), ("t", t)):
        if x is not None and x.device != out.device:
            raise ValueError(f"noise_bake: {name} on {x.device}, not on "
                             f"the bank's {out.device}")
    _build.launch("noise_bake", "noise_bake_launch", _NOISE_ARGS, ptr(out),
                  ptr(ids), ptr(t), 3 if t is None else 4, p,
                  stream(out.device))
    return out


def _on_card(device, dtype) -> bool:
    """Whether ``noise_bake`` bakes this bank: any bank on a card, which
    must be bf16 (the kernel's store); the CPU takes ``_bake_plain``."""
    if device.type != "cuda":
        return False
    if dtype != torch.bfloat16:
        raise ValueError(f"a noise bank on the card is bf16 (noise_bake's "
                         f"store), not {dtype}")
    return True


def bake_bank(bank_size: int, size: int, seed: int, *, octaves: int = 4,
              noise_scale: float = 4.0, cutoff: float = 0.3,
              edge: float = 0.9, dtype=torch.bfloat16, device=None):
    """Bake a static volume bank [bank_size, V, V, V] on ``device``
    (None: the card; raises without one, and on the card for a ``dtype``
    other than bf16)."""
    device = resolve_device(device)
    if _on_card(device, dtype):
        return noise_bake(noise_params(bank_size, size, seed, octaves,
                                       noise_scale, cutoff, edge), device)
    return _bake_plain(bank_size, size, seed, _noise_3d(seed, octaves),
                       noise_scale, cutoff, edge, dtype, device)


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
    the card; raises without one, and on the card for a ``dtype`` other
    than bf16)."""
    device = resolve_device(device)
    on_card = _on_card(device, dtype)
    t = torch.as_tensor(t, dtype=torch.float32, device=device)
    if on_card:
        if ids is not None:
            ids = torch.as_tensor(ids, device=device).to(torch.int64) \
                .contiguous()
        n = bank_size if ids is None else ids.shape[0]
        return noise_bake(noise_params(n, size, seed, octaves, noise_scale,
                                       cutoff, edge, time_scale), device,
                          ids, t)
    return _bake_plain(bank_size, size, seed,
                       _noise_4d(t, seed, octaves, time_scale), noise_scale,
                       cutoff, edge, dtype, device, ids)
