"""Emission (mirror of ``volq/sim/emit.py``): deterministic ring-buffer
spawning with per-slot threefry keys fold_in(fold_in(base, frame), slot),
so every attribute is independent of array layout and replayable.
``spawn_attrs`` draws for all slots at once (the reference vmaps
``_spawn_one`` over slots; here the key batch is a leading dimension).
On a card the step draws in ``csrc/sim_step.cu`` (``sim/kernel.py``),
bit-equal to these.
"""
from __future__ import annotations

import torch

from volq_torch.core.device import h2d
from volq_torch.scene.config import EmitterConfig
from volq_torch.sim import prng


def _vec(v, like):
    return h2d(v, like.device, torch.float32)


# the floor of the spawn direction's norm and the radius draw's exponent
# (sim/kernel.py passes both to the kernel)
_NORM_EPS = 1e-6
_THIRD = 1.0 / 3.0


def spawn_attrs(key, slot_ids, ecfg: EmitterConfig, bank_size: int):
    """Fresh attributes for the given (global) slot ids: a dict of
    [len(slot_ids), ...] tensors, deterministic per (key, slot id)."""
    keys = prng.fold_in(key, slot_ids)                       # [n, 2]
    k = prng.split(keys, 7)                                  # [n, 7, 2]
    kp, kr, kv, kl, ks, ka, kb = (k[:, i] for i in range(7))
    d = prng.normal(kp, (3,))
    norm = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]
                      + d[:, 2] * d[:, 2])
    d = d / torch.clamp(norm, min=_NORM_EPS)[:, None]
    r = ecfg.radius * prng.uniform(kr) ** _THIRD
    pos = _vec(ecfg.center, keys) + d * r[:, None]
    vel = _vec(ecfg.vel_base, keys) + ecfg.vel_spread * prng.normal(kv, (3,))
    lifetime = prng.uniform(kl, (), ecfg.life_min, ecfg.life_max)
    size = prng.uniform(ks, (), ecfg.size_min, ecfg.size_max)
    albedo = _vec(ecfg.albedo_base, keys) \
        * (1.0 - ecfg.albedo_var * prng.uniform(ka, (3,)))
    vol_idx = prng.randint(kb, (), 0, bank_size)
    return dict(pos=pos, vel=vel, lifetime=lifetime, size=size,
                albedo=albedo, vol_idx=vol_idx)


def emission_step(dead_mask, spawn_carry, rate: float, dt, rank_offset=0):
    """Which local slots spawn this frame: the first floor(carry +
    rate*dt) dead slots in global slot order.  ``rank_offset`` is the
    number of dead slots on the ranks before this one (0 on one device),
    so a particle-sharded step spawns exactly the single-device slots.
    Returns (spawn_mask [N] bool, new_carry)."""
    budget = spawn_carry + rate * dt
    n_spawn = torch.floor(budget)
    new_carry = budget - n_spawn
    rank = rank_offset + torch.cumsum(dead_mask.to(torch.int32), 0) - 1
    spawn_mask = dead_mask & (rank.to(torch.float32) < n_spawn)
    return spawn_mask, new_carry
