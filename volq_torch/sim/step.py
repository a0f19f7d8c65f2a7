"""The simulation step (mirror of ``volq/sim/step.py``).

Step order of record:
  1. key       = fold_in(base_key, frame)
  2. age'      = age + dt
  3. dead      = age' >= lifetime
  4. emission  = first floor(carry + rate*dt) dead slots revived with
                 fresh attributes at age 0 (no advection on birth frame)
  5. advection = v += f(p, v, t) * dt ; p += v * dt  (alive, not spawned)
  6. frame += 1 ; time += dt

On a card the step is three launches of ``csrc/sim_step.cu``
(``sim/kernel.sim_step_kernel``), bit-equal to the plain version
``_sim_step_plain`` (torch ops), which the CPU takes.  Under the
program's tracing a plain step counts ``sim_torch`` and each launch its
C function's name (``sim_scan_launch``, ``sim_spawn_launch``,
``sim_forces_launch``).

With a process ``group`` the particle slots are sharded over its ranks
(``dist/sharded.py``): the emission rank is made global with an
exclusive prefix sum of the ranks' dead counts, and the slot ids (the
per-slot PRNG keys) are offset by ``rank * n_local``, so every attribute
equals the single-device step's.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from volq_torch.core import trace
from volq_torch.core.device import h2d
from volq_torch.core.types import Particles, SceneState
from volq_torch.scene.config import SceneConfig
from volq_torch.sim import prng
from volq_torch.sim.emit import spawn_attrs, emission_step
from volq_torch.sim.forces import total_force
from volq_torch.sim.kernel import sim_step_kernel


def sim_step(state: SceneState, cfg: SceneConfig, group=None) -> SceneState:
    offsets = None if group is None else functools.partial(_rank_offsets,
                                                           group)
    with trace.span("volq.sim"):
        if state.particles.age.device.type == "cuda":
            return sim_step_kernel(state, cfg, offsets)
        return _sim_step_plain(state, cfg, offsets)


def _rank_offsets(group, n: int, dead):
    """(slot_offset, rank_offset) of this rank of ``group``: its first
    global slot id, and the dead slots on the ranks before it (a 0-d
    int64 tensor, 0 on rank 0); ``dead`` is this rank's count, a 0-d
    int64 tensor."""
    rank = dist.get_rank(group)
    counts = [torch.zeros((), dtype=torch.int64, device=dead.device)
              for _ in range(dist.get_world_size(group))]
    dist.all_gather(counts, dead, group=group)
    return rank * n, torch.stack(counts[:rank]).sum() if rank else 0


def _sim_step_plain(state: SceneState, cfg: SceneConfig,
                    offsets=None) -> SceneState:
    """``sim_step`` in torch ops, on any device: the kernel's plain
    version.  ``offsets`` as ``sim_step_kernel`` takes it."""
    trace.count("sim_torch")
    p = state.particles
    n = p.age.shape[0]
    dev = p.age.device
    dt = h2d(np.float32(cfg.dt), dev)
    key = prng.fold_in(state.base_key, state.frame)

    age = p.age + dt
    dead = age >= p.lifetime
    with trace.span("volq.sim.emit"):
        slot_offset, rank_offset = (0, 0) if offsets is None \
            else offsets(n, dead.sum())
        spawn_mask, new_carry = emission_step(
            dead, state.spawn_carry, cfg.emitter.rate, dt, rank_offset)
        slot_ids = slot_offset + torch.arange(n, dtype=torch.int32,
                                              device=dev)
        fresh = spawn_attrs(key, slot_ids, cfg.emitter,
                            cfg.volume.bank_size)

        sm = spawn_mask
        sm3 = sm[:, None]
        pos = torch.where(sm3, fresh["pos"], p.pos)
        vel = torch.where(sm3, fresh["vel"], p.vel)
        age = torch.where(sm, torch.zeros_like(age), age)
        lifetime = torch.where(sm, fresh["lifetime"], p.lifetime)
        size = torch.where(sm, fresh["size"], p.size)
        albedo = torch.where(sm3, fresh["albedo"], p.albedo)
        vol_idx = torch.where(sm, fresh["vol_idx"], p.vol_idx)

    advect = (~dead) & (~sm)
    f = total_force(pos, vel, state.time, cfg.forces)
    vel_new = vel + f * dt
    pos_new = pos + vel_new * dt
    vel = torch.where(advect[:, None], vel_new, vel)
    pos = torch.where(advect[:, None], pos_new, pos)

    return SceneState(
        particles=Particles(pos=pos, vel=vel, age=age, lifetime=lifetime,
                            size=size, albedo=albedo, vol_idx=vol_idx),
        volumes=state.volumes,
        frame=state.frame + 1,
        spawn_carry=new_carry,
        time=state.time + dt,
        base_key=state.base_key,
    )
