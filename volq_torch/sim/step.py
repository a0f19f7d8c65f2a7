"""The simulation step (mirror of ``volq/sim/step.py``).

Step order of record:
  1. key       = fold_in(base_key, frame)
  2. age'      = age + dt
  3. dead      = age' >= lifetime
  4. emission  = first floor(carry + rate*dt) dead slots revived with
                 fresh attributes at age 0 (no advection on birth frame)
  5. advection = v += f(p, v, t) * dt ; p += v * dt  (alive, not spawned)
  6. frame += 1 ; time += dt

With a process ``group`` the particle slots are sharded over its ranks
(``dist/sharded.py``): the emission rank is made global with an
exclusive prefix sum of the ranks' dead counts, and the slot ids (the
per-slot PRNG keys) are offset by ``rank * n_local``, so every attribute
equals the single-device step's.
"""
from __future__ import annotations

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


def sim_step(state: SceneState, cfg: SceneConfig, group=None) -> SceneState:
    with trace.span("volq.sim"):
        p = state.particles
        n = p.age.shape[0]
        dev = p.age.device
        dt = h2d(np.float32(cfg.dt), dev)
        key = prng.fold_in(state.base_key, state.frame)

        age = p.age + dt
        dead = age >= p.lifetime
        with trace.span("volq.sim.emit"):
            slot_offset = rank_offset = 0
            if group is not None:
                rank = dist.get_rank(group)
                slot_offset = rank * n
                counts = [torch.zeros((), dtype=torch.int64, device=dev)
                          for _ in range(dist.get_world_size(group))]
                dist.all_gather(counts, dead.sum(), group=group)
                rank_offset = torch.stack(counts[:rank]).sum() if rank else 0
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
