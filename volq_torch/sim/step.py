"""The simulation step (mirror of ``volq/sim/step.py``, single device).

Step order of record:
  1. key       = fold_in(base_key, frame)
  2. age'      = age + dt
  3. dead      = age' >= lifetime
  4. emission  = first floor(carry + rate*dt) dead slots revived with
                 fresh attributes at age 0 (no advection on birth frame)
  5. advection = v += f(p, v, t) * dt ; p += v * dt  (alive, not spawned)
  6. frame += 1 ; time += dt
(The particle-sharded step waits for the dist/ port.)
"""
from __future__ import annotations

import numpy as np
import torch

from volq_torch.core.types import Particles, SceneState
from volq_torch.scene.config import SceneConfig
from volq_torch.sim import prng
from volq_torch.sim.emit import spawn_attrs, emission_step
from volq_torch.sim.forces import total_force


def sim_step(state: SceneState, cfg: SceneConfig) -> SceneState:
    p = state.particles
    n = p.age.shape[0]
    dev = p.age.device
    dt = torch.tensor(np.float32(cfg.dt), device=dev)
    key = prng.fold_in(state.base_key, state.frame)

    age = p.age + dt
    dead = age >= p.lifetime
    spawn_mask, new_carry = emission_step(dead, state.spawn_carry,
                                          cfg.emitter.rate, dt)
    slot_ids = torch.arange(n, dtype=torch.int32, device=dev)
    fresh = spawn_attrs(key, slot_ids, cfg.emitter, cfg.volume.bank_size)

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
