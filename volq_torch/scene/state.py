"""Scene construction (mirror of ``volq/scene/state.py``): config ->
initial SceneState + numeric camera/light, on an explicit device."""
from __future__ import annotations

import numpy as np
import torch

from volq_torch.core.camera import make_camera, to_device
from volq_torch.core.device import resolve_device
from volq_torch.core.types import Particles, SceneState, Camera, Light
from volq_torch.scene.config import SceneConfig, LightConfig, CameraConfig
from volq_torch.sim import prng
from volq_torch.sim.emit import spawn_attrs
from volq_torch.volume.bake import bake_bank, bake_bank_4d


def build_camera(ccfg: CameraConfig, width: int, height: int,
                 device=None) -> Camera:
    """The config's camera on ``device`` (None: the card; raises without
    one)."""
    return to_device(make_camera(ccfg.eye, ccfg.look_at, ccfg.up,
                                 fov_y_deg=ccfg.fov_y_deg,
                                 aspect=width / height,
                                 ortho_half_h=ccfg.ortho_half_h,
                                 projection=ccfg.projection),
                     resolve_device(device))


def build_light(lcfg: LightConfig, device=None) -> Light:
    """The config's light on ``device`` (None: the card)."""
    d = np.asarray(lcfg.direction, np.float32)
    d = d / np.linalg.norm(d)
    return to_device(Light(direction=d,
                           color=np.asarray(lcfg.color, np.float32),
                           ambient=np.asarray(lcfg.ambient, np.float32)),
                     resolve_device(device))


def bake_volumes(cfg: SceneConfig, device=None, t=0.0):
    """The scene's volume bank: static, or (``volume.animated``) the 4-D
    bank at simulation time ``t``; on ``device`` (None: the card)."""
    device = resolve_device(device)
    v = cfg.volume
    if v.animated:
        return bake_bank_4d(v.bank_size, v.size, v.seed, t,
                            octaves=v.octaves, noise_scale=v.noise_scale,
                            time_scale=v.time_scale, cutoff=v.cutoff,
                            edge=v.edge, device=device)
    return bake_bank(v.bank_size, v.size, v.seed, octaves=v.octaves,
                     noise_scale=v.noise_scale, cutoff=v.cutoff,
                     edge=v.edge, device=device)


def _init_particles(cfg: SceneConfig, key) -> Particles:
    n = cfg.n_particles
    e = cfg.emitter
    dev = key.device
    f32 = dict(dtype=torch.float32, device=dev)
    zeros3 = torch.zeros((n, 3), **f32)
    zeros = torch.zeros((n,), **f32)

    if cfg.init == "empty":
        # all dead (age >= lifetime); emission fills the pool
        return Particles(pos=zeros3, vel=zeros3.clone(), age=zeros,
                         lifetime=zeros.clone(), size=zeros + e.size_min,
                         albedo=torch.ones((n, 3), **f32),
                         vol_idx=torch.zeros((n,), dtype=torch.int32,
                                             device=dev))

    if cfg.init == "single":
        life = torch.full((n,), e.life_max, **f32)
        return Particles(
            pos=torch.tensor(e.center, **f32).expand(n, 3).clone(),
            vel=zeros3, age=0.5 * life, lifetime=life,
            size=torch.full((n,), e.size_max, **f32),
            albedo=torch.tensor(e.albedo_base, **f32).expand(n, 3).clone(),
            vol_idx=torch.zeros((n,), dtype=torch.int32, device=dev))

    ka, kj, kf = prng.split(key, 3)
    fresh = spawn_attrs(ka, torch.arange(n, dtype=torch.int32, device=dev),
                        e, cfg.volume.bank_size)
    lo, hi = cfg.init_age_frac
    age = fresh["lifetime"] * prng.uniform(kf, (n,), lo, hi)

    pos = fresh["pos"]
    if cfg.init == "grid":
        k = int(np.ceil(n ** (1.0 / 3.0)))
        idx = torch.arange(n, device=dev)
        gx, gy, gz = idx // (k * k), (idx // k) % k, idx % k
        g = (torch.stack([gx, gy, gz], -1).to(torch.float32)
             - (k - 1) / 2.0) / torch.tensor(max(k - 1, 1), **f32) * 2.0
        jitter = 0.15 * e.radius * prng.normal(kj, (n, 3))
        pos = torch.tensor(e.center, **f32) + g * e.radius + jitter
    elif cfg.init != "random":
        raise ValueError(f"unknown init mode {cfg.init!r}")

    return Particles(pos=pos, vel=fresh["vel"], age=age,
                     lifetime=fresh["lifetime"], size=fresh["size"],
                     albedo=fresh["albedo"], vol_idx=fresh["vol_idx"])


def init_scene(cfg: SceneConfig, device=None) -> SceneState:
    """The initial scene state on ``device`` (None: the card; raises
    without one)."""
    device = resolve_device(device)
    base_key = prng.PRNGKey(cfg.seed, device)
    init_key = prng.fold_in(base_key, 0x5EED)
    f32 = dict(dtype=torch.float32, device=device)
    return SceneState(
        particles=_init_particles(cfg, init_key),
        volumes=bake_volumes(cfg, device),
        frame=torch.zeros((), dtype=torch.int32, device=device),
        spawn_carry=torch.zeros((), **f32),
        time=torch.zeros((), **f32),
        base_key=base_key,
    )
