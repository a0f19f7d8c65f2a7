"""The benchmark's plain reference of volq's frame loop.

``replay`` works a cell's state out again from its configuration alone:
the initial particles and every sim step (``sim.py``), the volume banks
(``volumes.py``) and the warp render of chosen pixel rows (``warp.py``).
It imports nothing of the program and nothing of the JAX package, and it
takes nothing the program made: the caller hands it the configuration
and the number of frames the program ran.

``cfg`` is the scene configuration as nested attributes (``as_config``
of the configuration's JSON dict).
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import torch

from . import sim, volumes, warp


def as_config(d):
    """JSON dict of a scene configuration -> nested attributes."""
    return json.loads(json.dumps(d), object_hook=lambda o: SimpleNamespace(
        **{k: tuple(v) if isinstance(v, list) else v for k, v in o.items()}))


def replay(cfg, n_frames, device, lowp=False, on_frame=None,
           force_device=None):
    """The sim state after ``n_frames`` steps from the configuration's
    seed, on ``device`` (the forces on ``force_device``).  ``on_frame(i,
    state)`` sees the state after step i (1-based)."""
    st = sim.init_state(cfg, device)
    for i in range(1, n_frames + 1):
        st = sim.step(st, cfg, lowp, force_device)
        if on_frame is not None:
            on_frame(i, st)
    return st


def to_numpy(particles):
    return sim.Particles(*(a.detach().float().cpu().numpy()
                           if a.is_floating_point() else a.cpu().numpy()
                           for a in particles))


def banks(cfg, t, device, lowp=False):
    """The banks an animated frame at sim time ``t`` renders from: the
    4-D volume bank, the light bank (None when unlit) and the marching
    slab banks (density, light or None), as the configuration stores
    them (``lowp``: float8 banks, a bfloat16 light sweep)."""
    r = cfg.render
    store = torch.float8_e4m3fn if lowp else torch.bfloat16
    ids = torch.arange(cfg.volume.bank_size, device=device)
    vols = volumes.bake(cfg.volume, ids, t, store)
    lit = r.light_steps > 0
    light = None
    if lit:
        ld = torch.as_tensor(warp.light_dir(cfg.light), device=device)
        light = volumes.light_bake(vols, ld, cfg.light.direction, lowp)
    _, ap = warp.march_perm(cfg)
    ev = vols.permute(ap)
    V = ev.shape[-1]
    vx = warp.slab_vx(cfg, V)
    wdt = torch.float32 if r.warp_fp32 else store
    dens = volumes.slabs(ev, r.steps, vx, wdt)
    lsl = volumes.slabs(light.permute(ap), r.steps, vx, wdt) if lit else None
    return vols, light, (dens, lsl)


def render_rows(cfg, particles, rows, device, vols=None, light=None,
                lowp=False, workers=1):
    """Pixel rows of the frame of ``particles`` (numpy): {(y0, y1): image
    rows}.  ``vols`` / ``light``: the frame's banks (animated scenes);
    None bakes the static bank's entries the rows need, on ``device``."""
    r = cfg.render
    _, ap = warp.march_perm(cfg)
    store = torch.float8_e4m3fn if lowp else torch.bfloat16
    perm = tuple(a - 1 for a in ap[1:])

    def static(e):
        return volumes.bake(cfg.volume, torch.tensor([e], device=device),
                            None, store)

    def slabs(v):
        return warp.entry_slabs(v.permute(*perm).float().cpu().numpy(), cfg)

    def slabs_of(e):
        return slabs(vols[e] if vols is not None else static(e)[0])

    def lslabs_of(e):
        if light is not None:
            return slabs(light[e])
        ld = torch.as_tensor(warp.light_dir(cfg.light), device=device)
        return slabs(volumes.light_bake(static(e), ld, cfg.light.direction,
                                        lowp)[0])

    cam = warp.make_camera(cfg.camera, r.width / r.height)
    lc = SimpleNamespace(color=np.asarray(cfg.light.color, np.float32),
                         ambient=np.asarray(cfg.light.ambient, np.float32))
    return warp.render_rows(particles, slabs_of,
                            lslabs_of if r.light_steps > 0 else None, cam, lc,
                            cfg, rows, str(store).split(".")[-1], workers)
