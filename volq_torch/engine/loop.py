"""The frame loop (mirror of ``volq/engine/loop.py``).

``frame`` is one sim step + one render; ``frames`` runs ``n`` of them in
a Python loop (bit-identical to repeated ``frame``; CUDA-graph capture
of the loop waits for a later slice).  An animated scene
(``volume.animated``) re-bakes its volume bank from the simulation time
after every sim step, and with it the light bank and the slab banks.
Everything stays on the state's device; the image leaves it only when
the caller fetches it.
"""
from __future__ import annotations

import time

import torch

from volq_torch.core.device import resolve_device
from volq_torch.core.types import SceneState
from volq_torch.render import render_frame
from volq_torch.render.warp import bake_slab_banks, check_supported
from volq_torch.scene.config import SceneConfig
from volq_torch.scene.state import (init_scene, build_camera, build_light,
                                    bake_volumes)
from volq_torch.sim.step import sim_step
from volq_torch.volume.lightbake import bake_light_volumes, dominant_axis


def _light_volumes(state: SceneState, light, cfg: SceneConfig):
    """The baked light optical depth of the state's volumes for the lit
    modes (``light_steps > 0``), else None."""
    if cfg.render.engine in ("slab", "warp") and cfg.render.light_steps > 0:
        return bake_light_volumes(state.volumes, light.direction,
                                  axis=dominant_axis(cfg.light.direction))
    return None


def _frame_body(state: SceneState, camera, light, cfg: SceneConfig,
                light_volumes=None, slab_banks=None):
    state = sim_step(state, cfg)
    if cfg.volume.animated:
        state = state._replace(volumes=bake_volumes(
            cfg, state.volumes.device, state.time))
        light_volumes = slab_banks = None   # stale: the volumes changed
    if light_volumes is None:
        light_volumes = _light_volumes(state, light, cfg)
    image, stats = render_frame(state.particles, state.volumes, camera,
                                light, cfg, light_volumes=light_volumes,
                                slab_banks=slab_banks)
    return state, image, stats


def frame(state: SceneState, camera, light, cfg: SceneConfig,
          light_volumes=None, slab_banks=None):
    """Advance one frame.  Returns (new_state, image [H, W, 4], stats).
    Pass ``light_volumes`` from ``cached_light_volumes`` and
    ``slab_banks`` from ``cached_slab_banks`` to skip the per-frame bakes
    (static scenes); None re-bakes inside the frame, as animated scenes
    always do."""
    return _frame_body(state, camera, light, cfg, light_volumes, slab_banks)


def frames(state: SceneState, camera, light, cfg: SceneConfig,
           light_volumes=None, slab_banks=None, n: int = 1):
    """Advance ``n`` frames.  Returns (new_state, last image, stats with
    each value stacked over the frames [n])."""
    if n < 1:
        raise ValueError("frames needs n >= 1")
    per = []
    for _ in range(n):
        state, image, stats = _frame_body(state, camera, light, cfg,
                                          light_volumes, slab_banks)
        per.append(stats)
    return state, image, {k: torch.stack([s[k] for s in per])
                          for k in per[0]}


def cached_light_volumes(state: SceneState, light, cfg: SceneConfig):
    """Bake the light optical-depth bank once for a static scene (the
    volumes and the light direction never change between frames), or
    None when no bake is needed or (animated volumes) every frame must
    bake its own."""
    if cfg.volume.animated:
        return None
    return _light_volumes(state, light, cfg)


def cached_slab_banks(state: SceneState, light_volumes, cfg: SceneConfig):
    """Bake the warp engine's marching slab banks once for a static
    scene (they change only with the volumes): (density, light or None
    when ``light_volumes`` is None or the scene is unlit).  None for
    animated volumes (the frame bakes them after its own re-bake), for
    the warp engine's XLA path (``warp_pallas=False``: it streams the
    volumes, and so does its animated re-bake) and for the other
    engines."""
    if cfg.volume.animated or cfg.render.engine != "warp":
        return None
    return bake_slab_banks(state.volumes, light_volumes, cfg)


def render_only(state: SceneState, camera, light, cfg: SceneConfig):
    """Render the current state without stepping.  Returns (image,
    stats)."""
    return render_frame(state.particles, state.volumes, camera, light, cfg,
                        light_volumes=_light_volumes(state, light, cfg))


def setup(cfg: SceneConfig, device=None):
    """Config -> (state, camera, light) on ``device`` (the CUDA card when
    None; raises when there is none).  Bakes the volume bank."""
    device = resolve_device(device)
    check_supported(cfg)
    camera = build_camera(cfg.camera, cfg.render.width, cfg.render.height,
                          device)
    light = build_light(cfg.light, device)
    state = init_scene(cfg, device)
    return state, camera, light


def run(cfg: SceneConfig, n_frames: int, *, warmup: int = 0,
        fetch_images: bool = True, on_frame=None, device=None):
    """Run the loop for n_frames (after ``warmup`` un-rendered sim
    steps).  Returns (final_state, list of host images or None, list of
    host stats dicts)."""
    state, camera, light = setup(cfg, device)
    for _ in range(warmup):
        state = sim_step(state, cfg)
    lv = cached_light_volumes(state, light, cfg)
    sb = cached_slab_banks(state, lv, cfg)
    images, all_stats = [], []
    for i in range(n_frames):
        state, image, stats = frame(state, camera, light, cfg, lv, sb)
        if fetch_images:
            images.append(image.cpu().numpy())
        host_stats = {k: int(v) for k, v in stats.items()}
        all_stats.append(host_stats)
        if on_frame is not None:
            on_frame(i, image, host_stats)
    return state, images if fetch_images else None, all_stats


def time_frames(cfg: SceneConfig, n_frames: int, *, warmup: int = 2,
                fb: int = 48, mesh: int = 0, windows: int = 3,
                window_times: list | None = None, device=None,
                prepared=None):
    """Steady-state seconds per frame on the card: ``fb`` frames per
    ``frames`` call, windows of ceil(n_frames / fb) calls fenced by CUDA
    events (on the CPU, by the host clock), the median window returned.
    Returns (seconds_per_frame, host stats of the last frame);
    ``window_times`` receives each window's seconds per frame.
    ``prepared`` = (state, camera, light, light_volumes, slab_banks)
    from ``setup``, ``cached_light_volumes`` and ``cached_slab_banks``
    skips all three (and ``device``): nothing is baked again."""
    if mesh:
        raise NotImplementedError("the sharded loop is not ported yet "
                                  "(ROADMAP Queue 1 item 12)")
    if prepared is None:
        state, camera, light = setup(cfg, device)
        lv = cached_light_volumes(state, light, cfg)
        sb = cached_slab_banks(state, lv, cfg)
    else:
        check_supported(cfg)
        state, camera, light, lv, sb = prepared
    cuda = state.volumes.device.type == "cuda"

    def step(st):
        return frames(st, camera, light, cfg, lv, sb, n=fb)

    for _ in range(1 + warmup):
        state, image, stats = step(state)
    reps = max(-(-n_frames // fb), 1)
    dts = []
    for _ in range(max(windows, 1)):
        if cuda:
            torch.cuda.synchronize()
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            state, image, stats = step(state)
        if cuda:
            ev1.record()
            ev1.synchronize()
            dt = ev0.elapsed_time(ev1) / 1e3
        else:
            dt = time.perf_counter() - t0
        dts.append(dt / (reps * fb))
    if window_times is not None:
        window_times.extend(dts)
    last = {k: int(v[-1]) for k, v in stats.items()}
    return sorted(dts)[len(dts) // 2], last
