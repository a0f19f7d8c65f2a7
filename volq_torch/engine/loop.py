"""The frame loop (mirror of ``volq/engine/loop.py``).

``frame`` is one sim step + one render; ``frames`` runs ``n`` of them in
a Python loop (bit-identical to repeated ``frame``; CUDA-graph capture
of the loop waits for a later slice).  An animated scene
(``volume.animated``) re-bakes its volume bank from the simulation time
after every sim step, and with it the light bank and the slab banks.
Everything stays on the state's device; the image leaves it only when
the caller fetches it.  ``time_frames(mesh=N)`` times the sharded frame
(``dist/``) on N ranks instead, and ``run_sharded`` runs it on a mesh
and brings back rank 0's images and the whole state.
"""
from __future__ import annotations

import time

import torch

from volq_torch.core import trace
from volq_torch.core.device import resolve_device
from volq_torch.core.types import SceneState
from volq_torch.render import render_frame
from volq_torch.render.warp import bake_slab_banks
from volq_torch.scene.config import SceneConfig
from volq_torch.scene.state import (init_scene, build_camera, build_light,
                                    bake_volumes)
from volq_torch.sim.step import sim_step
from volq_torch.volume.lightbake import render_light_volumes


def _light_volumes(state: SceneState, light, cfg: SceneConfig):
    """The baked light optical depth of the state's volumes for the lit
    modes (``light_steps > 0``), else None."""
    return render_light_volumes(state.volumes, light, cfg)


def _frame_body(state: SceneState, camera, light, cfg: SceneConfig,
                light_volumes=None, slab_banks=None):
    with trace.span("volq.frame"):
        trace.count("frames")
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
    skips all three (and ``device``): nothing is baked again.  ``mesh``
    > 0 runs the sharded frame (``dist/``) on that many ranks of
    ``device`` (None: one per CUDA card, over NCCL; "cpu": gloo
    processes), ``fb`` frames a call, timed on rank 0."""
    if mesh:
        if prepared is not None:
            raise ValueError("prepared is for the unsharded loop; the "
                             "ranks of a mesh set up their own scene")
        from volq_torch.dist import check_mesh, launch, make_mesh
        m = make_mesh(mesh, device)
        check_mesh(cfg, m.size)
        spf, last, times = launch(m, _time_rank, cfg, n_frames, warmup, fb,
                                  windows)
        if window_times is not None:
            window_times.extend(times)
        return spf, last
    if prepared is None:
        state, camera, light = setup(cfg, device)
        lv = cached_light_volumes(state, light, cfg)
        sb = cached_slab_banks(state, lv, cfg)
    else:
        state, camera, light, lv, sb = prepared
    return time_loop(lambda st: frames(st, camera, light, cfg, lv, sb, n=fb),
                     state, n_frames, fb, warmup, windows, window_times)


def time_loop(step, state, n_frames: int, fb: int, warmup: int,
              windows: int, window_times: list | None = None):
    """Time ``step(state) -> (state, image, stats)``, which advances
    ``fb`` frames: 1 + ``warmup`` calls, then ``windows`` windows of
    ceil(n_frames / fb) calls, each fenced by CUDA events on the state's
    card (on the CPU, by the host clock).  Returns (the median window's
    seconds per frame, host stats of the last frame)."""
    cuda = state.volumes.device.type == "cuda"
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
    last = {k: int(v.reshape(-1)[-1]) for k, v in stats.items()}
    return sorted(dts)[len(dts) // 2], last


def _time_rank(rank, mesh, device, cfg, n_frames, warmup, fb, windows):
    from volq_torch.dist import shard_state, sharded_frame_fn
    state, camera, light = setup(cfg, device)
    state = shard_state(state, mesh, rank)
    fr = sharded_frame_fn(cfg, mesh, n_frames_per_call=fb)
    times = []
    spf, last = time_loop(lambda st: fr(st, camera, light), state,
                          n_frames, fb, warmup, windows, times)
    return spf, last, times


# the kernel wrappers whose launches a rank of run_sharded reports
_KERNELS = ("warp_march", "warp_composite", "warp_images", "composite_chunk")


def _turns(whole, shard, camera, light, cfg, mesh, n_frames, fb, warmup,
           turns):
    """This rank's unsharded loop (on the whole state) and sharded loop
    (on its shard) of ``cfg`` timed in turns, ``turns`` windows each:
    {"unsharded": [...], "sharded": [...]} seconds per frame."""
    from volq_torch.dist import sharded_frame_fn
    lv = cached_light_volumes(whole, light, cfg)
    sb = cached_slab_banks(whole, lv, cfg)
    fr = sharded_frame_fn(cfg, mesh, n_frames_per_call=fb)
    loops = {"unsharded": (lambda st: frames(st, camera, light, cfg, lv, sb,
                                             n=fb), whole),
             "sharded": (lambda st: fr(st, camera, light), shard)}
    times = {k: [] for k in loops}
    for _ in range(turns):
        for k, (step, st) in loops.items():
            time_loop(step, st, n_frames, fb, warmup, 1, times[k])
    return times


def _run_rank(rank, mesh, device, jobs, timing):
    from volq_torch.convert import state_to_numpy
    from volq_torch.dist import gather_state, shard_state, sharded_frame_fn
    from volq_torch.render import kernel as K
    records = []
    for cfg, n_frames, per_call in jobs:
        whole, camera, light = setup(cfg, device)
        state = shard = shard_state(whole, mesh, rank)
        wire = {}

        def on_send(payload):
            key = str(payload.dtype)
            wire[key] = wire.get(key, 0) \
                + payload.numel() * payload.element_size()

        fr = sharded_frame_fn(cfg, mesh, per_call, on_send=on_send)
        for fn in _KERNELS:
            getattr(K, fn).launches = 0
        for _ in range(n_frames // per_call):
            state, image, stats = fr(state, camera, light)
        launches = {fn: getattr(K, fn).launches for fn in _KERNELS}
        state = gather_state(state)
        rec = dict(launches=launches, wire=wire)
        if timing is not None:
            rec["times"] = _turns(whole, shard, camera, light, cfg, mesh,
                                  *timing)
        if rank == 0:
            records.append(dict(
                rec, state=state_to_numpy(state), image=image.cpu().numpy(),
                stats={k: int(v) for k, v in stats.items()}))
    return records


def run_sharded(mesh, jobs, timing=None) -> list:
    """For each job (cfg, n_frames, n_frames_per_call) in turn, set
    ``cfg`` up on every rank of ``mesh`` (``dist.make_mesh``) and
    advance ``n_frames`` sharded frames, ``n_frames_per_call`` a call
    (it must divide ``n_frames``).  One set of rank processes runs every
    job.  Returns rank 0's record of each job: ``state`` (the whole
    final state, numpy), ``image`` (the last frame, numpy), ``stats``,
    ``launches`` (rank 0's kernel launches over the frames) and ``wire``
    (the bytes rank 0 handed to the binary swap's wire, by dtype).
    ``timing`` = (n_frames, fb, warmup, turns) then times, on each
    rank, the unsharded loop of the job's initial state and the sharded
    loop of its shard in turns (``time_loop``, one window a turn): the
    record's ``times``, rank 0's seconds per frame of each window."""
    from volq_torch.dist import check_mesh, launch
    for cfg, n_frames, per_call in jobs:
        check_mesh(cfg, mesh.size)
        if n_frames % per_call:
            raise ValueError("n_frames_per_call must divide n_frames")
    return launch(mesh, _run_rank, list(jobs), timing)
