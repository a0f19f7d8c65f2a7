"""Where a frame's time goes, on the card.

    python -m volq_torch.profile [--preset c1|c2|c3|c4|c5] [--unfused]
                                 [--perstep] [--frames 4]

Sets the preset up at full size (``--unfused``: with warp_fused=False;
``--perstep``: with light_mode="march"; both are the warp engine's), then
prints (with the card's name and power limit): the wall milliseconds per
frame of each phase, timed alone between device synchronizations -- the
sim step; for an animated preset the three bakes every frame holds (4-D
volume bank, light bank, slab banks); for the warp engine (c2-c5) the
render's host-side preparation (geometry, depth sort, kernel inputs),
each kernel (the unfused pair summed over the frame's megachunks), the
canvas init and finish; for the exact engine (c1) the binning, the pair
march and the composite -- and, from a torch.profiler trace of whole
frames, the device-busy share of the frame and the number of device
kernels launched per frame.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import time

import torch


def _wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def _warp_phases(state, camera, light, cfg, sb, fused):
    """The warp engine's render phases: name -> callable."""
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import (fused_inputs, unfused_inputs,
                                        _canvas_finish)
    H = cfg.render.height
    dev = state.volumes.device
    inputs = fused_inputs if fused else unfused_inputs

    def prep():
        return inputs(state.particles, camera, light, cfg, sb[0], 0, H,
                      sb[1])

    canvas = K.canvas_init(cfg, H, dev, fused=fused)
    if fused:
        march, comp, _ = prep()
        Pm, _ = K.warp_march(*march)
        kernels = {
            "warp_march kernel": lambda: K.warp_march(*march),
            "warp_composite kernel":
                lambda: K.warp_composite(canvas, Pm, *comp),
        }
    else:
        chunks, _ = prep()
        images = [K.warp_images(*a)[0] for a, _ in chunks]
        kernels = {
            f"warp_images kernel x{len(chunks)}":
                lambda: [K.warp_images(*a) for a, _ in chunks],
            f"composite_chunk kernel x{len(chunks)}":
                lambda: [K.composite_chunk(canvas, im, *c)
                         for im, (_, c) in zip(images, chunks)],
        }
    return {
        f"render host prep ({inputs.__name__})": prep,
        "canvas_init": lambda: K.canvas_init(cfg, H, dev, fused=fused),
        **kernels,
        "canvas finish": lambda: _canvas_finish(canvas[:3], canvas[3], cfg,
                                                H),
    }


def _exact_phases(state, camera, light, cfg, sb, fused):
    """The exact engine's render phases (plain tensor code, no kernel of
    the port's): name -> callable."""
    from volq_torch.render import exact
    from volq_torch.render.binning import bin_particles
    V = state.volumes.shape[-1]
    bank2d = state.volumes.reshape(state.volumes.shape[0], -1)
    pairs = bin_particles(state.particles, camera, cfg)
    C, T = exact._march_pairs(pairs, state.particles, bank2d, V, camera,
                              light, cfg)
    return {
        "bin_particles": lambda: bin_particles(state.particles, camera, cfg),
        f"march of {pairs.pid.shape[0]} pair slots x {cfg.render.steps} "
        "steps": lambda: exact._march_pairs(pairs, state.particles, bank2d,
                                            V, camera, light, cfg),
        "composite + assemble": lambda: exact.assemble_image(
            exact.composite_pairs(pairs, C, T, cfg), cfg),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="c3",
                    choices=["c1", "c2", "c3", "c4", "c5"])
    ap.add_argument("--unfused", action="store_true",
                    help="run the preset with warp_fused=False")
    ap.add_argument("--perstep", action="store_true",
                    help='run the preset with light_mode="march"')
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)

    from volq_torch.engine import loop
    from volq_torch.render.warp import bake_slab_banks
    from volq_torch.scene.config import PRESETS
    from volq_torch.scene.state import bake_volumes
    from volq_torch.sim import prng
    from volq_torch.sim.emit import spawn_attrs
    from volq_torch.sim.forces import total_force
    from volq_torch.sim.step import sim_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = PRESETS[args.preset]()
    fused = not args.unfused
    if not fused:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, warp_fused=False))
    if args.perstep:
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, light_mode="march"))
    if (args.unfused or args.perstep) and cfg.render.engine != "warp":
        ap.error("--unfused and --perstep are flags of the warp engine")
    state, camera, light = loop.setup(cfg)
    lv = loop.cached_light_volumes(state, light, cfg)
    sb = loop.cached_slab_banks(state, lv, cfg)
    for _ in range(2):
        state, _, _ = loop.frame(state, camera, light, cfg, lv, sb)
    dev = state.volumes.device
    bakes = {}
    if cfg.volume.animated:
        # nothing is cached: every frame bakes all three
        lv_f = loop._light_volumes(state, light, cfg)
        bakes = {
            "4-D volume bank bake": lambda: bake_volumes(cfg, dev,
                                                         state.time),
            "light bake": lambda: loop._light_volumes(state, light, cfg),
            "slab bake (both banks)":
                lambda: bake_slab_banks(state.volumes, lv_f, cfg),
        }
        sb = bake_slab_banks(state.volumes, lv_f, cfg)
    render = (_exact_phases if cfg.render.engine == "exact"
              else _warp_phases)(state, camera, light, cfg, sb, fused)
    reps = 10
    p = state.particles
    key = prng.fold_in(state.base_key, state.frame)
    slots = torch.arange(p.age.shape[0], dtype=torch.int32, device=dev)
    phases = {
        "sim_step": lambda: sim_step(state, cfg),
        **bakes,
        "  of which spawn_attrs (threefry draws)":
            lambda: spawn_attrs(key, slots, cfg.emitter,
                                cfg.volume.bank_size),
        "  of which total_force (curl noise)":
            lambda: total_force(p.pos, p.vel, state.time, cfg.forces),
        **render,
    }
    phases = {name: _wall_ms(fn, reps) for name, fn in phases.items()}
    if cfg.volume.animated:
        lv = sb = None      # the traced frames bake their own
    frame_ms = _wall_ms(lambda: loop.frame(state, camera, light, cfg, lv,
                                           sb), reps)

    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = state
        for _ in range(args.frames):
            st, _, _ = loop.frame(st, camera, light, cfg, lv, sb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type)]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    top = sorted(prof.key_averages(), key=lambda a: -getattr(
        a, "self_device_time_total", getattr(a, "self_cuda_time_total", 0)))

    print(f"[profile] {args.preset}{'' if fused else ' unfused'}"
          f"{' per-step lit' if args.perstep else ''} on {card}")
    print(f"[profile] frame (sim + render), timed alone: {frame_ms:.3f} ms")
    for name, ms in phases.items():
        print(f"[profile]   {name}: {ms:.3f} ms")
    print(f"[profile] traced {args.frames} frames: {wall_ms:.3f} ms wall, "
          f"device busy {busy_us / 1e3:.3f} ms "
          f"({100.0 * busy_us / 1e3 / wall_ms:.1f}%), "
          f"{len(dev_events) / args.frames:.0f} device kernels per frame")
    for a in top[:8]:
        t = getattr(a, "self_device_time_total",
                    getattr(a, "self_cuda_time_total", 0))
        if t:
            print(f"[profile]   device {t / 1e3 / args.frames:.3f} ms/frame"
                  f"  x{a.count // args.frames}  {a.key[:70]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
