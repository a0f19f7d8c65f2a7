"""Where a frame's time goes, on the card.

    python -m volq_torch.profile [--preset c3] [--frames 4]

Sets the preset up at full size, then prints (with the card's name and
power limit): the wall milliseconds per frame of each phase, timed alone
between device synchronizations -- the sim step, the render's host-side
preparation (geometry, depth sort, kernel inputs), each kernel, the
canvas init and finish -- and, from a torch.profiler trace of whole
frames, the device-busy share of the frame and the number of device
kernels launched per frame.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="c3")
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args(argv)

    from volq_torch.engine import loop
    from volq_torch.render import kernel as K
    from volq_torch.render.warp import fused_inputs, _canvas_finish
    from volq_torch.scene.config import PRESETS
    from volq_torch.sim import prng
    from volq_torch.sim.emit import spawn_attrs
    from volq_torch.sim.forces import total_force
    from volq_torch.sim.step import sim_step

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    cfg = PRESETS[args.preset]()
    H = cfg.render.height
    state, camera, light = loop.setup(cfg)
    sb = loop.cached_slab_banks(state, None, cfg)
    for _ in range(2):
        state, _, _ = loop.frame(state, camera, light, cfg, None, sb)
    dev = state.volumes.device

    march, comp, _ = fused_inputs(state.particles, camera, light, cfg,
                                  sb[0], 0, H)
    P2m, _ = K.warp_march(*march)
    canvas = K.canvas_init(cfg, H, dev)
    reps = 10
    p = state.particles
    key = prng.fold_in(state.base_key, state.frame)
    slots = torch.arange(p.age.shape[0], dtype=torch.int32, device=dev)
    phases = {
        "sim_step": _wall_ms(lambda: sim_step(state, cfg), reps),
        "  of which spawn_attrs (threefry draws)": _wall_ms(
            lambda: spawn_attrs(key, slots, cfg.emitter,
                                cfg.volume.bank_size), reps),
        "  of which total_force (curl noise)": _wall_ms(
            lambda: total_force(p.pos, p.vel, state.time, cfg.forces),
            reps),
        "render host prep (fused_inputs)": _wall_ms(
            lambda: fused_inputs(state.particles, camera, light, cfg, sb[0],
                                 0, H), reps),
        "warp_march kernel": _wall_ms(lambda: K.warp_march(*march), reps),
        "canvas_init": _wall_ms(lambda: K.canvas_init(cfg, H, dev), reps),
        "warp_composite kernel": _wall_ms(
            lambda: K.warp_composite(canvas, P2m, *comp), reps),
        "canvas finish": _wall_ms(
            lambda: _canvas_finish(canvas[:3], canvas[3], cfg, H), reps),
    }
    frame_ms = _wall_ms(lambda: loop.frame(state, camera, light, cfg, None,
                                           sb), reps)

    from torch.profiler import profile, ProfilerActivity
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = state
        for _ in range(args.frames):
            st, _, _ = loop.frame(st, camera, light, cfg, None, sb)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.events()
                  if getattr(e, "device_type", None) is not None
                  and "CUDA" in str(e.device_type)]
    busy_us = sum(e.time_range.elapsed_us() for e in dev_events)
    top = sorted(prof.key_averages(), key=lambda a: -getattr(
        a, "self_device_time_total", getattr(a, "self_cuda_time_total", 0)))

    print(f"[profile] {args.preset} on {card}")
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
