"""The port's command line (counterpart of ``volq/cli.py``): render
frames from a preset or a JSON config to PNG / npy / GIF, time them, save
and restore checkpoints.  Runs on the CUDA card unless ``--device cpu``.

Examples:
  python -m volq_torch.cli --preset c2 --frames 8 --out out/ --png
  python -m volq_torch.cli --preset c3 --bench
  python -m volq_torch.cli --config my.json --frames 60 --checkpoint ck.npz
  python -m volq_torch.cli --preset c1 --set render.steps=64 --frames 1 --png
  python -m volq_torch.cli --preset c1 --device cpu --frames 2 --png
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _apply_override(cfg, assignment: str):
    """--set a.b.c=json_value on nested frozen dataclasses."""
    path, _, raw = assignment.partition("=")
    try:
        val = json.loads(raw)
    except json.JSONDecodeError:
        val = raw
    keys = path.split(".")

    def rec(obj, ks):
        if len(ks) == 1:
            if isinstance(val, list):
                return dataclasses.replace(obj, **{ks[0]: tuple(val)})
            return dataclasses.replace(obj, **{ks[0]: val})
        return dataclasses.replace(obj, **{ks[0]: rec(getattr(obj, ks[0]),
                                                      ks[1:])})

    return rec(cfg, keys)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="volq_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", choices=["c1", "c2", "c3", "c4", "c5"])
    ap.add_argument("--config", help="JSON config file")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override config fields, e.g. render.steps=16")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                    "the kernels' plain versions)")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--frames-per-launch", type=int, default=1,
                    metavar="N", help="advance N frames per call of "
                    "engine.loop.frames (bit-identical; only every Nth "
                    "frame's image is fetched and saved)")
    ap.add_argument("--warmup", type=int, default=0,
                    help="accepted and ignored, as by volq.cli (the "
                    "frames do not depend on it)")
    ap.add_argument("--out", default="out")
    ap.add_argument("--png", action="store_true", help="save PNG frames")
    ap.add_argument("--npy", action="store_true", help="save npy frames")
    ap.add_argument("--gif", metavar="PATH",
                    help="collect every rendered frame into an animated "
                    "GIF at PATH (downscaled to --gif-width)")
    ap.add_argument("--gif-width", type=int, default=960,
                    help="max GIF width in pixels (default 960)")
    ap.add_argument("--gif-fps", type=float, default=30.0)
    ap.add_argument("--dolly", type=float, default=0.0, metavar="F",
                    help="animate the camera eye toward look_at over the "
                    "run, covering this fraction of the distance "
                    "(fly-through; composes with --orbit)")
    ap.add_argument("--orbit", type=float, default=0.0, metavar="DEG",
                    help="orbit the camera around look_at by this many "
                    "degrees over the run")
    ap.add_argument("--bench", action="store_true",
                    help="time steady-state frames instead of saving")
    ap.add_argument("--checkpoint", help="save final state here (.npz)")
    ap.add_argument("--resume", help="load state from this checkpoint")
    ap.add_argument("--mesh", type=int, default=0,
                    help="shard over this many devices (0 = single; the "
                    "sharded loop is not ported yet)")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the frame loop "
                    "to DIR/trace.json")
    ap.add_argument("--dump-config", action="store_true")
    return ap


def main(argv=None, prepared=None):
    """Run the CLI on ``argv``.  ``prepared`` = (state, camera, light,
    light_volumes, slab_banks) of the selected config lets a caller that
    has already set the scene up hand it to ``--bench`` (nothing is baked
    again); the command line has no counterpart."""
    ap = _parser()
    args = ap.parse_args(argv)

    from volq_torch.scene.config import PRESETS, from_json, to_json

    if args.config:
        with open(args.config) as f:
            cfg = from_json(f.read())
    elif args.preset:
        cfg = PRESETS[args.preset]()
    else:
        ap.error("need --preset or --config")
    for s in args.set:
        cfg = _apply_override(cfg, s)

    if args.dump_config:
        print(to_json(cfg))
        return 0
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded loop is not ported yet (ROADMAP Queue 1 "
            "item 12)")

    from volq_torch.core.device import resolve_device
    from volq_torch.engine import loop, io, checkpoint
    from volq_torch.render import check_supported
    from volq_torch.scene.state import build_camera, build_light

    if args.bench:
        # the shared harness (engine/loop.time_frames): frames batched per
        # call, fenced by CUDA events, median of 3 windows
        fb = max(args.frames_per_launch, 1) if args.frames_per_launch > 1 \
            else 48
        dt, stats = loop.time_frames(cfg, max(args.frames, 12), fb=fb,
                                     mesh=args.mesh, device=args.device,
                                     prepared=prepared)
        rays = cfg.render.width * cfg.render.height
        print(json.dumps({
            "frame_ms": round(dt * 1e3, 3),
            "fps": round(1.0 / dt, 1),
            "mrays_per_s": round(rays / dt / 1e6, 1),
            "frames_per_launch": fb,
            "mesh": args.mesh,
            "stats": {k: int(v) for k, v in stats.items()},
        }))
        return 0

    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    if args.resume:
        # the checkpoint's cfg is authoritative (then re-overridden)
        state, cfg = checkpoint.load_state(args.resume, device)
        for s in args.set:
            cfg = _apply_override(cfg, s)
        check_supported(cfg)
        camera = build_camera(cfg.camera, cfg.render.width,
                              cfg.render.height, device)
        light = build_light(cfg.light, device)
    else:
        state, camera, light = loop.setup(cfg, device)

    fpl = max(args.frames_per_launch, 1)
    if args.gif and fpl > 1:
        # batched launches only return the LAST frame of each call: a
        # fpl > 1 GIF would silently skip fpl - 1 of every fpl frames
        print("note: --gif captures every frame; forcing "
              "--frames-per-launch 1", file=sys.stderr)
        fpl = 1
    lv = loop.cached_light_volumes(state, light, cfg)
    sb = loop.cached_slab_banks(state, lv, cfg)

    def step(st, n):
        if n == 1:
            return loop.frame(st, camera, light, cfg, lv, sb)
        st, image, stats = loop.frames(st, camera, light, cfg, lv, sb, n=n)
        return st, image, {k: v[-1] for k, v in stats.items()}

    profiler = None
    if args.profile:
        from torch.profiler import profile, ProfilerActivity
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        profiler = profile(activities=acts)
        profiler.__enter__()
    # exactly --frames sim frames: the LAST launch shrinks to the
    # remainder when fpl does not divide them
    launches = [fpl] * (args.frames // fpl)
    if args.frames % fpl:
        launches.append(args.frames % fpl)

    cam_path = bool(args.dolly or args.orbit)
    if cam_path:
        import numpy as np

        def camera_at(frac):
            """Camera at path fraction ``frac``: yaw ``--orbit`` degrees
            around look_at, then pull ``--dolly`` of the eye -> look_at
            distance.  With --frames-per-launch > 1 the path steps once
            per launch."""
            cc = cfg.camera
            tgt = np.asarray(cc.look_at, np.float64)
            rel = np.asarray(cc.eye, np.float64) - tgt
            if args.orbit:
                th = np.deg2rad(args.orbit * frac)
                c, s = np.cos(th), np.sin(th)
                rel = np.array([c * rel[0] + s * rel[2], rel[1],
                                -s * rel[0] + c * rel[2]])
            rel = rel * (1.0 - args.dolly * frac)
            c2 = dataclasses.replace(cc, eye=tuple(tgt + rel))
            return build_camera(c2, cfg.render.width, cfg.render.height,
                                device)
    gif_frames = []
    t_start = time.perf_counter()
    for i, n_launch in enumerate(launches):
        if cam_path:
            camera = camera_at(i / max(len(launches) - 1, 1))
        state, image, stats = step(state, n_launch)
        host_image = image.cpu().numpy()
        if args.png or not (args.npy or args.gif):
            io.save_png(os.path.join(args.out, f"frame_{i:04d}.png"),
                        io.tonemap(host_image))
        if args.npy:
            io.save_npy(os.path.join(args.out, f"frame_{i:04d}.npy"),
                        host_image)
        if args.gif:
            gif_frames.append(io.downscale_u8(io.tonemap(host_image),
                                              args.gif_width))
        host = {k: int(v) for k, v in stats.items()}
        print(f"frame {i}: " + " ".join(f"{k}={v}" for k, v in
                                        sorted(host.items())),
              file=sys.stderr)
    dt = time.perf_counter() - t_start
    print(f"{args.frames} frames in {dt:.2f}s "
          f"({args.frames / dt:.1f} fps incl. IO)", file=sys.stderr)
    if args.gif and gif_frames:
        io.save_gif(args.gif, gif_frames, fps=args.gif_fps)
        print(f"GIF ({len(gif_frames)} frames) written to {args.gif}",
              file=sys.stderr)

    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(args.profile, exist_ok=True)
        trace = os.path.join(args.profile, "trace.json")
        profiler.export_chrome_trace(trace)
        print(f"profiler trace written to {trace}", file=sys.stderr)

    if args.checkpoint:
        checkpoint.save_state(args.checkpoint, state, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
