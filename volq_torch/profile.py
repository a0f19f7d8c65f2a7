"""Where a frame's time goes, on the card.

    python -m volq_torch.profile [--preset c1|c2|c3|c4|c5] [--unfused]
                                 [--perstep] [--frames 4]

Sets the preset up at full size (``--unfused``: with warp_fused=False;
``--perstep``: with light_mode="march"; both are the warp engine's), then
prints, with the card's name and power limit:

- the wall milliseconds per frame of the frame, the sim step (the sim's
  three kernel launches), for an animated preset the three bakes every
  frame holds (4-D volume bank, light bank, slab banks), and the render,
  each timed alone between device synchronizations;
- from a torch.profiler trace of ``--frames`` whole frames: the device's
  busy share, the kernels launched per frame, and for each of the
  program's spans (``core/trace``) the device's idle milliseconds a frame
  while it was the innermost open span, and its host syncs a frame: the
  program's ``h2d`` and ``d2h`` counters beside the trace's host-to-card
  and card-to-host memcpy events whose runtime call it holds, and its
  other counters a frame: each kernel launch by its C function's name
  (``_build.launch``), and ``noise_torch`` / ``sim_torch`` /
  ``light_torch`` each call of a plain version;
- the same frames again under torch.cuda's sync-debug mode: its warnings
  against the counters' total.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import tempfile
import time
import warnings
from collections import defaultdict

import torch

from volq_torch.core import trace

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_SYNC_WARNING = "called a synchronizing CUDA operation"


def _wall_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def span_table(path) -> dict:
    """Read a chrome trace of whole frames (``volq.frame`` spans) by the
    program's ``volq.*`` spans.  Over the window from the first frame's
    start to the last one's end: ``window_s``, ``busy_s`` (union of the
    device's kernels, copies and fills), ``kernels`` (device kernels), and
    ``spans`` = {span: {"idle_s", "HtoD", "DtoH"}}: the device's idle gaps
    put down to the innermost span open at each gap's middle, and the
    memcpy events between host and card put down to the innermost span
    open when the host called the copy (by the runtime call's
    correlation id).  Idle gaps outside every span go under None."""
    with open(path) as f:
        ev = json.load(f)["traceEvents"]
    xs = [e for e in ev if e.get("ph") == "X"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
             if e.get("cat") == "user_annotation"
             and e["name"].startswith("volq.")]
    frames = [s for s in spans if s[2] == "volq.frame"]
    if not frames:
        raise ValueError(f"{path}: no volq.frame span")
    w0, w1 = min(a for a, _, _ in frames), max(b for _, b, _ in frames)

    def innermost(t):
        best = None
        for a, b, name in spans:
            if a <= t < b and (best is None or a >= best[0]):
                best = (a, name)
        return best[1] if best else None

    table = defaultdict(lambda: {"idle_s": 0.0, "HtoD": 0, "DtoH": 0})
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in xs
                 if e.get("cat") in _DEVICE_CATS)
    busy, cur = 0.0, w0
    for a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        if a > cur:
            table[innermost(0.5 * (cur + a))]["idle_s"] += (a - cur) * 1e-6
        busy += max(b - max(a, cur), 0.0)
        cur = max(cur, b)
    if cur < w1:
        table[innermost(0.5 * (cur + w1))]["idle_s"] += (w1 - cur) * 1e-6
    called = {e["args"]["correlation"]: e["ts"] for e in xs
              if e.get("cat") == "cuda_runtime"
              and "correlation" in e.get("args", {})}
    for e in xs:
        if e.get("cat") != "gpu_memcpy":
            continue
        kind = next((k for k in ("HtoD", "DtoH") if k in e["name"]), None)
        t = called.get(e.get("args", {}).get("correlation"))
        if kind and t is not None and w0 <= t < w1:
            table[innermost(t)][kind] += 1
    kernels = sum(1 for e in xs if e.get("cat") == "kernel"
                  and w0 <= e["ts"] < w1)
    return dict(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                kernels=kernels, spans=dict(table))


def traced_frames(step, state, n: int):
    """Run ``step(state) -> state`` ``n`` times under torch.profiler (CPU
    and CUDA) with the program's counters reset.  Returns (state,
    ``span_table`` of the trace, the counters, wall ms)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state = step(state)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = trace.counters()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        table = span_table(path)
    return state, table, counts, wall_ms


def sync_warnings(step, state, n: int):
    """Run ``step`` ``n`` times under torch.cuda's sync-debug mode "warn",
    with the profiler on (CPU only) so that the counters count.  Returns
    (state, warnings of a synchronizing operation, the counters' h2d +
    d2h total)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    trace.reset()
    with warnings.catch_warnings(record=True) as got, \
            profile(activities=[ProfilerActivity.CPU]):
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                state = step(state)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    hits = sum(_SYNC_WARNING in str(w.message) for w in got)
    total = sum(v for (_, k), v in trace.counters().items()
                if k in ("h2d", "d2h"))
    return state, hits, total


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
    from volq_torch.render import render_frame
    from volq_torch.render.warp import bake_slab_banks
    from volq_torch.scene.config import PRESETS
    from volq_torch.scene.state import bake_volumes
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
    lv_f, sb_f = lv, sb
    if cfg.volume.animated:
        # nothing is cached: every frame bakes all three
        lv_f = loop._light_volumes(state, light, cfg)
        sb_f = bake_slab_banks(state.volumes, lv_f, cfg)
        bakes = {
            "4-D volume bank bake": lambda: bake_volumes(cfg, dev,
                                                         state.time),
            "light bake": lambda: loop._light_volumes(state, light, cfg),
            "slab bake (both banks)":
                lambda: bake_slab_banks(state.volumes, lv_f, cfg),
        }
        lv = sb = None      # the frames bake their own
    reps = 10
    p = state.particles
    phases = {
        "frame": lambda: loop.frame(state, camera, light, cfg, lv, sb),
        "sim_step": lambda: sim_step(state, cfg),
        **bakes,
        "render_frame (banks baked)":
            lambda: render_frame(p, state.volumes, camera, light, cfg,
                                 light_volumes=lv_f, slab_banks=sb_f),
    }
    phases = {name: _wall_ms(fn, reps) for name, fn in phases.items()}

    def step(st):
        return loop.frame(st, camera, light, cfg, lv, sb)[0]

    state, tab, counts, wall_ms = traced_frames(step, state, args.frames)
    _, hits, total = sync_warnings(step, state, args.frames)

    n = args.frames
    print(f"[profile] {args.preset}{'' if fused else ' unfused'}"
          f"{' per-step lit' if args.perstep else ''} on {card}")
    for name, ms in phases.items():
        print(f"[profile] {name}, timed alone: {ms:.3f} ms")
    print(f"[profile] traced {n} frames: {wall_ms:.3f} ms wall, device busy "
          f"{tab['busy_s'] * 1e3:.3f} of {tab['window_s'] * 1e3:.3f} ms "
          f"({100.0 * tab['busy_s'] / tab['window_s']:.1f}%), "
          f"{tab['kernels'] / n:.0f} device kernels per frame")
    print("[profile] by span, a frame: device idle ms; host syncs h2d / d2h "
          "counted, HtoD / DtoH memcpy events in the trace")
    per = trace.per_frame(counts)
    for s in sorted(set(tab["spans"]) | set(per), key=str):
        t = tab["spans"].get(s, {"idle_s": 0.0, "HtoD": 0, "DtoH": 0})
        c = per.get(s, {})
        other = "".join(f"; {k} {v:g}" for k, v in sorted(c.items())
                        if k not in ("h2d", "d2h"))
        print(f"[profile]   {s or 'outside'}: idle "
              f"{t['idle_s'] * 1e3 / n:.3f}; h2d {c.get('h2d', 0):g} / d2h "
              f"{c.get('d2h', 0):g}; HtoD {t['HtoD'] / n:g} / DtoH "
              f"{t['DtoH'] / n:g}{other}")
    print(f"[profile] sync-debug mode over {n} frames: {hits} warnings, "
          f"{total} host syncs counted")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
